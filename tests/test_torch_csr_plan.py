"""The plan of the full-graph gather (gmeta_tpu_torch/ops/sized_spmm.py):
the slab width `slab_width`, the heavy-row split `row_split` carried in a
`CsrPair`, and the combine kernel's plain version, each held against a
numpy oracle; and the split's partial sums, combined, against
jax.ops.segment_sum on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmeta_tpu_torch.data.graph import CSRGraph
from gmeta_tpu_torch.ops import sized_spmm as sp
from gmeta_tpu_torch.parallel.edgepart import (build_overlap_plan,
                                               pad_features, shard_graph)
from gmeta_tpu_torch.parallel.edgepart_train import overlap_shard
from gmeta_tpu_torch.utils.metrics import counted

torch.set_num_threads(2)

MB = 1 << 20


def _slab_oracle(rows, H, itemsize, l2):
    """The widest slab of 32 bytes x 2^k (at most H) within half the L2;
    all of H when the whole table fits."""
    if rows * H * itemsize <= l2 // 2:
        return H
    widths = [max(1, 32 // itemsize) << k for k in range(20)]
    fits = [S for S in widths if S < H and rows * S * itemsize <= l2 // 2]
    return min(max(fits, default=widths[0]), H)


@pytest.mark.parametrize("rows, H, itemsize, l2, want", [
    (170_112, 256, 4, 50 * MB, 32),     # the full graph, float32: 21.8 MB
    (170_112, 128, 4, 50 * MB, 32),
    (170_112, 256, 2, 50 * MB, 64),     # bf16: the same bytes per slab
    (170_112, 256, 4, 100 * MB, 64),
    (170_112, 256, 4, 1 * MB, 8),       # one 32-byte sector at the least
    (20_000, 256, 4, 50 * MB, 256),     # 20.5 MB: the whole table fits
    (1_000_000, 5, 4, 50 * MB, 5),      # H = 5, 20 MB: fits
    (10_000_000, 5, 4, 50 * MB, 5),     # too wide a sector: all of H
    (10_000_000, 50, 4, 50 * MB, 8),
])
def test_slab_width_matches_oracle(rows, H, itemsize, l2, want):
    got = sp.slab_width(rows, H, itemsize, l2)
    assert got == want == _slab_oracle(rows, H, itemsize, l2)
    if got < H:
        assert rows * got * itemsize <= l2 // 2 or got == 32 // itemsize


def _row_ptr(counts):
    return torch.from_numpy(np.concatenate([[0], np.cumsum(counts)])
                            .astype(np.int32))


def _check_plan(counts, chunk):
    """Every edge of every row of more than `chunk` edges in exactly one
    chunk, chunks in edge order and of at most `chunk` edges, no other
    row split: against the row lengths alone."""
    counts = np.asarray(counts, np.int64)
    row_ptr = _row_ptr(counts)
    plan = sp.row_split(row_ptr, chunk)
    assert plan.chunk == chunk
    for t in plan[:4]:
        assert t.dtype == torch.int32
    heavy = np.flatnonzero(counts > chunk)
    np.testing.assert_array_equal(plan.rows.numpy(), heavy)
    cp = plan.chunk_ptr.numpy()
    assert cp[0] == 0 and cp[-1] == plan.chunk_row.numel()
    rp = row_ptr.numpy().astype(np.int64)
    for i, r in enumerate(heavy):
        rows = plan.chunk_row.numpy()[cp[i]:cp[i + 1]]
        starts = plan.chunk_start.numpy()[cp[i]:cp[i + 1]].astype(np.int64)
        assert (rows == r).all()
        ends = np.minimum(starts + chunk, rp[r + 1])
        assert starts[0] == rp[r] and ends[-1] == rp[r + 1]
        np.testing.assert_array_equal(starts[1:], ends[:-1])  # in order
        assert ((ends - starts) >= 1).all()
        assert ((ends - starts) <= chunk).all()
        assert len(starts) == -(-counts[r] // chunk)
    covered = np.zeros(rp[-1], np.int64)       # each edge exactly once
    for r in np.flatnonzero(counts <= chunk):
        covered[rp[r]:rp[r + 1]] += 1
    for s, r in zip(plan.chunk_start.numpy(), plan.chunk_row.numpy()):
        covered[s:min(s + chunk, rp[r + 1])] += 1
    assert (covered == 1).all()
    return plan


@pytest.mark.parametrize("chunk", [1, 3, 256, 1024])
def test_row_split_covers_each_edge_once_in_order(chunk):
    rng = np.random.RandomState(chunk)
    counts = rng.randint(0, 40, 500)
    counts[::7] = 0                       # empty rows
    counts[[3, 99, 250]] = [chunk, chunk + 1, 3 * chunk + 2]
    _check_plan(counts, chunk)


def test_row_split_of_a_93k_edge_row_and_of_no_heavy_row():
    plan = _check_plan([0, 93_257, 28, 0, 1_001, 256], 256)
    assert plan.rows.tolist() == [1, 4]
    assert plan.chunk_ptr.tolist() == [0, 365, 369]
    empty = _check_plan([28] * 50 + [0, 256], 256)
    assert empty.rows.numel() == empty.chunk_row.numel() == 0
    assert empty.chunk_ptr.tolist() == [0]
    assert sp.row_split(_row_ptr([]), 4).chunk_ptr.tolist() == [0]
    with pytest.raises(ValueError):
        sp.row_split(_row_ptr([3]), 0)


def _hub_edges(seed, n_src=300, n_dst=120, hub=5_000):
    """Edges into n_dst rows from a table of n_src rows: one row of `hub`
    edges, one of 257, empty rows, the rest about 28."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(20, 36, n_dst)
    counts[::9] = 0
    counts[[4, 50]] = [hub, 257]
    dst = np.repeat(np.arange(n_dst), counts)
    perm = rng.permutation(dst.size)      # any edge order
    dst = dst[perm]
    src = rng.randint(0, n_src, dst.size)
    return src, dst, n_src, n_dst


def test_csr_pair_carries_both_plans_through_to():
    src, dst, n_src, n_dst = _hub_edges(0)
    pair = sp.csr_pair(src, dst, n_src, n_dst)
    for split, row_ptr in ((pair.split, pair.row_ptr),
                           (pair.split_t, pair.row_ptr_t)):
        want = sp.row_split(row_ptr, sp.CHUNK)
        for a, b in zip(split[:4], want[:4]):
            assert torch.equal(a, b)
        assert split.chunk == sp.CHUNK
    assert pair.split.rows.tolist() == [4, 50]
    for device in ("cpu", "meta"):
        moved = pair.to(device)
        assert isinstance(moved, sp.CsrPair)
        assert isinstance(moved.split, sp.RowSplit)
        for part in (moved[:4], moved.split[:4], moved.split_t[:4]):
            for t in part:
                assert t.device.type == device and t.dtype == torch.int32
        assert moved.split.chunk == moved.split_t.chunk == sp.CHUNK
        assert moved.split.chunk_row.shape == pair.split.chunk_row.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [1, 5, 6, 50])
@pytest.mark.parametrize("chunk", [7, sp.CHUNK, 256])
def test_split_partials_combined_match_segment_sum(chunk, H, dtype):
    """The split schedule on the host: each chunk's float32 partial sum
    over its edges, then `csr_combine` (its plain version on the CPU)
    writes the split rows of a float32 or bf16 out; every other row as
    `csr_plain` sums it. The result equals jax.ops.segment_sum of the same
    edges (bf16: within the one rounding of each row)."""
    src, dst, n_src, n_dst = _hub_edges(1)
    pair = sp.csr_pair(src, dst, n_src, n_dst)
    x = np.random.RandomState(2).randn(n_src, H).astype(np.float32)
    col, plan = pair.col.numpy(), sp.row_split(pair.row_ptr, chunk)
    rp = pair.row_ptr.numpy()
    partial = torch.from_numpy(np.stack([
        x[col[s:min(s + chunk, rp[r + 1])]].sum(0) for s, r in
        zip(plan.chunk_start.numpy(), plan.chunk_row.numpy())]))
    out = sp.csr_plain(pair.row_ptr, pair.col, torch.from_numpy(x)).to(dtype)
    out[plan.rows.long()] = 0.0
    with counted() as c:
        got = sp.csr_combine(plan, partial, out)
    assert got is out and c.of(sp.COMBINE_LAUNCHES) == {"fwd": 0, "bwd": 0}
    want = jax.ops.segment_sum(jnp.asarray(x)[src], jnp.asarray(dst),
                               num_segments=n_dst)
    want = np.asarray(want)
    if (H, dtype) == (6, torch.float32):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    # two float32 sums of a row's n terms in two orders part by at most
    # 2 (n - 1) 2^-24 sum |x|; bf16 rounds the row once more (2^-9 of it)
    n = np.bincount(dst, minlength=n_dst)[:, None]
    size = np.asarray(jax.ops.segment_sum(jnp.abs(jnp.asarray(x)[src]),
                                          jnp.asarray(dst),
                                          num_segments=n_dst))
    bound = 2 * np.maximum(n - 1, 0) * 2.0**-24 * size
    if dtype == torch.bfloat16:
        bound = bound + 2.0**-8 * np.abs(want)
    assert (np.abs(got.float().numpy() - want) <= bound).all()
    # each split row's float32 sum, rounded once to out's dtype
    rows = plan.rows.long()
    sums = sp.combine_plain(plan, partial, torch.zeros(n_dst, H))
    assert torch.equal(got[rows], sums[rows].to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [1, 5, 50, 128, 256])
def test_combine_plain_adds_in_chunk_order(H, dtype):
    """`combine_plain`, the function the combine kernel must equal bit for
    bit: each split row's partial sums added from 0.0 in chunk order in
    float32 (normal partials of mixed scales, where another order gives
    other bits), rounded once to out's dtype; every other row of out
    left as it was. Rows of 1, 2, 3, 17 and 800 chunks."""
    rng = np.random.RandomState(H)
    per = np.array([2, 3, 17, 800, 1, 3])
    rows = np.array([1, 4, 5, 9, 12, 13])
    chunk_ptr = np.concatenate([[0], np.cumsum(per)])
    chunk_row = np.repeat(rows, per)
    plan = sp.RowSplit(*(torch.from_numpy(a.astype(np.int32)) for a in (
        rows, chunk_ptr, chunk_row, np.zeros_like(chunk_row))), 128)
    partial = (rng.randn(per.sum(), H)
               * np.exp(3 * rng.randn(per.sum(), 1))).astype(np.float32)
    out = torch.full((15, H), 7.0, dtype=dtype)
    got = sp.combine_plain(plan, torch.from_numpy(partial), out.clone())
    want = out.clone()
    for i, r in enumerate(rows):
        acc = np.zeros(H, np.float32)
        for c in range(chunk_ptr[i], chunk_ptr[i + 1]):
            acc = acc + partial[c]                 # float32, chunk order
        want[r] = torch.from_numpy(acc).to(dtype)
    assert torch.equal(got, want)
    reordered = np.zeros(H, np.float32)            # the 800-chunk row
    for c in reversed(range(chunk_ptr[3], chunk_ptr[4])):
        reordered = reordered + partial[c]
    assert not np.array_equal(reordered, got[9].float().numpy()) or \
        dtype == torch.bfloat16


def test_overlap_shard_pairs_carry_plans_of_their_rows():
    """The edge engine's shards keep their CSR pairs' plans (built once on
    the host, with `csr_pair`'s threshold), for a graph with a hub."""
    rng = np.random.RandomState(3)
    V = 700
    dst = np.concatenate([rng.randint(0, V, 6_000), np.full(900, 11)])
    src = rng.randint(0, V, dst.size)
    g = CSRGraph.from_edges(src, dst, V)
    feats = rng.randn(V, 4).astype(np.float32)
    for D in (1, 3):
        sg = shard_graph(g, D)
        plan = build_overlap_plan(sg, D)
        h0 = pad_features(feats, sg, D)
        heavy = 0
        for d in range(D):
            sh = overlap_shard(sg, plan, h0, d, D, "cpu")
            for pair in (sh.local, sh.remote):
                for split, row_ptr in ((pair.split, pair.row_ptr),
                                       (pair.split_t, pair.row_ptr_t)):
                    want = sp.row_split(row_ptr)
                    assert split.chunk == sp.CHUNK
                    for a, b in zip(split[:4], want[:4]):
                        assert torch.equal(a, b)
                    heavy += split.rows.numel()
        assert heavy >= 1             # the hub's row is split somewhere
