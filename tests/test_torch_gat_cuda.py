"""The GAT attention's CUDA kernels (csrc/gat_attention.cu), staged and
walk, against their plain versions (ops/gat_attention.py `fwd_plain`,
`bwd_plain`), at tiny shapes and at the `gat_ppi.pool` cell's query shape
(16 tasks x 16 bins x 1024 slots, heads of 4 x 256 and 6 x 121); the
staged forward against the walk kernel bit for bit, at the cell's
repacked sets and at uneven fills; the walk where segments exceed the
staged kernels' shared memory; and the launches of meta-steps. Marked
`cuda`: they skip without a card. Imports neither jax nor the JAX package;
run on the card with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gat_cuda.py
"""

import numpy as np
import pytest
import torch

from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.data import repack
from gmeta_tpu_torch.data.pack import SubgraphSet, TaskBatch
from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
from gmeta_tpu_torch.meta.maml import MetaLearner, batch_to
from gmeta_tpu_torch.ops import gat_attention
from gmeta_tpu_torch.ops.gat_attention import (Attention, attend, attn_graph,
                                               bwd_plain, fwd_plain)
from gmeta_tpu_torch.scripts.bench_gat import SHAPES as CELL
from gmeta_tpu_torch.scripts.bench_gat import packed_graph, walk
from gmeta_tpu_torch.utils.metrics import counted

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the attention kernels run only on "
                    "the card")
    return torch.device("cuda")


def _graph(T, B, P, live, per_node, device):
    """T tasks' packed edges as the benchmark draws them
    (scripts/bench_gat.py): `live` real slots a bin, each with an in-edge,
    about per_node in-edges a live slot in all."""
    return packed_graph(T, B, P, live, int(B * live * per_node), device)


def _zst(N, K, F, device, seed=1):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(N, K * F + 2 * K, generator=g, device=device)


def _close(got, want, what):
    """Within float32 rounding of sums taken in another order: each row's
    terms (and, in the backward, dot products of F products) add up in the
    kernel's order, not index_add_'s, and the backward's g . z - D cancels;
    so the tolerance is relative to each tensor's scale."""
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5 * scale,
                               msg=what)


def _routed(graph, route):
    """The graph as `route` takes it: with its segments (staged) or
    without them (walk)."""
    graph = graph if route == "staged" else walk(graph)
    assert gat_attention.route(graph) == route
    return graph


def _bits(t):
    """float32 as int32, so that a comparison tells -0.0 from 0.0."""
    return t.contiguous().view(torch.int32)


SHAPES = {   # (T, B, P, live, in-edges a live node)
    "tiny": (2, 2, 16, 11, 3.0),
    "lonely": (1, 3, 8, 1, 1.0),
    "query": (16, 16, 1024, 586, 10.6),
}
HEADS = [(2, 4), (3, 3), (2, 8), (1, 1), (4, 256), (6, 121)]
ROUTES = ["staged", "walk"]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("K,F", HEADS)
def test_kernels_are_their_plain_versions(cuda, shape, K, F, route):
    T, B, P, live, per = SHAPES[shape]
    if shape == "query" and F < 121:
        pytest.skip("the query shape runs at the cell's heads")
    graph = _routed(_graph(T, B, P, live, per, cuda), route)
    N = T * B * P
    zst = _zst(N, K, F, cuda)
    o, lse = gat_attention._launch_fwd(graph, zst, K, F)
    o2, lse2 = gat_attention._launch_fwd(graph, zst, K, F)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)   # no atomics
    want_o, want_lse = fwd_plain(graph, zst, K, F)
    _close(o, want_o, "o")
    _close(lse, want_lse, "lse")
    g = _zst(N, K, F, cuda, seed=2)[:, :K * F].contiguous()
    d = gat_attention._launch_bwd(graph, zst, o, lse, g, K, F)
    d2 = gat_attention._launch_bwd(graph, zst, o, lse, g, K, F)
    assert torch.equal(d, d2)
    want = bwd_plain(graph, zst, want_o, want_lse, g, K, F)
    KF = K * F
    _close(d[:, :KF], want[:, :KF], "dz")
    _close(d[:, KF:KF + K], want[:, KF:KF + K], "ds")
    _close(d[:, KF + K:], want[:, KF + K:], "dt")
    torch.cuda.synchronize()


@pytest.mark.parametrize("route", ROUTES)
def test_misaligned_rows_take_the_scalar_path(cuda, route):
    graph = _routed(_graph(2, 2, 16, 11, 3.0, cuda), route)
    K, F = 2, 8
    N = 64
    buf = torch.empty(N * (K * F + 2 * K) + 1, device=cuda)[1:]
    zst = buf.view(N, K * F + 2 * K)
    zst.copy_(_zst(N, K, F, cuda))
    o, lse = gat_attention._launch_fwd(graph, zst, K, F)
    want_o, want_lse = fwd_plain(graph, zst, K, F)
    _close(o, want_o, "o")
    _close(lse, want_lse, "lse")


def test_the_autograd_function_runs_the_kernels(cuda):
    graph = _graph(2, 2, 16, 11, 3.0, cuda)
    K, F = 2, 4
    zst = _zst(64, K, F, cuda).requires_grad_()
    with counted() as c:
        out = attend(graph, zst, K, F)
        (dz,) = torch.autograd.grad(out.square().sum(), zst)
    assert c.of(gat_attention.LAUNCHES) == {"fwd": 1, "bwd": 3}
    cpu = attn_graph(*_edges_cpu(graph), 4, 16)   # 2 tasks x 2 bins
    zc = zst.detach().cpu().requires_grad_()
    (want,) = torch.autograd.grad(
        Attention.apply(cpu, zc, K, F).square().sum(), zc)
    _close(dz.cpu(), want, "dzst")


def _edges_cpu(graph):
    """The graph's real edges back as (1, E) src, dst and mask on the CPU
    (one task of the whole flat rows)."""
    s = graph.sized
    rows = torch.repeat_interleave((s.row_ptr[1:] - s.row_ptr[:-1]).long())
    nnz = rows.numel()
    src, dst = s.col[:nnz].long().cpu(), rows.cpu()
    return src[None], dst[None], torch.ones(1, nnz)


def test_refuses_what_the_kernels_do_not_take(cuda):
    graph = _graph(1, 2, 8, 4, 2.0, cuda)
    with pytest.raises(TypeError, match="float32"):
        attend(graph, _zst(16, 2, 4, cuda).double(), 2, 4)
    with pytest.raises(ValueError, match="exceed"):
        attend(graph, _zst(16, 1, 2000, cuda), 1, 2000)
    with pytest.raises(ValueError, match="graph on"):
        attend(graph, _zst(16, 2, 4, torch.device("cpu")), 2, 4)


def test_launches_of_one_meta_step(cuda):
    """One meta-step of a small GAT on the card: every attention call and
    backward goes through the kernels, none through the plain version: 3
    layers x 6 forwards (support: the curve's and 2 inner; query: the
    curve's, an inner step's evaluation and the meta-loss's) and x 4
    backwards (2 inner gradients, the meta-gradient through the last
    support pass and the query), 3 kernels a backward."""
    cfg = Config(arch="gat", gat_heads=2, gat_hidden=8, gat_out_heads=3,
                 gat_out_dim=3).validate()
    spec = build_model_config(cfg, 5, 2)
    ml = MetaLearner(spec, 2, update_lr=0.05, meta_lr=0.01, update_step=2,
                     update_step_test=2, agg="sized", device=cuda)
    gen = torch.Generator().manual_seed(0)
    ml.set_features(torch.randn(40, 5, generator=gen).numpy())

    def one_set(S):
        T, B, P, e = 2, 2, 16, 30
        src = torch.randint(0, 11, (T, e), generator=gen)
        dst, _ = torch.sort(torch.randint(0, 11, (T, e), generator=gen), 1)
        return SubgraphSet(
            node_gid=torch.randint(0, 40, (T, B, P), generator=gen).int()
            .numpy(),
            node_mask=(torch.arange(P) < 11).float().expand(T, B, P)
            .numpy().copy(),
            edge_src=src.int().numpy(), edge_dst=dst.int().numpy(),
            edge_mask=torch.ones(T, e).numpy(),
            centers=torch.randint(0, 11, (T, S, 1), generator=gen)
            .expand(T, S, 2).int().numpy().copy(),
            labels=(torch.arange(S) % 2).expand(T, S).int().numpy().copy(),
            bin_fill=torch.full((T, B), 11).int().numpy())
    with counted() as c:
        m = ml.train_step(TaskBatch(one_set(4), one_set(6)))
    torch.cuda.synchronize()
    assert torch.isfinite(m["meta_loss"])
    assert c.of(gat_attention.LAUNCHES) == c.of(gat_attention.STAGED) == \
        {"fwd": 3 * 6, "bwd": 3 * 4 * 3}


def _uneven(device, fills, P=16, per=3, seed=0):
    """A repacked set's AttnGraph as the learner builds it (data/repack.py
    `repack` and `segments`) from T tasks of B bins of P slots, fills
    (T, B) live slots a bin. A bin of two or more live slots gives every
    one an in-edge from the bin and about `per` in-edges a slot in all; a
    bin of one has no edge, so its row has only its self term."""
    fills = np.asarray(fills, np.int32)
    T, B = fills.shape
    rng = np.random.default_rng(seed)
    edges = []
    for t in range(T):
        dst = np.concatenate([b * P + np.concatenate([
            np.arange(f), rng.integers(0, f, (per - 1) * f)])
            for b, f in enumerate(fills[t]) if f > 1] + [[]]).astype(int)
        src = dst // P * P + rng.integers(0, fills[t][dst // P])
        order = np.argsort(dst, kind="stable")
        edges.append((src[order], dst[order]))
    E = max(len(d) for _, d in edges) + 3
    src = np.zeros((T, E), np.int32)
    dst = np.full((T, E), B * P - 1, np.int32)
    mask = np.zeros((T, E), np.float32)
    for t, (s, d) in enumerate(edges):
        src[t, :len(s)], dst[t, :len(d)], mask[t, :len(d)] = s, d, 1
    node_mask = (np.arange(P) < fills[..., None]).astype(np.float32)
    sg = SubgraphSet(np.zeros((T, B, P), np.int32), node_mask, src, dst,
                     mask, np.zeros((T, 1, 2), np.int32),
                     np.zeros((T, 1), np.int32), fills)
    dev = batch_to(TaskBatch(sg, sg), device).spt
    live = repack.live_counts(fills)
    M = repack.bin_rows(live)
    rp = repack.repack(dev, M, live)
    return attn_graph(rp.edge_src, rp.edge_dst, rp.edge_mask, 1, M,
                      repack.segments(dev.bin_fill, M, fills))


# fills of different size, empty bins, one-row bins with only a self term,
# a full bin, and tasks of different live counts (tail padding)
UNEVEN = [[5, 0, 1, 16], [2, 3, 0, 0], [1, 1, 1, 1]]
STAGED_CASES = {
    "qry": lambda d: packed_graph(*CELL["qry"], d, repacked=True),
    "spt": lambda d: packed_graph(*CELL["spt"], d, repacked=True),
    "uneven": lambda d: _uneven(d, UNEVEN),
}


@pytest.mark.parametrize("case", sorted(STAGED_CASES))
@pytest.mark.parametrize("K,F", [(4, 256), (6, 121), (2, 4), (3, 3)])
def test_staged_forward_is_the_walk_bitwise_and_backward_plain(cuda, case,
                                                               K, F):
    """At the cell's repacked sets and at uneven fills: the staged forward
    gives the walk kernel's bits (o and lse), and so does the staged
    backward's dz (each column's terms summed in the walk's order); its ds
    and dt (dots taken slice by slice) hold to the plain version at this
    file's tolerance; two launches give the same bits."""
    if (case == "uneven") != (F < 121):
        pytest.skip("the cell's sets run at the cell's heads, the uneven "
                    "fills at small ones")
    staged = STAGED_CASES[case](cuda)
    assert gat_attention.route(staged) == "staged"
    N = staged.sized.row_ptr.numel() - 1
    zst = _zst(N, K, F, cuda)
    g = _zst(N, K, F, cuda, seed=2)[:, :K * F].contiguous()
    with counted() as c:
        got = [gat_attention._launch_fwd(staged, zst, K, F) for _ in "ab"]
        want = gat_attention._launch_fwd(walk(staged), zst, K, F)
        o, lse = got[0]
        d = [gat_attention._launch_bwd(staged, zst, o, lse, g, K, F)
             for _ in "ab"]
        d_walk = gat_attention._launch_bwd(walk(staged), zst, o, lse, g, K, F)
    assert c.of(gat_attention.STAGED) == {"fwd": 2, "bwd": 6}
    assert c.of(gat_attention.LAUNCHES) == {"fwd": 3, "bwd": 9}
    for x, y, z in zip(*got, want):
        assert torch.equal(_bits(x), _bits(y)) and \
            torch.equal(_bits(x), _bits(z))
    KF = K * F
    assert torch.equal(_bits(d[0]), _bits(d[1]))
    assert torch.equal(_bits(d[0][:, :KF]), _bits(d_walk[:, :KF]))
    plain = bwd_plain(staged, zst, o, lse, g, K, F)
    _close(d[0][:, :KF], plain[:, :KF], "dz")
    _close(d[0][:, KF:KF + K], plain[:, KF:KF + K], "ds")
    _close(d[0][:, KF + K:], plain[:, KF + K:], "dt")
    want_o, want_lse = fwd_plain(staged, zst, K, F)
    _close(o, want_o, "o")
    _close(lse, want_lse, "lse")
    torch.cuda.synchronize()


def test_segments_past_the_budget_take_the_walk(cuda):
    """Bins of more rows than the staged kernels' shared memory holds
    (STAGE_ROWS) run the walk kernels, and the registry says so; the
    results are the plain version's."""
    P = gat_attention.STAGE_ROWS + 8
    graph = _graph(1, 2, P, 600, 4.0, cuda)
    assert graph.seg_rows == P and gat_attention.route(graph) == "walk"
    K, F = 2, 8
    zst = _zst(2 * P, K, F, cuda)
    g = _zst(2 * P, K, F, cuda, seed=2)[:, :K * F].contiguous()
    with counted() as c:
        o, lse = gat_attention._launch_fwd(graph, zst, K, F)
        d = gat_attention._launch_bwd(graph, zst, o, lse, g, K, F)
    assert c.of(gat_attention.LAUNCHES) == {"fwd": 1, "bwd": 3}
    assert c.of(gat_attention.STAGED) == {"fwd": 0, "bwd": 0}
    want_o, want_lse = fwd_plain(graph, zst, K, F)
    _close(o, want_o, "o")
    _close(d, bwd_plain(graph, zst, want_o, want_lse, g, K, F), "dzst")


def test_compact_gat_steps_are_staged_and_add_no_sync(cuda):
    """A compact-pool call of a GAT repacks each step's sets and gives the
    attention their segments without a device-to-host sync: every launch
    is staged."""
    store, ds = synthetic_disjoint(nodes_per_graph=300, feat_dim=8,
                                   num_classes=9, batchsz=12,
                                   sample_nodes=64, seed=3)
    spec = build_model_config(
        Config(arch="gat", gat_heads=2, gat_hidden=8, gat_out_heads=3,
               gat_out_dim=5), store.feat_dim, 3)
    ml = MetaLearner(spec, 3, update_lr=0.05, meta_lr=1e-3, update_step=2,
                     update_step_test=2, seed=5, agg="sized", device=cuda)
    ml.set_features(store.features)
    ml.set_task_pool_compact(ds["train"].stacked_pool())
    idx = np.random.RandomState(2).permutation(12)[:8].reshape(2, 4)
    ml.train_steps_from_compact(idx[:1])     # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with counted() as c:
            m = ml.train_steps_from_compact(idx[1:])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(m["meta_loss"]).all()
    n = c.of(gat_attention.LAUNCHES)
    assert n["fwd"] > 0 and c.of(gat_attention.STAGED) == n
