"""Graphormer's CUDA kernels (csrc/spatial_attention.cu) against their
plain versions (ops/spatial_attention.py `fwd_plain`, `bwd_plain`,
`distances_plain`): at the `graphormer_ppi.pool` cell's query and support
sets (16 tasks x 16 or 6 bins of 586 live slots, repacked, 8 heads of
10), at a tiny shape, at segments of 1, 8 and 1,024 rows, on graphs that
fall apart and on a path longer than a byte holds; two launches give the
same bits; and the launches of meta-steps. Marked `cuda`: they skip
without a card. Imports neither jax nor the JAX package; run on the card
with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_graphormer_cuda.py
"""

import numpy as np
import pytest
import torch

from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.data.pack import SubgraphSet, TaskBatch
from gmeta_tpu_torch.data.repack import bin_rows, segments
from gmeta_tpu_torch.meta.maml import MetaLearner
from gmeta_tpu_torch.ops import spatial_attention as sa
from gmeta_tpu_torch.ops.sized_spmm import sized_graph
from gmeta_tpu_torch.scripts.bench_graphormer import (SHAPES, graph_inputs,
                                                      operands, packed_graph)
from gmeta_tpu_torch.utils.metrics import counted

pytestmark = pytest.mark.cuda

CASES = {**SHAPES, "tiny": (2, 2, 32, 20, 60)}
HEADS = [(8, 10), (2, 4)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the attention kernels run only on "
                    "the card")
    return torch.device("cuda")


def _close(got, want, what):
    """Within float32 rounding of sums taken in another order: the kernel
    takes each row's softmax online over tiles of keys in base 2, the
    plain version a dense softmax; the weighted sums add a segment's up to
    1,024 terms in another order, and the backward's g . v - D cancels. So
    the tolerance is relative to each tensor's scale: a pair dropped or
    doubled errs by a percent of it."""
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-4, atol=2e-5 * scale,
                               msg=what)


def _check_against_plain(graph, K, D, device, what):
    qkv, table, g = operands(graph, K, D, device)
    o, lse = sa._launch_fwd(graph, qkv, table, K, D)
    want_o, want_lse = sa.fwd_plain(graph, qkv, table, K, D)
    _close(o, want_o, f"{what} o")
    _close(lse, want_lse, f"{what} lse")
    dqkv, dtable = sa._launch_bwd(graph, qkv, table, o, lse, g, K, D)
    want_dqkv, want_dtable = sa.bwd_plain(graph, qkv, table, want_o,
                                          want_lse, g, K, D)
    H = K * D
    for i, part in enumerate(("dq", "dk", "dv")):
        _close(dqkv[:, i * H:(i + 1) * H], want_dqkv[:, i * H:(i + 1) * H],
               f"{what} {part}")
    _close(dtable, want_dtable, f"{what} dtable")
    return qkv, table, g


@pytest.mark.parametrize("K,D", HEADS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernels_are_their_plain_versions(cuda, case, K, D):
    T, B, P, live, edges = CASES[case]
    graph = packed_graph(T, B, P, live, edges, cuda, repacked=True)
    _check_against_plain(graph, K, D, cuda, f"{case} {K}x{D}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_distances_are_the_plain_bits(cuda, case):
    T, B, P, live, edges = CASES[case]
    for repacked in (False, True):
        _equal_tiles(graph_inputs(T, B, P, live, edges, cuda,
                                  repacked=repacked))


def _equal_tiles(inputs):
    """The SpatialGraph of spatial_graph's arguments `inputs`, each of
    whose segments' n x n bytes equal `distances_plain`'s of the same
    edges."""
    graph = sa.spatial_graph(*inputs)
    src, dst, mask, _, B, P = inputs[:6]
    sized = sized_graph(src, dst, mask, B, P)
    want = sa.distances_plain(sized.row_ptr, sized.col, graph.seg,
                              graph.stride)
    for s, (got, ref) in enumerate(zip(_tiles(graph),
                                       _tiles(graph._replace(phi=want)))):
        assert torch.equal(got, ref), s
    return graph


def _tiles(graph):
    """Each segment's n x n bytes of phi (the rest of a tile is never
    written)."""
    S, st = graph.seg.numel() - 1, graph.stride
    seg = graph.seg.cpu().long().tolist()
    phi = graph.phi.view(S, st, st)
    return [phi[s, :seg[s + 1] - seg[s], :seg[s + 1] - seg[s]]
            for s in range(S)]


def _set(fills, edges_of, M, device):
    """One task's repacked set of segments `fills` (host), the real edges
    `edges_of(a, n)` a segment starting at row a of n rows gives: (edge
    arguments of spatial_graph with its Segments)."""
    src, dst = [], []
    a = 0
    for n in fills:
        for i, j in edges_of(a, n):
            src.append(i)
            dst.append(j)
        a += n
    order = np.argsort(dst, kind="stable")
    src = torch.tensor(np.asarray(src)[order], device=device)[None]
    dst = torch.tensor(np.asarray(dst)[order], device=device)[None]
    mask = torch.ones_like(src, dtype=torch.float32)
    node = (torch.arange(M, device=device) < sum(fills)).float()[None, None]
    fill = np.asarray([fills])
    return (src, dst, mask, node, 1, M,
            segments(torch.tensor(fill, device=device), M, fill))


def _random_edges(rng, per_node):
    def edges(a, n):
        k = max(int(n * per_node), 1 if n > 1 else 0)
        return [(a + int(x), a + int(y)) for x, y in
                zip(rng.integers(0, n, k), rng.integers(0, n, k))]
    return edges


@pytest.mark.parametrize("K,D", HEADS)
def test_segments_of_1_8_and_1024_rows(cuda, K, D):
    fills = [1, 8, 1024]
    M = bin_rows([sum(fills)])
    rng = np.random.default_rng(3)
    graph = _equal_tiles(_set(fills, _random_edges(rng, 2.0), M, cuda))
    assert graph.rows == 1024 and sa.query_tiles(graph.rows) == 16
    _check_against_plain(graph, K, D, cuda, f"1/8/1024 {K}x{D}")


def test_graphs_that_fall_apart_and_long_paths(cuda):
    """Two halves with no edge between them and isolated nodes (no path:
    byte 255), and a path of 300 nodes (distances past 254 take 254)."""
    rng = np.random.default_rng(4)

    def halves(a, n):
        h = n // 2
        e = [(a + int(x), a + int(y)) for x, y in
             zip(rng.integers(0, h - 5, 2 * h), rng.integers(0, h - 5, 2 * h))]
        return e + [(a + h + int(x), a + h + int(y)) for x, y in
                    zip(rng.integers(0, n - h, 2 * h),
                        rng.integers(0, n - h, 2 * h))]

    def path(a, n):
        return [(a + i + 1, a + i) for i in range(n - 1)]
    for edges, fills in ((halves, [586, 300]), (path, [300, 40])):
        M = bin_rows([sum(fills)])
        graph = _equal_tiles(_set(fills, edges, M, cuda))
        tile = graph.phi.view(-1, graph.stride, graph.stride)[0]
        if edges is path:
            assert int(tile[0, 299]) == 254 and int(tile[0, 254]) == 254
            assert int(tile[0, 253]) == 253 and int(tile[10, 5]) == 5
        else:
            assert int(tile[0, 400]) == sa.NO_PATH
        _check_against_plain(graph, 8, 10, cuda, f"{edges.__name__}")


def test_two_launches_give_the_same_bits(cuda):
    T, B, P, live, edges = SHAPES["spt"]
    inputs = graph_inputs(T, B, P, live, edges, cuda, repacked=True)
    graph, again = (sa.spatial_graph(*inputs) for _ in range(2))
    assert all(torch.equal(a, b)
               for a, b in zip(_tiles(graph), _tiles(again)))
    qkv, table, g = operands(graph, 8, 10, cuda)
    fwd = [sa._launch_fwd(graph, qkv, table, 8, 10) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*fwd))
    o, lse = fwd[0]
    bwd = [sa._launch_bwd(graph, qkv, table, o, lse, g, 8, 10)
           for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*bwd))


def test_the_autograd_function_runs_the_kernels(cuda):
    T, B, P, live, edges = CASES["tiny"]
    graph = packed_graph(T, B, P, live, edges, cuda, repacked=True)
    qkv, table, g = operands(graph, 2, 4, cuda)
    with counted() as c:
        x = qkv.clone().requires_grad_()
        tb = table.clone().requires_grad_()
        o = sa.attend(graph, x, tb, 2, 4)
        dx, dtb = torch.autograd.grad(o, (x, tb), g)
        torch.cuda.synchronize()
    assert c.of(sa.LAUNCHES) == {"fwd": 1, "bwd": 4, "spd": 0}
    want = sa._launch_bwd(graph, qkv, table, *sa._launch_fwd(
        graph, qkv, table, 2, 4), g, 2, 4)
    assert torch.equal(dx, want[0]) and torch.equal(dtb, want[1])
    with counted() as c:
        packed_graph(T, B, P, live, edges, cuda, repacked=True)
    assert c.of(sa.LAUNCHES) == {"fwd": 0, "bwd": 0, "spd": 1}
    assert c[sa.PAIRS] == T * B * live * live


def test_refuses_what_the_kernels_do_not_take(cuda):
    T, B, P, live, edges = CASES["tiny"]
    graph = packed_graph(T, B, P, live, edges, cuda, repacked=True)
    qkv, table, _ = operands(graph, 2, 6, cuda)
    with pytest.raises(ValueError, match="built for"):
        sa.attend(graph, qkv, table, 2, 6)
    qkv, table, _ = operands(graph, 2, 4, cuda)
    with pytest.raises(TypeError, match="float32"):
        sa.attend(graph, qkv.double(), table.double(), 2, 4)
    with pytest.raises(ValueError, match="table"):
        sa.attend(graph, qkv, table[:1], 2, 4)


def _tiny_batch(rng, T, B, P, fill, E, S, rows=60):
    sets = []
    for _ in range(2):
        node_gid = rng.integers(0, rows, (T, B, P)).astype(np.int32)
        node_mask = (np.arange(P) < fill).astype(np.float32)
        node_mask = np.broadcast_to(node_mask, (T, B, P)).copy()
        node_gid *= node_mask.astype(np.int32)
        src = np.zeros((T, E), np.int32)
        dst = np.full((T, E), B * P - 1, np.int32)
        for t in range(T):
            b = rng.integers(0, B, E)
            d = b * P + rng.integers(0, fill, E)
            s = b * P + rng.integers(0, fill, E)
            order = np.argsort(d, kind="stable")
            src[t], dst[t] = s[order], d[order]
        centers = (np.arange(S) % B * P)[None, :, None].repeat(T, 0).repeat(
            2, 2).astype(np.int32)
        labels = np.tile(np.arange(S) % 2, (T, 1)).astype(np.int32)
        sets.append(SubgraphSet(node_gid, node_mask, src, dst,
                                np.ones((T, E), np.float32), centers,
                                labels, np.full((T, B), fill, np.int32)))
    return TaskBatch(*sets)


def test_launches_of_one_meta_step(cuda):
    """A Graphormer meta-step on the card: every attention call on the
    kernels, each of L layers running 2U + 2 forwards and U + 2 backwards
    of four kernels, the distances once a set; the same loss on the CPU's
    plain versions."""
    cfg = Config(arch="graphormer", graphormer_layers=2,
                 graphormer_hidden=16, graphormer_heads=2, graphormer_ffn=8,
                 update_step=2, agg="sized").validate()
    spec = build_model_config(cfg, 6, 2)
    rng = np.random.default_rng(0)
    batch = _tiny_batch(rng, 3, 4, 32, 20, 200, 6)
    feats = rng.standard_normal((60, 6)).astype(np.float32)
    losses = {}
    for device in ("cpu", cuda):
        ml = MetaLearner(spec, 2, update_lr=0.05, meta_lr=0.01,
                         update_step=2, update_step_test=2, seed=1,
                         agg="sized", device=device)
        ml.set_features(feats)
        with counted() as c:
            losses[str(device)] = float(ml.train_step(batch)["meta_loss"])
    U, L = cfg.update_step, cfg.graphormer_layers
    assert c.of(sa.LAUNCHES) == {"fwd": L * (2 * U + 2),
                                 "bwd": 4 * L * (U + 2), "spd": 2}
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-5)
