"""The GAT attention's CUDA kernels (csrc/gat_attention.cu) against their
plain versions (ops/gat_attention.py `fwd_plain`, `bwd_plain`), at tiny
shapes and at the `gat_ppi.pool` cell's query shape (16 tasks x 16 bins x
1024 slots, heads of 4 x 256 and 6 x 121), and the launches of one
meta-step. Marked `cuda`: they skip without a card. Imports neither jax nor
the JAX package; run on the card with

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_gat_cuda.py
"""

import pytest
import torch

from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.data.pack import SubgraphSet, TaskBatch
from gmeta_tpu_torch.meta.maml import MetaLearner
from gmeta_tpu_torch.ops import gat_attention
from gmeta_tpu_torch.ops.gat_attention import (Attention, attend, attn_graph,
                                               bwd_plain, fwd_plain)
from gmeta_tpu_torch.scripts.bench_gat import packed_graph

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


SHAPES = {   # (T, B, P, live, in-edges a live node)
    "tiny": (2, 2, 16, 11, 3.0),
    "lonely": (1, 3, 8, 1, 1.0),
    "query": (16, 16, 1024, 586, 10.6),
}
HEADS = [(2, 4), (3, 3), (2, 8), (1, 1), (4, 256), (6, 121)]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("K,F", HEADS)
def test_kernels_are_their_plain_versions(cuda, shape, K, F):
    T, B, P, live, per = SHAPES[shape]
    if shape == "query" and F < 121:
        pytest.skip("the query shape runs at the cell's heads")
    graph = _graph(T, B, P, live, per, cuda)
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


def test_misaligned_rows_take_the_scalar_path(cuda):
    graph = _graph(2, 2, 16, 11, 3.0, cuda)
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
    before = dict(gat_attention.launches)
    out = attend(graph, zst, K, F)
    (dz,) = torch.autograd.grad(out.square().sum(), zst)
    assert gat_attention.launches["fwd"] == before["fwd"] + 1
    assert gat_attention.launches["bwd"] == before["bwd"] + 3
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
    before = dict(gat_attention.launches)
    m = ml.train_step(TaskBatch(one_set(4), one_set(6)))
    torch.cuda.synchronize()
    assert torch.isfinite(m["meta_loss"])
    assert gat_attention.launches["fwd"] - before["fwd"] == 3 * 6
    assert gat_attention.launches["bwd"] - before["bwd"] == 3 * 4 * 3
