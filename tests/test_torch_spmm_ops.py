"""The port's segment-sum, ELL and SDDMM ops (gmeta_tpu_torch/ops/spmm.py)
and the rectangular entry point of the gather kernel (ops/sized_spmm.py
`csr_gather`, `CsrAgg`/`CsrAggT`, here through its plain version) against
gmeta_tpu/ops/spmm.py and jax.ops.segment_sum on the same numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmeta_tpu.ops import spmm as jspmm
from gmeta_tpu_torch.ops import sized_spmm as sp
from gmeta_tpu_torch.ops import spmm
from gmeta_tpu_torch.utils.metrics import counted

torch.set_num_threads(2)


def _edges(seed, V=60, E=400, n_pad=12, sort=True):
    """An edge list over V nodes, destinations sorted, with one node of 40
    in-edges, isolated nodes, and pad edges (src 0, dst V-1, mask 0)."""
    rng = np.random.RandomState(seed)
    dst = np.concatenate([rng.randint(0, V - 5, E), np.full(40, 7)])
    src = rng.randint(0, V, dst.size)
    if sort:
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
    src = np.concatenate([src, np.zeros(n_pad, np.int64)]).astype(np.int32)
    dst = np.concatenate([dst, np.full(n_pad, V - 1)]).astype(np.int32)
    mask = np.concatenate([np.ones(src.size - n_pad),
                           np.zeros(n_pad)]).astype(np.float32)
    return src, dst, mask, V


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_in_degrees_and_aggregate_match_jax():
    src, dst, mask, V = _edges(0)
    h = np.random.RandomState(1).randn(V, 5).astype(np.float32)
    ts, td, tm, th = _t(src, dst, mask, h)
    np.testing.assert_array_equal(
        spmm.in_degrees(td, tm, V).numpy(),
        np.asarray(jspmm.in_degrees(jnp.asarray(dst), jnp.asarray(mask), V)))
    np.testing.assert_allclose(
        spmm.aggregate(th, ts, td, tm, V).numpy(),
        np.asarray(jspmm.aggregate(jnp.asarray(h), jnp.asarray(src),
                                   jnp.asarray(dst), jnp.asarray(mask), V)),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("row_cap", [1, 4, 16])
def test_build_ell_bit_equal_and_aggregate_ell_match_jax(row_cap):
    src, dst, mask, V = _edges(2, sort=False)
    live = mask != 0
    got = spmm.build_ell(src[live], dst[live], V, row_cap=row_cap)
    want = jspmm.build_ell(src[live], dst[live], V, row_cap=row_cap)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    h = np.random.RandomState(3).randn(V, 6).astype(np.float32)
    np.testing.assert_allclose(
        spmm.aggregate_ell(torch.from_numpy(h), *_t(*got), V).numpy(),
        np.asarray(jspmm.aggregate_ell(jnp.asarray(h),
                                       *map(jnp.asarray, want), V)),
        rtol=1e-5, atol=1e-5)


def test_sddmm_and_aggregate_weighted_match_jax():
    src, dst, mask, V = _edges(4)
    rng = np.random.RandomState(5)
    h = rng.randn(V, 5).astype(np.float32)
    w = rng.rand(src.size).astype(np.float32)
    g_out = rng.randn(V, 5).astype(np.float32)
    r = rng.randn(V, 5).astype(np.float32)       # cotangent of the output
    np.testing.assert_allclose(
        spmm.sddmm(*_t(g_out, h, src, dst, mask)).numpy(),
        np.asarray(jspmm.sddmm(*map(jnp.asarray, (g_out, h, src, dst,
                                                  mask)))),
        rtol=1e-5, atol=1e-5)

    def jloss(h, w):
        out = jspmm.aggregate_weighted(h, w, jnp.asarray(src),
                                       jnp.asarray(dst), jnp.asarray(mask),
                                       jnp.zeros((V, 5)))
        return (out * r).sum(), out
    (_, jout), (jdh, jdw) = jax.value_and_grad(jloss, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(h), jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    out = spmm.aggregate_weighted(th, tw, *_t(src, dst, mask),
                                  torch.zeros(V, 5))
    dh, dw = torch.autograd.grad((out * torch.from_numpy(r)).sum(), (th, tw))
    for got, want in ((out.detach(), jout), (dh, jdh), (dw, jdw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_aggregate_weighted_double_backward_matches_jax():
    """grad of a function of the input gradient, through the JAX rule's
    own differentiable backward."""
    src, dst, mask, V = _edges(6, V=30, E=120)
    rng = np.random.RandomState(7)
    h = rng.randn(V, 4).astype(np.float32)
    w = rng.rand(src.size).astype(np.float32)

    def jouter(w):
        def inner(h):
            out = jspmm.aggregate_weighted(h, w, jnp.asarray(src),
                                           jnp.asarray(dst),
                                           jnp.asarray(mask),
                                           jnp.zeros((V, 4)))
            return (out ** 2).sum()
        return (jax.grad(inner)(jnp.asarray(h)) ** 2).sum()
    want = jax.grad(jouter)(jnp.asarray(w))
    th, tw = (torch.from_numpy(a).requires_grad_() for a in (h, w))
    out = spmm.aggregate_weighted(th, tw, *_t(src, dst, mask),
                                  torch.zeros(V, 4))
    gh, = torch.autograd.grad((out ** 2).sum(), th, create_graph=True)
    got, = torch.autograd.grad((gh ** 2).sum(), tw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ---- the rectangular entry point ---------------------------------------------

def _rect(seed, n_src=90, n_dst=37, H=6):
    """A CSR pair from a table of n_src rows into n_dst rows (a row of 40
    edges, empty rows) and a table x."""
    rng = np.random.RandomState(seed)
    dst = np.sort(np.concatenate([rng.randint(0, n_dst - 3, 300),
                                  np.full(40, 5)]))
    src = rng.randint(0, n_src, dst.size)
    x = rng.randn(n_src, H).astype(np.float32)
    return src, dst, x, n_src, n_dst


def _segment_sum(x, src, dst, n_dst):
    return jax.ops.segment_sum(x[src], jnp.asarray(dst), num_segments=n_dst,
                               indices_are_sorted=True)


def test_csr_gather_matches_segment_sum():
    src, dst, x, n_src, n_dst = _rect(0)
    pair = sp.csr_pair(src, dst, n_src, n_dst)
    assert pair.row_ptr.shape == (n_dst + 1,)
    assert pair.row_ptr_t.shape == (n_src + 1,)
    with counted() as c:
        got = sp.csr_gather(pair.row_ptr, pair.col, torch.from_numpy(x))
    assert c.of(sp.CSR_LAUNCHES) == {"fwd": 0, "bwd": 0}   # the CPU runs no kernel
    assert got.shape == (n_dst, x.shape[1])
    np.testing.assert_allclose(
        got.numpy(), np.asarray(_segment_sum(jnp.asarray(x), src, dst,
                                             n_dst)), rtol=1e-6, atol=1e-6)
    r = np.random.RandomState(1).randn(n_dst, x.shape[1]).astype(np.float32)
    got_t = sp.csr_gather(pair.row_ptr_t, pair.col_t, torch.from_numpy(r),
                          "bwd")
    want_t = jax.ops.segment_sum(jnp.asarray(r)[dst], jnp.asarray(src),
                                 num_segments=n_src)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5,
                               atol=1e-5)


def test_csr_agg_gradient_and_second_gradient_match_jax():
    src, dst, x, n_src, n_dst = _rect(2)
    pair = sp.csr_pair(src, dst, n_src, n_dst)
    rng = np.random.RandomState(3)
    r = rng.randn(n_dst, x.shape[1]).astype(np.float32)
    v = rng.randn(n_src, x.shape[1]).astype(np.float32)

    def jf(x):
        return (_segment_sum(x, src, dst, n_dst) ** 2 * r).sum()
    jg = jax.grad(jf)(jnp.asarray(x))
    jgg = jax.grad(lambda x: (jax.grad(jf)(x) * v).sum())(jnp.asarray(x))

    tx = torch.from_numpy(x).requires_grad_()
    f = (sp.CsrAgg.apply(pair, tx) ** 2 * torch.from_numpy(r)).sum()
    g, = torch.autograd.grad(f, tx, create_graph=True)
    gg, = torch.autograd.grad((g * torch.from_numpy(v)).sum(), tx)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(jg),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gg.numpy(), np.asarray(jgg), rtol=1e-5,
                               atol=1e-5)
    # and the transpose's own gradient is the forward
    tr = torch.from_numpy(r).requires_grad_()
    gt, = torch.autograd.grad((sp.CsrAggT.apply(pair, tr)
                               * torch.from_numpy(v)).sum(), tr)
    np.testing.assert_allclose(
        gt.numpy(), np.asarray(_segment_sum(jnp.asarray(v), src, dst,
                                            n_dst)), rtol=1e-5, atol=1e-5)


def test_csr_pair_rejects_out_of_range_indices_and_bad_tables():
    with pytest.raises(ValueError, match="src"):
        sp.csr_pair([0, 5], [0, 1], 5, 2)
    with pytest.raises(ValueError, match="dst"):
        sp.csr_pair([0, 1], [0, 2], 5, 2)
    pair = sp.csr_pair([0, 1], [0, 1], 5, 2)
    with pytest.raises(TypeError):
        sp.csr_gather(pair.row_ptr, pair.col, torch.zeros(5, 3).half())
    with pytest.raises(ValueError):
        sp.csr_gather(pair.row_ptr, pair.col, torch.zeros(5, 3, 1))
    with pytest.raises(TypeError):
        sp.csr_gather(pair.row_ptr.long(), pair.col, torch.zeros(5, 3))
