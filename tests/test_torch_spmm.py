"""The port's aggregation ops against the JAX package's: densify and the
dense path; the size-aware path's CSRs (`sized_graph`) against `densify`;
and the plain version of the size-aware kernel against the Pallas kernels
run in interpret mode (as tests/test_pallas.py runs them) and against
`sized_reference`. The CUDA kernel itself is checked against this plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmeta_tpu.ops.pallas_spmm import (aggregate_sized as jax_sized,
                                       aggregate_sized_t as jax_sized_t,
                                       sized_reference)
from gmeta_tpu.ops import spmm as jspmm
from gmeta_tpu_torch.ops import sized_spmm
from gmeta_tpu_torch.ops.sized_spmm import (aggregate_sized,
                                            aggregate_sized_t, sized_graph,
                                            sized_plain)
from gmeta_tpu_torch.ops.spmm import (aggregate_dense, degrees_from_dense,
                                      densify)
from gmeta_tpu_torch.utils.metrics import counted

torch.set_num_threads(2)

P = 256
SIZES = [0, 1, 127, 129, 256]


def _packed_edges(sizes, P, density=0.05, seed=0, n_pad=10):
    """Packed edge lists for one task set per row of `sizes` (T, S): edges
    inside each bin's live n x n corner, dst nondecreasing, about one in
    five duplicated, then pad edges (src 0, dst S*P-1, mask 0). Returns
    (T, E) src, dst, mask with one E for all tasks."""
    rng = np.random.RandomState(seed)
    S = len(sizes[0])
    sets = []
    for row in sizes:
        src, dst = [], []
        for b, n in enumerate(row):
            d, s = np.nonzero(rng.rand(n, n) < density)
            reps = 1 + (rng.rand(d.size) < 0.2)
            dst.append(b * P + np.repeat(d, reps))
            src.append(b * P + np.repeat(s, reps))
        sets.append((np.concatenate(src), np.concatenate(dst)))
    T, E = len(sets), max(s.size for s, _ in sets) + n_pad
    src = np.zeros((T, E), np.int32)
    dst = np.full((T, E), S * P - 1, np.int32)
    mask = np.zeros((T, E), np.float32)
    for t, (s, d) in enumerate(sets):
        src[t, :s.size], dst[t, :d.size], mask[t, :s.size] = s, d, 1.0
    return src, dst, mask


def _edges(seed=0, B=3, P=16, E=64):
    """Packed edge lists with duplicates and pad edges (src 0, dst B*P-1,
    mask 0), over two tasks; bin 0 holds no edge, so the pad edges' source
    row is a row no real edge names."""
    rng = np.random.RandomState(seed)
    src, dst, mask = [], [], []
    for _ in range(2):
        e = E - 10
        b = rng.randint(1, B, e)
        s = b * P + rng.randint(0, P, e)
        d = b * P + rng.randint(0, P, e)
        s[:5], d[:5] = s[5:10], d[5:10]           # duplicates
        order = np.argsort(d, kind="stable")
        src.append(np.concatenate([s[order], np.zeros(10, np.int64)]))
        dst.append(np.concatenate([d[order], np.full(10, B * P - 1)]))
        mask.append(np.concatenate([np.ones(e), np.zeros(10)]))
    return (np.asarray(src, np.int32), np.asarray(dst, np.int32),
            np.asarray(mask, np.float32), B, P)


def _graph(src, dst, mask, B, P_):
    return sized_graph(torch.from_numpy(src), torch.from_numpy(dst),
                       torch.from_numpy(mask), B, P_)


def _csr_to_blocks(row_ptr, col, T, B, P_):
    """(T, B, P, P) counts of a CSR over T*B*P rows; every entry must lie
    in its row's bin."""
    row_ptr, col = row_ptr.numpy(), col.numpy()
    nnz = row_ptr[-1]
    rows = np.repeat(np.arange(T * B * P_), np.diff(row_ptr))
    cols = col[:nnz]
    assert (rows // P_ == cols // P_).all()
    A = np.zeros((T * B, P_, P_), np.float32)
    np.add.at(A, (rows // P_, rows % P_, cols % P_), 1.0)
    return A.reshape(T, B, P_, P_)


def test_densify_degrees_dense_match_jax():
    src, dst, mask, B, P_ = _edges()
    A_t = densify(torch.from_numpy(src), torch.from_numpy(dst),
                  torch.from_numpy(mask), B, P_)
    assert A_t.shape == (2, B, P_, P_)
    h = np.random.RandomState(1).randn(B, P_, 5).astype(np.float32)
    for t in range(2):
        A_j = jspmm.densify(jnp.asarray(src[t]), jnp.asarray(dst[t]),
                            jnp.asarray(mask[t]), B, P_)
        np.testing.assert_array_equal(A_t[t].numpy(), np.asarray(A_j))
        assert A_t[t].max() >= 2.0                 # duplicates accumulated
        np.testing.assert_array_equal(
            degrees_from_dense(A_t[t]).numpy(),
            np.asarray(jspmm.degrees_from_dense(A_j)))
        np.testing.assert_allclose(
            aggregate_dense(A_t[t], torch.from_numpy(h)).numpy(),
            np.asarray(jspmm.aggregate_dense(A_j, jnp.asarray(h))),
            rtol=1e-5, atol=1e-5)


def _pad_case(pads, T=3, S=3, P=16, seed=0):
    """(T, E) packed edge lists: real edges inside each bin's live corner,
    dst nondecreasing, a quarter of them duplicated, and masked edges laid
    out as `pads` says: "tail" (the packer's: src 0, dst S*P-1, after the
    real edges), "compact" (as the compact pool decodes them: src
    (S-1)*P), "anywhere" (interleaved at random positions, endpoints
    random over all S*P slots, bins crossed), or "more_than_cells" (the
    packer's pads, E above S*P*P)."""
    rng = np.random.RandomState(seed)
    if pads == "more_than_cells":
        S, P = 2, 3
    rows = []
    for _ in range(T):
        b = rng.randint(0, S, 40)
        n = rng.randint(1, P + 1, S)
        d = b * P + (rng.rand(40) * n[b]).astype(np.int64)
        s = b * P + (rng.rand(40) * n[b]).astype(np.int64)
        dup = rng.rand(40) < 0.25
        d, s = np.concatenate([d, d[dup]]), np.concatenate([s, s[dup]])
        order = np.argsort(d, kind="stable")
        rows.append((s[order], d[order]))
    E = max(len(s) for s, _ in rows) + 30
    src = np.zeros((T, E), np.int64)
    dst = np.full((T, E), S * P - 1, np.int64)
    mask = np.zeros((T, E), np.float32)
    for t, (s, d) in enumerate(rows):
        src[t, :len(s)], dst[t, :len(d)], mask[t, :len(s)] = s, d, 1.0
        if pads == "compact":
            src[t, len(s):] = (S - 1) * P
        elif pads == "anywhere":
            perm = rng.permutation(E)
            src[t], dst[t], mask[t] = src[t, perm], dst[t, perm], mask[t, perm]
            dead = mask[t] == 0
            src[t, dead] = rng.randint(0, S * P, dead.sum())
            dst[t, dead] = rng.randint(0, S * P, dead.sum())
    if pads == "more_than_cells":
        assert E > S * P * P
    return src.astype(np.int32), dst.astype(np.int32), mask, S, P


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pads", ["tail", "compact", "anywhere",
                                  "more_than_cells"])
def test_densify_bitwise_equals_jax(pads, dtype):
    """`densify` over a task axis, each masked edge adding its 0 into a
    cell of its own, equals JAX's `densify` of each task bit for bit:
    duplicates counted, masked edges wherever they lie adding nothing."""
    src, dst, mask, S, P_ = _pad_case(pads)
    A = densify(torch.from_numpy(src), torch.from_numpy(dst),
                torch.from_numpy(mask), S, P_, dtype=getattr(torch, dtype))
    assert A.shape == (3, S, P_, P_) and A.dtype == getattr(torch, dtype)
    assert (mask == 0).any() and float(A.float().max()) >= 2.0
    bits = {"float32": (torch.int32, np.int32),
            "bfloat16": (torch.int16, np.int16)}[dtype]
    for t in range(3):
        A_j = np.asarray(jspmm.densify(
            jnp.asarray(src[t]), jnp.asarray(dst[t]), jnp.asarray(mask[t]),
            S, P_, dtype=getattr(jnp, dtype)))
        np.testing.assert_array_equal(A[t].view(bits[0]).numpy(),
                                      A_j.view(bits[1]))
        assert float(A[t].float().sum()) == float(mask[t].sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sized_graph_equals_jax_densify(seed):
    """Both CSRs summed back into blocks are JAX's densify exactly, and
    their in-degrees are degrees_from_dense (duplicates counted twice, pad
    edges and an empty bin left out), over two tasks."""
    src, dst, mask, B, P_ = _edges(seed)
    g = _graph(src, dst, mask, B, P_)
    N = 2 * B * P_
    assert g.row_ptr.dtype == g.col.dtype == torch.int32
    assert g.row_ptr.shape == g.row_ptr_t.shape == (N + 1,)
    assert int(g.row_ptr[-1]) == int(g.row_ptr_t[-1]) == int(mask.sum())
    fwd = _csr_to_blocks(g.row_ptr, g.col, 2, B, P_)
    bwd = _csr_to_blocks(g.row_ptr_t, g.col_t, 2, B, P_)
    deg = g.degrees().numpy().reshape(2, B, P_)
    for t in range(2):
        A_j = np.asarray(jspmm.densify(jnp.asarray(src[t]),
                                       jnp.asarray(dst[t]),
                                       jnp.asarray(mask[t]), B, P_))
        assert A_j.max() >= 2.0 and not A_j[0].any()
        np.testing.assert_array_equal(fwd[t], A_j)
        np.testing.assert_array_equal(bwd[t], np.swapaxes(A_j, 1, 2))
        np.testing.assert_array_equal(
            deg[t], np.asarray(jspmm.degrees_from_dense(jnp.asarray(A_j))))


def test_sized_graph_leaves_out_masked_edges_and_keeps_nan_out():
    """Pad edges name row 0 (a dead row here): a NaN there must not reach
    the output, as it would if they were weighted by 0. A masked edge in
    the middle of the list adds nothing either."""
    src, dst, mask, B, P_ = _edges(3)
    mask[1, 7] = 0.0
    g = _graph(src, dst, mask, B, P_)
    A = densify(torch.from_numpy(src), torch.from_numpy(dst),
                torch.from_numpy(mask), B, P_).reshape(2 * B, P_, P_)
    x = torch.from_numpy(np.random.RandomState(4).randn(2 * B, P_, 6)
                         .astype(np.float32))
    x[0, 0] = x[B, 0] = float("nan")               # row 0 of each task
    for direction, At in (("fwd", A), ("bwd", A.transpose(1, 2))):
        got = sized_spmm.launch(direction, g, x)
        assert torch.isfinite(got).all()
        want = torch.bmm(At, torch.nan_to_num(x))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# f32: both sides accumulate in float32 in different orders -> 1e-5.
# bf16: both round the float32 sum to bf16 (8 bits of mantissa), so results
# may differ by one bf16 ulp of the output: 2^-7 relative.
TOLS = {"float32": (1e-5, 1e-5), "bfloat16": (8e-3, 8e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
@pytest.mark.parametrize("H", [1, 5, 50, 128])
def test_plain_sized_matches_pallas_interpret(H, direction, dtype):
    src, dst, mask = _packed_edges([SIZES], P, seed=H)
    S = len(SIZES)
    A = np.asarray(jspmm.densify(jnp.asarray(src[0]), jnp.asarray(dst[0]),
                                 jnp.asarray(mask[0]), S, P))
    h = np.random.RandomState(H).randn(S, P, H).astype(np.float32)
    sizes = np.asarray(SIZES, np.int32)
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    row_ptr, col = _graph(src, dst, mask, S, P).csr(direction)
    got = sized_plain(row_ptr, col, torch.from_numpy(h).to(tdt))
    assert got.dtype == tdt
    kern = jax_sized if direction == "fwd" else jax_sized_t
    want = kern(jnp.asarray(A, jdt), jnp.asarray(h, jdt),
                jnp.asarray(sizes), interpret=True)
    rtol, atol = TOLS[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)
    if dtype == "float32":
        At = A if direction == "fwd" else np.swapaxes(A, 1, 2).copy()
        ref = sized_reference(jnp.asarray(At), jnp.asarray(h),
                              jnp.asarray(sizes))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    for s, n in enumerate(SIZES):
        assert not got[s, n:].any()                # dead rows are zero


def test_autograd_matches_dense_bmm():
    sizes = [128, 70, 0]
    src, dst, mask = _packed_edges([sizes], 128, seed=2)
    g = _graph(src, dst, mask, 3, 128)
    A_t = densify(torch.from_numpy(src[0]), torch.from_numpy(dst[0]),
                  torch.from_numpy(mask[0]), 3, 128)
    h = np.random.RandomState(2).randn(3, 128, 8).astype(np.float32)
    w = torch.from_numpy(np.random.RandomState(3).randn(3, 128, 8)
                         .astype(np.float32))

    def grad_of(agg):
        x = torch.from_numpy(h).requires_grad_()
        (agg(x) * w).pow(2).sum().backward()
        return x.grad.numpy()

    got = grad_of(lambda x: aggregate_sized(g, x))
    want = grad_of(lambda x: torch.bmm(A_t, x))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    got_t = grad_of(lambda x: aggregate_sized_t(g, x))
    want_t = grad_of(lambda x: torch.bmm(A_t.transpose(1, 2), x))
    np.testing.assert_allclose(got_t, want_t, rtol=1e-5, atol=1e-5)


def test_meta_gradient_through_inner_grads_matches_jax():
    """Grad-of-grad: the meta-gradient through a 3-step inner loop whose
    steps themselves differentiate the aggregation (second order), as
    tests/test_pallas.py:159-200 checks for the JAX primitive pair. The
    port runs both tasks through one graph, each with its own inner
    weight."""
    T, S, P_, H = 2, 2, 128, 8
    rng = np.random.RandomState(5)
    sizes = rng.randint(60, P_ + 1, (T, S))
    src, dst, mask = _packed_edges(sizes, P_, seed=7)
    h = rng.randn(T, S, P_, H).astype(np.float32)
    A = np.stack([np.asarray(jspmm.densify(
        jnp.asarray(src[t]), jnp.asarray(dst[t]), jnp.asarray(mask[t]),
        S, P_)) for t in range(T)])

    def jax_meta(w0):
        def one_task(A, h, sz):
            def inner(w):
                return (jax_sized(A, h * w, sz, True) ** 2).mean()
            w = w0
            for _ in range(3):
                w = w - 0.1 * jax.grad(inner)(w)
            return jax_sized(A, h * w, sz, True).sum()
        return jnp.mean(jnp.stack([one_task(
            jnp.asarray(A[t]), jnp.asarray(h[t]),
            jnp.asarray(sizes[t], jnp.int32)) for t in range(T)]))

    want = jax.jit(jax.grad(jax_meta))(jnp.float32(1.0))

    g = _graph(src, dst, mask, S, P_)
    x = torch.from_numpy(h.reshape(T * S, P_, H))
    w0 = torch.tensor(1.0, requires_grad=True)

    def per_task(w):                               # (T,) -> (T*S, 1, 1)
        return w.repeat_interleave(S)[:, None, None]

    w = w0 * torch.ones(T)
    for _ in range(3):
        inner = aggregate_sized(g, x * per_task(w)).pow(2) \
            .reshape(T, -1).mean(dim=1).sum()
        gw, = torch.autograd.grad(inner, w, create_graph=True)
        w = w - 0.1 * gw
    outs = aggregate_sized(g, x * per_task(w)).reshape(T, -1).sum(dim=1)
    got, = torch.autograd.grad(outs.mean(), w0)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4, atol=1e-6)


def test_kernel_counter_untouched_on_cpu_and_other_devices_raise():
    src, dst, mask = _packed_edges([[100, 128]], 128)
    g = _graph(src, dst, mask, 2, 128)
    h = torch.randn(2, 128, 4)
    with counted() as c:
        aggregate_sized(g, h)
        aggregate_sized_t(g, h)
    assert c.of(sized_spmm.LAUNCHES) == {"fwd": 0, "bwd": 0}   # the plain version ran
    meta = sized_spmm.SizedGraph(*(t.to("meta") for t in g))
    with pytest.raises(ValueError, match="cpu or cuda"):
        sized_spmm.launch("fwd", meta, h.to("meta"))
    with pytest.raises(ValueError, match="graph on"):
        sized_spmm.launch("fwd", meta, h)
    with pytest.raises(ValueError, match="row_ptr has"):
        sized_spmm.launch("bwd", g, h[:1])
    with pytest.raises(TypeError, match="int32"):
        sized_spmm.launch("fwd", g._replace(row_ptr=g.row_ptr.long()), h)
