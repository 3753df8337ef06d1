"""The GraphConv epilogue op (ops/epilogue.py) against the chain it replaces,
`relu(x * n + b)` and the next layer's `* n`, and autograd of that chain:
bit for bit, forward and backward.

On the CPU the op is the chain itself (`fwd_plain`), and the launch
counter stays at 0. The route the card takes (`fused`, the autograd
Function, the mask saved only where a gradient is taken, the bias gradient
reduced to any of its shapes, create_graph) runs here too, with each
kernel launch replaced by its plain version. Marked `cuda`, the same tests
run the kernels, which have no CPU mode, and further ones compare each
kernel with its plain version and a whole meta-step with the chain's. This
file imports neither jax nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_epilogue.py
"""

import pytest
import torch

from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
from gmeta_tpu_torch.meta.maml import MetaLearner
from gmeta_tpu_torch.ops import epilogue
from gmeta_tpu_torch.utils.metrics import counted

DTYPES = [torch.float32, torch.bfloat16]


def _bits(t):
    """The tensor's bits as integers (bool as is), so that a comparison
    tells -0.0 from 0.0 and compares NaNs by their payload."""
    if t.dtype == torch.bool:
        return t
    return t.contiguous().view({2: torch.int16, 4: torch.int32,
                                8: torch.int64}[t.element_size()])


def same_bits(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                        a.dtype, b.dtype)
    assert torch.equal(_bits(a), _bits(b))


def chain(x, n, b, scale_out, keep_y=False):
    """The parent's expression: the GraphConv's `relu(h * norm + b)` and
    the next layer's `h * norm`, as separate PyTorch ops."""
    y = torch.relu(x * n + b)
    return (y * n if scale_out else y), (y if keep_y else None)


def _emulated_fwd(x, n, b, scale_out, keep_y, save_mask):
    """`fwd_plain` as the kernel writes it: y, where kept, in its own
    tensor (the plain chain's y is out itself without scale_out)."""
    out, y, mask = epilogue.fwd_plain(x, n, b, scale_out, keep_y, save_mask)
    return out, (y.clone() if y is out else y), mask


def _emulated_bwd(g, n, mask, scale_out, want_pre):
    g_x, g_pre = epilogue.bwd_plain(g, n, mask, scale_out)
    return g_x, g_pre if want_pre else None


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def route(request, monkeypatch):
    """The device of the card's route: on "cuda" the kernels; on "cpu" the
    same Python route with each launch replaced by its plain version."""
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU: the epilogue kernels run only "
                        "on CUDA")
        return torch.device("cuda")
    monkeypatch.setattr(epilogue, "_launch_fwd", _emulated_fwd)
    monkeypatch.setattr(epilogue, "_launch_bwd", _emulated_bwd)
    monkeypatch.setattr(epilogue, "graphconv_epilogue", epilogue.fused)
    return torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the epilogue kernels run only on "
                    "CUDA")
    return torch.device("cuda")


def _inputs(shape, dtype, device, bias="H", seed=0, kinks=True):
    """x (T, B, P, H), n (T, B, P, 1) as degree norms, and b in one of its
    forms: "H" (H,), "TH" (T, 1, 1, H), "expand" a stride-0 expand of (H,)
    to (T, 1, 1, H). With kinks, pre-activations of exactly 0 and -0 at
    known places (x * n + b == 0 in every precision)."""
    g = torch.Generator().manual_seed(seed)
    T, B, P, H = shape
    x = torch.randn(shape, generator=g)
    n = torch.rsqrt(torch.randint(1, 30, (T, B, P, 1), generator=g).float())
    bh = torch.randn(H, generator=g) * 0.5
    if kinks and H >= 4 and P >= 2:
        n[:, :, :2] = 0.5
        x[:, :, 0, :4] = torch.tensor([2.0, -2.0, 0.0, -0.0])
        bh[:4] = torch.tensor([-1.0, 1.0, 0.0, -0.0])
    x, n, bh = (t.to(device, dtype) for t in (x, n, bh))
    if bias == "H":
        b = bh
    elif bias == "TH":
        b = (bh + torch.arange(T, device=device, dtype=dtype)[:, None]
             ).reshape(T, 1, 1, H)
    else:
        b = bh.expand(T, H).reshape(T, 1, 1, H)
        assert T == 1 or b.stride(0) == 0
    return x, n, b


# ---- the CPU path: the chain itself ----------------------------------------

@pytest.mark.parametrize("dtype", DTYPES + [torch.float64])
@pytest.mark.parametrize("scale_out", [True, False])
@pytest.mark.parametrize("bias", ["H", "TH", "expand"])
def test_cpu_is_the_chain_bitwise_and_launches_nothing(dtype, scale_out,
                                                      bias):
    x, n, b = _inputs((2, 3, 5, 6), dtype, "cpu", bias)
    launched = counted()
    for keep_y in (False, True):
        out, y = epilogue.graphconv_epilogue(x, n, b, scale_out, keep_y)
        want, want_y = chain(x, n, b, scale_out, keep_y)
        same_bits(out, want)
        if keep_y:
            same_bits(y, want_y)
        else:
            assert y is None
    xg, bg = x.clone().requires_grad_(), b.clone().requires_grad_()
    out, _ = epilogue.graphconv_epilogue(xg, n, bg, scale_out)
    r = torch.randn(out.shape, dtype=torch.float64).to(dtype)
    got = torch.autograd.grad((out * r).sum(), (xg, bg))
    want = torch.autograd.grad((chain(xg, n, bg, scale_out)[0] * r).sum(),
                               (xg, bg))
    for a, w in zip(got, want):
        same_bits(a, w)
    assert launched.of(epilogue.LAUNCHES) == {"fwd": 0, "bwd": 0}


# ---- the card's route (emulated on the CPU, the kernels on CUDA) ----------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale_out", [True, False])
@pytest.mark.parametrize("bias", ["H", "TH", "expand"])
@pytest.mark.parametrize("shape", [(2, 3, 5, 8), (3, 2, 7, 5),
                                   (2, 1, 9, 50), (1, 2, 3, 130)])
def test_route_forward_and_gradients_are_the_chains_bits(route, dtype,
                                                         scale_out, bias,
                                                         shape):
    """out, y, g_x and g_b through the op equal the chain's forward and
    autograd's gradients of it, bit for bit, for every form of the bias
    (its gradient reduced to its own shape, through the expand)."""
    x, n, b = _inputs(shape, dtype, route, bias, seed=shape[-1])
    r = torch.randn(shape, generator=torch.Generator().manual_seed(1)
                    ).to(route, dtype)
    got, want = [], []
    for fn, sink in ((epilogue.graphconv_epilogue, got), (chain, want)):
        xg = x.clone().requires_grad_()
        bg = b.detach().clone() if bias != "expand" else \
            b.detach()[:, 0, 0].clone()
        bg.requires_grad_()
        b_in = bg.expand(shape[0], shape[-1]).reshape(b.shape) \
            if bias == "expand" else bg
        out, y = fn(xg, n, b_in, scale_out, True)
        sink += [out.detach(), y.detach()]
        sink += torch.autograd.grad((out * r).sum(), (xg, bg))
    for a, w in zip(got, want):
        same_bits(a, w)


@pytest.mark.parametrize("dtype", DTYPES)
def test_route_saves_a_mask_only_where_a_gradient_is_taken(route, dtype,
                                                           monkeypatch):
    x, n, b = _inputs((2, 2, 4, 8), dtype, route)
    saved = []
    launch = epilogue._launch_fwd

    def spy(*args):
        saved.append(args[-1])
        return launch(*args)
    monkeypatch.setattr(epilogue, "_launch_fwd", spy)
    epilogue.graphconv_epilogue(x, n, b, True)                # no grad needed
    with torch.no_grad():
        epilogue.graphconv_epilogue(x.requires_grad_(), n, b, True)
    epilogue.graphconv_epilogue(x, n, b, True)                # x needs one
    epilogue.graphconv_epilogue(x.detach(), n, b.requires_grad_(), False)
    assert saved == [False, False, True, True]


@pytest.mark.parametrize("dtype", DTYPES)
def test_route_double_backward_is_the_chains(route, dtype):
    """create_graph=True: the gradients, and the gradient of a function of
    them, equal the chain's."""
    x, n, b = _inputs((2, 3, 6, 8), dtype, route, "TH")
    g = torch.Generator().manual_seed(3)
    r, s = (torch.randn(x.shape, generator=g).to(route, dtype)
            for _ in range(2))
    t = torch.randn(b.shape, generator=g).to(route, dtype)
    res = []
    for fn in (epilogue.graphconv_epilogue, chain):
        xg, bg = x.clone().requires_grad_(), b.clone().requires_grad_()
        out, _ = fn(xg, n, bg, True)
        gx, gb = torch.autograd.grad((out * out * r).sum(), (xg, bg),
                                     create_graph=True)
        res.append([gx, gb, *torch.autograd.grad(
            (gx * s).sum() + (gb * t).sum(), (xg, bg))])
    for a, w in zip(*res):
        same_bits(a.detach(), w.detach())


def _tiny():
    return synthetic_disjoint(num_graphs=1, nodes_per_graph=150,
                              avg_degree=5, feat_dim=8, num_classes=9,
                              n_way=3, k_spt=3, k_qry=4, batchsz=12, h=2,
                              sample_nodes=60, seed=3)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("first_order,remat", [(True, True), (True, False),
                                               (False, True)])
def test_route_meta_steps_are_the_chains_bits(route, dtype, first_order,
                                              remat, monkeypatch):
    """Two meta-steps through the op give theta and Adam's moments bit for
    bit as the parent's expression does: first order with the inner steps
    recomputed (remat, the arxiv record's mode) or not, and second order
    (the backward's plain version under create_graph)."""
    store, ds = _tiny()
    batches = ds["train"].batches(4, shuffle=False)
    batch = [next(batches), next(batches)]
    spec = build_model_config(Config(hidden_dim=16), store.feat_dim, 3)

    def run():
        ml = MetaLearner(spec, 3, update_lr=0.05, meta_lr=1e-3,
                         update_step=3, update_step_test=2, seed=5,
                         agg="sized", remat=remat, first_order=first_order,
                         compute_dtype=dtype, device=route)
        ml.set_features(store.features)
        for bt in batch:
            ml.train_step(bt)
        return [t.detach().clone() for t in
                (*ml.params, *ml.opt_state.mu, *ml.opt_state.nu)]

    with counted() as c:
        got = run()
    launched = c.of(epilogue.LAUNCHES)
    monkeypatch.setattr(epilogue, "graphconv_epilogue", chain)
    want = run()
    for a, w in zip(got, want):
        same_bits(a, w)
    if route.type == "cuda":
        assert launched["fwd"] > 0 and launched["bwd"] > 0, launched


# ---- the kernels on the card -----------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(32, 37, 1024, 256), (3, 2, 5, 1),
                                   (2, 3, 7, 5), (2, 1, 9, 50),
                                   (4, 2, 3, 130), (1, 1, 1, 8)])
def test_kernels_are_their_plain_versions_bitwise(cuda, dtype, shape):
    """Each kernel against its plain version on the card: out, y, the mask,
    g_x and g_pre, at arxiv's query shape and ragged small ones, with
    kinks, a NaN, and a bias per task."""
    x, n, b = _inputs(shape, dtype, cuda, "TH" if shape[0] > 1 else "H")
    x.view(-1)[-1] = float("nan")
    for scale_out in (True, False):
        got = epilogue._launch_fwd(x, n, b, scale_out, True, True)
        want = epilogue.fwd_plain(x, n, b, scale_out, True, True)
        for a, w in zip(got, want):
            same_bits(a, w)
        mask = want[2]
        del got, want
        g = torch.randn(shape, device=cuda).to(dtype)
        for want_pre in (True, False):
            got = epilogue._launch_bwd(g, n, mask, scale_out, want_pre)
            want = epilogue.bwd_plain(g, n, mask, scale_out)
            same_bits(got[0], want[0])
            if want_pre:
                same_bits(got[1], want[1])
            else:
                assert got[1] is None
            del got, want
        del g, mask
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_misaligned_tensors_take_the_scalar_path(cuda, dtype):
    """x and n one element past an aligned start (contiguous views with a
    storage offset): the kernels run on scalars, the same bits."""
    x, n, b = _inputs((2, 3, 4, 16), dtype, cuda)
    xs = torch.empty(x.numel() + 1, device=cuda, dtype=dtype)[1:]
    xs.copy_(x.reshape(-1))
    xs = xs.view(x.shape)
    assert xs.data_ptr() % 16 != 0
    got = epilogue._launch_fwd(xs, n, b, True, False, True)
    want = epilogue.fwd_plain(x, n, b, True, False, True)
    same_bits(got[0], want[0])
    same_bits(got[2], want[2])


@pytest.mark.cuda
def test_launch_counter_counts_each_kernel(cuda):
    x, n, b = _inputs((2, 2, 4, 8), torch.float32, cuda)
    with counted() as c:
        epilogue.graphconv_epilogue(x, n, b, True)
        xg = x.clone().requires_grad_()
        out, _ = epilogue.graphconv_epilogue(xg, n, b, True)
        out.sum().backward()
    assert c.of(epilogue.LAUNCHES) == {"fwd": 2, "bwd": 1}


@pytest.mark.cuda
def test_refuses_what_the_kernels_do_not_take(cuda):
    x, n, b = _inputs((2, 2, 4, 8), torch.float32, cuda)
    with pytest.raises(TypeError):
        epilogue.graphconv_epilogue(x, n.double(), b, True)
    with pytest.raises(ValueError):
        epilogue.graphconv_epilogue(x.transpose(1, 2), n, b, True)
    with pytest.raises(ValueError):
        epilogue.graphconv_epilogue(x, n, b[:4], True)
    with pytest.raises(ValueError):
        epilogue.graphconv_epilogue(x, n.requires_grad_(), b, True)
