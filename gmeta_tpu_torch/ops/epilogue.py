"""The GraphConv epilogue as one op: the norm scale, the bias, the ReLU and
the next layer's norm pre-scale, forward and backward, each one kernel on
CUDA (csrc/gcn_epilogue.cu).

For x (..., H) the product or aggregation of a GraphConv, n (..., 1) the
degree norm and b its bias, `graphconv_epilogue` returns

    y = relu(x * n + b),  out = y * n if scale_out else y

where out is what the next GraphConv starts from (its `h * norm`), or at the
last GraphConv y itself, which the readout takes. Replaces no Pallas kernel:
the JAX package writes this chain in jnp and XLA fuses it; in eager PyTorch
it was seven or more passes over the activations a GraphConv, forward and
backward (csrc/gcn_epilogue.cu says why one pass, and what bounds it).

The kernels compute the chain's bits, not only its function: every op
rounds as PyTorch's own kernel for it does, in the chain's order, and the
backward's mask is threshold_backward's test, so a ReLU at its kink takes
the chain's side. On CUDA the forward saves a one-byte mask for the
backward, and only where a gradient will be taken; the backward writes the
gradient of x and, where the bias needs one, the masked gradient that
`sum_to_size` reduces to b's shape (the reduction autograd runs for the
chain's broadcast add, so the same kernel and the same bits).

Where each runs is decided by the tensor's device alone: a CPU tensor takes
the plain PyTorch chain (`fwd_plain`, today's expression, differentiated by
autograd), a CUDA tensor launches the kernels, and any other device raises.
There is no fallback from a kernel to the plain version. Under
create_graph (second-order MAML) the backward is the plain `bwd_plain`,
which autograd differentiates again. `launches` counts the CUDA launches by
direction.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from gmeta_tpu_torch.ops import cuda_build

# Kernel launches per direction; only a CUDA launch adds to them.
launches = {"fwd": 0, "bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 2**31 - 1     # the kernels' row index is 32 bits


def fwd_plain(x: torch.Tensor, n: torch.Tensor, b: torch.Tensor,
              scale_out: bool, keep_y: bool = False,
              save_mask: bool = False):
    """Plain PyTorch version of the forward kernel, the chain it replaces:
    (out, y or None, mask or None). y where keep_y (out itself unless
    scale_out); mask (bool, x's shape) where save_mask, true where
    threshold_backward passes the gradient."""
    y = torch.relu(x * n + b)
    out = y * n if scale_out else y
    return out, y if keep_y else None, ~(y <= 0) if save_mask else None


def bwd_plain(g: torch.Tensor, n: torch.Tensor, mask: torch.Tensor,
              scale_out: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel: (g_x, g_pre), the
    gradients of x and of the pre-activation from g, the gradient of
    out. The ops autograd runs for the chain (mul, threshold, mul), so
    the same bits; differentiable in g."""
    g_pre = torch.where(mask, g * n if scale_out else g, 0)
    return g_pre * n, g_pre


def _lib():
    lib = cuda_build.load("gcn_epilogue")
    fwd, bwd = lib.gmeta_gcn_epilogue_fwd, lib.gmeta_gcn_epilogue_bwd
    if fwd.argtypes is None:
        fwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 \
            + [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                       ctypes.c_longlong] \
            + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fwd.restype = ctypes.c_int
        bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] \
            + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
    return fwd, bwd


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _bias_strides(b: torch.Tensor, x: torch.Tensor):
    """(stride over tasks, stride over H) in elements of a bias (H,) or
    (T, 1, ..., 1, H) for x (T, ..., H); raises on any other shape."""
    H = x.shape[-1]
    if b.shape == (H,):
        return 0, b.stride(0)
    if b.dim() == x.dim() and b.shape[0] == x.shape[0] \
            and b.shape[-1] == H and all(s == 1 for s in b.shape[1:-1]):
        return b.stride(0), b.stride(-1)
    raise ValueError(f"bias {tuple(b.shape)} is neither ({H},) nor "
                     f"({x.shape[0]}, 1, ..., 1, {H}) for x "
                     f"{tuple(x.shape)}")


def _check(x, n, b):
    if not (x.device == n.device == b.device):
        raise ValueError(f"x on {x.device}, n on {n.device}, b on "
                         f"{b.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the epilogue runs on cpu or cuda, not {x.device}")
    if x.device.type == "cpu":
        return
    if x.dim() < 2 or n.shape != x.shape[:-1] + (1,):
        raise ValueError(f"want x (T, ..., H) and n (T, ..., 1); got "
                         f"{tuple(x.shape)}, {tuple(n.shape)}")
    if x.dtype not in _DTYPE_CODE or not x.dtype == n.dtype == b.dtype:
        raise TypeError(f"x, n and b must all be float32 or all bfloat16, "
                        f"got {x.dtype}, {n.dtype}, {b.dtype}")
    if not (x.is_contiguous() and n.is_contiguous()):
        raise ValueError("x and n must be contiguous")
    if x.shape[:-1].numel() > _MAX_ROWS:
        raise ValueError(f"{x.shape[:-1].numel()} rows exceed the kernels' "
                         f"32-bit row index")
    if n.requires_grad:
        raise ValueError("the norm is a constant of the graph: the kernels "
                         "give it no gradient")


def _launch_fwd(x, n, b, scale_out: bool, keep_y: bool, save_mask: bool):
    """The forward kernel on x's device and current stream: (out, y or
    None, mask or None) as `fwd_plain` returns them, y its own tensor
    wherever keep_y."""
    H, rows = x.shape[-1], x.shape[:-1].numel()
    st_t, st_h = _bias_strides(b, x)
    out = torch.empty_like(x)
    y = torch.empty_like(x) if keep_y else None
    mask = torch.empty(x.shape, dtype=torch.bool, device=x.device) \
        if save_mask else None
    fwd, _ = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fwd(x.data_ptr(), n.data_ptr(), b.data_ptr(), st_t, st_h,
                  out.data_ptr(), _ptr(y), _ptr(mask), rows, H,
                  max(1, x.shape[1:-1].numel()), int(scale_out),
                  _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"gcn_epilogue forward launch failed (CUDA error "
                           f"{err}) at {tuple(x.shape)} {x.dtype}")
    launches["fwd"] += 1
    return out, y, mask


def _launch_bwd(g, n, mask, scale_out: bool, want_pre: bool):
    """The backward kernel: (g_x, g_pre or None) as `bwd_plain`."""
    H, rows = g.shape[-1], g.shape[:-1].numel()
    g_x = torch.empty_like(g)
    g_pre = torch.empty_like(g) if want_pre else None
    _, bwd = _lib()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = bwd(g.data_ptr(), n.data_ptr(), mask.data_ptr(),
                  g_x.data_ptr(), _ptr(g_pre), rows, H, int(scale_out),
                  _DTYPE_CODE[g.dtype], stream)
    if err != 0:
        raise RuntimeError(f"gcn_epilogue backward launch failed (CUDA "
                           f"error {err}) at {tuple(g.shape)} {g.dtype}")
    launches["bwd"] += 1
    return g_x, g_pre


class Epilogue(torch.autograd.Function):
    """`graphconv_epilogue` where a gradient is taken: the forward kernel
    saving its mask, the backward kernel (the plain backward under
    create_graph). Returns (out, y or None); y, kept where keep_y,
    carries no gradient: it is the oracle check's copy of the
    activations."""

    @staticmethod
    def forward(ctx, x, n, b, scale_out: bool, keep_y: bool):
        out, y, mask = _launch_fwd(x, n, b, scale_out, keep_y, True)
        ctx.save_for_backward(n, mask)
        ctx.scale_out, ctx.b_shape = scale_out, b.shape
        if y is not None:
            ctx.mark_non_differentiable(y)
        return out, y

    @staticmethod
    def backward(ctx, g, *_):
        n, mask = ctx.saved_tensors
        want_b = ctx.needs_input_grad[2]
        if torch.is_grad_enabled():
            g_x, g_pre = bwd_plain(g, n, mask, ctx.scale_out)
        else:
            g_x, g_pre = _launch_bwd(g.contiguous(), n, mask, ctx.scale_out,
                                     want_b)
        g_b = g_pre.sum_to_size(ctx.b_shape) if want_b else None
        return g_x if ctx.needs_input_grad[0] else None, None, g_b, None, None


def graphconv_epilogue(x: torch.Tensor, n: torch.Tensor, b: torch.Tensor,
                       scale_out: bool, keep_y: bool = False
                       ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out, y or None): out = relu(x * n + b) * n where scale_out, else
    relu(x * n + b); y = relu(x * n + b) where keep_y. x (T, ..., H), n
    (T, ..., 1), b (H,) or (T, 1, ..., 1, H), which may be a stride-0
    expand. On a CPU tensor the plain chain, on CUDA `fused`."""
    _check(x, n, b)
    if x.device.type == "cpu":
        return fwd_plain(x, n, b, scale_out, keep_y)[:2]
    return fused(x, n, b, scale_out, keep_y)


def fused(x, n, b, scale_out: bool, keep_y: bool = False):
    """`graphconv_epilogue` through the kernels: one forward launch, which
    saves the backward's mask only where grad mode is on and x or b
    requires grad (then through `Epilogue`)."""
    if not (torch.is_grad_enabled()
            and (x.requires_grad or b.requires_grad)):
        return _launch_fwd(x, n, b, scale_out, keep_y, False)[:2]
    return Epilogue.apply(x, n, b, scale_out, keep_y)
