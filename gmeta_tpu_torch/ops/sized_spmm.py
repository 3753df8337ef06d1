"""Size-aware block-diagonal aggregation over edge lists: the graph operand,
the CUDA kernel's wrapper, its plain version, and the autograd pair.

Counterpart of gmeta_tpu/ops/pallas_spmm.py. For the packing of
data/pack.py, block s of the (S, P, P) adjacency holds only its first
n_s = sizes[s] node rows (the bin fill), and the TPU kernels

    forward    out[s] = A[s]   @ h[s]   (`_fwd_kernel`)
    transpose  out[s] = A[s]^T @ g[s]   (`_bwd_kernel`, its backward)

read A dense, skip its dead tiles and write zeros to rows >= n_s. Here A is
never built. `sized_graph` turns a packed set's edge list into two CSRs over
the flat rows N = S * P, keyed by destination (forward) and by source
(transpose), and one gather kernel (csrc/sized_spmm.cu) serves both
directions. The CSRs hold exactly the edges `densify` would add up, so on
packed data, where no edge touches a dead row, both directions equal the
full product with dead rows zero (the JAX `sized_reference`).

Where each runs is decided by the tensor's device alone: a CPU tensor takes
the plain PyTorch version (`sized_plain`), a CUDA tensor launches the kernel,
and any other device raises. There is no fallback from the kernel to the
plain version. `launches` counts kernel launches per direction, so a run can
show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Tuple

import torch

from gmeta_tpu_torch.ops import cuda_build

# Kernel launches per direction; only a CUDA launch adds to them.
launches = {"fwd": 0, "bwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 2**31 - 512   # int32 row indices, with a block's overhang


class SizedGraph(NamedTuple):
    """A packed set's adjacency as two CSRs over its N = T*B*P flat rows
    (row (t*B + b)*P + i is slot i of bin b of task t). `col` and `col_t`
    hold one entry per edge slot; the masked edges sort to their ends, past
    row_ptr[N], where no row reaches them."""
    row_ptr: torch.Tensor    # (N+1,) int32, keyed by destination row
    col: torch.Tensor        # (T*E,) int32 source rows, in edge order
    row_ptr_t: torch.Tensor  # (N+1,) int32, keyed by source row
    col_t: torch.Tensor      # (T*E,) int32 destination rows, in edge order

    def csr(self, direction: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(row_ptr, col) of "fwd" (A @ x) or "bwd" (A^T @ x)."""
        return {"fwd": (self.row_ptr, self.col),
                "bwd": (self.row_ptr_t, self.col_t)}[direction]

    def degrees(self) -> torch.Tensor:
        """(N,) int32 in-degrees, duplicates counted: `degrees_from_dense`
        of the same edges."""
        return self.row_ptr[1:] - self.row_ptr[:-1]


def _csr(key: torch.Tensor, val: torch.Tensor, live: torch.Tensor,
         N: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row pointers over keys [0, N) and `val` grouped by key. A stable sort
    keeps each row's edges in edge order; dead edges take key N, after
    every row."""
    key, order = torch.sort(torch.where(live, key, N), stable=True)
    row_ptr = torch.searchsorted(key, torch.arange(N + 1, device=key.device))
    return row_ptr.to(torch.int32), val[order].to(torch.int32)


def sized_graph(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_mask: torch.Tensor, B: int, P: int) -> SizedGraph:
    """Both CSRs of the (..., E) packed edge lists of data/pack.py (leading
    dims are tasks), built on their device with no host sync. They hold
    what `densify` adds up: each edge with a non-zero mask once (masks are
    {0, 1}; a duplicate edge is two entries), its source clamped into its
    destination's bin as `densify` clamps it. Edges with mask 0, such as
    the pad edges (src 0, dst B*P-1), are left out, not weighted by 0, so a
    NaN in a row they name cannot reach the output."""
    n_lead = math.prod(edge_dst.shape[:-1])
    dst = edge_dst.reshape(n_lead, -1).long()
    src = edge_src.reshape(n_lead, -1).long()
    start = dst // P * P                          # first slot of dst's bin
    src = start + (src - start).clamp(0, P - 1)
    base = torch.arange(n_lead, device=dst.device)[:, None] * (B * P)
    src, dst = (src + base).reshape(-1), (dst + base).reshape(-1)
    live = edge_mask.reshape(-1) != 0
    N = n_lead * B * P
    row_ptr, col = _csr(dst, src, live, N)
    row_ptr_t, col_t = _csr(src, dst, live, N)
    return SizedGraph(row_ptr, col, row_ptr_t, col_t)


def sized_plain(row_ptr: torch.Tensor, col: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: out (S, P, H) with
    out.view(N, H)[r] = sum of x.view(N, H)[col[e]] over e in
    [row_ptr[r], row_ptr[r+1]), a gather and an index_add_ summed in
    float32, returned in x's dtype."""
    S, P, H = x.shape
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(counts)        # each edge's output row
    src = x.reshape(S * P, H)[col[:rows.numel()].long()].float()
    out = torch.zeros(S * P, H, dtype=torch.float32, device=x.device)
    return out.index_add_(0, rows, src).view(S, P, H).to(x.dtype)


def _check(row_ptr, col, x):
    if x.dim() != 3 or row_ptr.dim() != 1 or col.dim() != 1:
        raise ValueError(f"want x (S,P,H), row_ptr (N+1,), col (nnz,); got "
                         f"{tuple(x.shape)}, {tuple(row_ptr.shape)}, "
                         f"{tuple(col.shape)}")
    S, P, H = x.shape
    if row_ptr.shape[0] != S * P + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries for "
                         f"x of {S * P} rows")
    if S * P >= _MAX_ROWS:
        raise ValueError(f"{S * P} rows exceed the kernel's int32 rows")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if row_ptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError(f"row_ptr and col must be int32, got "
                        f"{row_ptr.dtype}, {col.dtype}")
    if not (x.is_contiguous() and row_ptr.is_contiguous()
            and col.is_contiguous()):
        raise ValueError("x, row_ptr and col must be contiguous")


def _lib():
    lib = cuda_build.load("sized_spmm")
    fn = lib.gmeta_sized_spmm
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(direction: str, graph: SizedGraph, x: torch.Tensor) -> torch.Tensor:
    """Run one direction ("fwd" or "bwd") of the graph on x (S, P, H), on
    x's device: the plain version on the CPU, the kernel on CUDA (counted in
    `launches`)."""
    row_ptr, col = graph.csr(direction)
    if not (row_ptr.device == col.device == x.device):
        raise ValueError(f"graph on {row_ptr.device}/{col.device} but x on "
                         f"{x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sized_spmm runs on cpu or cuda, not {x.device}")
    _check(row_ptr, col, x)
    if x.device.type == "cpu":
        return sized_plain(row_ptr, col, x)
    S, P, H = x.shape
    out = torch.empty_like(x)
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(row_ptr.data_ptr(), col.data_ptr(), x.data_ptr(),
                 out.data_ptr(), S * P, H, _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"sized_spmm {direction} kernel launch failed "
                           f"(CUDA error {err}) at N={S * P} H={H} {x.dtype}")
    launches[direction] += 1
    return out


class SizedAgg(torch.autograd.Function):
    """out = A @ h over the graph's forward CSR. Linear in h: its backward
    is SizedAggT, itself differentiable, so grad-of-grad works at any order.
    The graph is structural: ctx keeps its index tensors, which get no
    gradient."""

    @staticmethod
    def forward(ctx, graph, h):
        ctx.graph = graph
        return launch("fwd", graph, h.contiguous())

    @staticmethod
    def backward(ctx, g):
        return None, SizedAggT.apply(ctx.graph, g)


class SizedAggT(torch.autograd.Function):
    """out = A^T @ g over the transposed CSR; its backward is SizedAgg."""

    @staticmethod
    def forward(ctx, graph, g):
        ctx.graph = graph
        return launch("bwd", graph, g.contiguous())

    @staticmethod
    def backward(ctx, g):
        return None, SizedAgg.apply(ctx.graph, g)


def aggregate_sized(graph: SizedGraph, h: torch.Tensor) -> torch.Tensor:
    """(S, P, H) = A @ h, with S * P the graph's rows."""
    return SizedAgg.apply(graph, h)


def aggregate_sized_t(graph: SizedGraph, g: torch.Tensor) -> torch.Tensor:
    """(S, P, H) = A^T @ g."""
    return SizedAggT.apply(graph, g)
