"""GAT's edge attention over a packed set: the graph operand, the CUDA
kernels' wrapper, their plain version, and the autograd Function.

For zst (N, K*F + 2K), whose row j holds z_j (K heads of F features) and
then the scores s_j = a_src . z_j and t_j = a_dst . z_j of each head
(models/gat.py makes all three with one product), and for each row i and
head k:

    e_ij = LeakyReLU_0.2(t_i + s_j)   over i itself and each in-edge j -> i
    alpha_i = softmax_j(e_i)
    o_i = sum_j alpha_ij z_j

The terms are the self term first, then the forward CSR's in-edges in edge
order; a duplicate edge slot is a term of its own, as the GCN counts it.
Pad slots have only their self term (no real edge names them). Replaces no
Pallas kernel: the JAX package has no GAT, and no op of the port computed
this (the packed gather sums its sources without weights).
csrc/gat_attention.cu says what bounds it and how its design answers.

The backward recomputes each term's weight from the forward's log-sum-exp
(lse): dz_j = sum_i alpha_ij g_i, and through the softmax and LeakyReLU's
slope the gradients of s and t, all into one gradient of zst. The
transposed walk gives dz and ds; dt needs each edge's term at the
destination, which it reads at the edge's transposed position (`AttnGraph`
carries it).

Where each runs is decided by the tensor's device alone: a CPU tensor takes
the plain PyTorch version (`fwd_plain`, `bwd_plain`, the kernels'
arithmetic with gathers and index_add_, float64 too), a CUDA tensor
launches the kernels (float32), and any other device raises; there is no
fallback. The backward is first order: under create_graph it raises.

Which kernels a CUDA call launches follows its graph (`route`): every
source a destination reads lies in its *segment*, a range of rows that no
real edge leaves (a bin of P slots in the slot layout; an original bin's
live rows, or a piece of a task's tail of padding, in the repacked one,
data/repack.py `segments`). `AttnGraph` carries the segments' first rows
and the host's bound on a segment's rows. Where that bound is at most
`STAGE_ROWS`, the staged kernels run: a block per segment and head copies
the segment's rows into shared memory once and sums every term from there
(their bits: csrc/gat_attention.cu's header); otherwise the walk kernels,
which read each term's source row from L2. The choice rests on the host's
number alone, so it waits for nothing.

`LAUNCHES` names the counts of the CUDA kernel launches by direction (the
backward is three kernels; utils/metrics.py), `STAGED` those of them that
ran staged. Every call, forward and backward, runs in an `attn` span
(utils/metrics.py).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as nnf

from gmeta_tpu_torch.ops import cuda_build
from gmeta_tpu_torch.ops.sized_spmm import SizedGraph, sized_graph
from gmeta_tpu_torch.utils.metrics import count, span

# Counted names of kernel launches per direction; only a CUDA launch counts.
LAUNCHES = {"fwd": "gat_attention.fwd", "bwd": "gat_attention.bwd"}
STAGED = {"fwd": "gat_attention.staged.fwd",
          "bwd": "gat_attention.staged.bwd"}

SLOPE = 0.2               # LeakyReLU's negative slope (the paper's)
_MAX_ROWS = 2**31 - 1     # the kernels' row index is 32 bits
# The most rows a segment may hold for the staged kernels: at 1024 rows
# (the presets' bins) their fixed shared memory, forward 153 KB and
# backward 165 KB, leaves a block's 227 KB room to cache 16 and 6.2 edges a
# row (csrc/gat_attention.cu `fwd_fixed`, `bwd_fixed`, `room`).
STAGE_ROWS = 1024
# A segment's rows are split among blocks until the grid holds this many
# blocks an SM (at most 8 blocks a segment and head).
_BLOCKS_PER_SM = 4


class AttnGraph(NamedTuple):
    """A packed set's edges for the attention: both CSRs over its T*B*P
    flat rows (ops/sized_spmm.py `SizedGraph`), for each entry of the
    forward CSR the position of the same edge in the transposed one, and
    the segments (module docstring): `seg` (S + 1,) int32 their first rows
    in order, then T*B*P; `seg_rows` the host's bound on a segment's rows
    (0: none known, the walk kernels run)."""
    sized: SizedGraph
    pos_t: torch.Tensor   # (T*E,) int32
    seg: torch.Tensor = None
    seg_rows: int = 0


def attn_graph(edge_src: torch.Tensor, edge_dst: torch.Tensor,
               edge_mask: torch.Tensor, B: int, P: int,
               segments=None) -> AttnGraph:
    """The AttnGraph of (..., E) packed edge lists, on their device, with
    no host sync: the real edges (mask 1) of `sized_graph`. Its segments
    are each task's bins of P rows or, given `segments` (data/repack.py
    `Segments`: each task's segments' first rows (T, n) on the device and
    their bound on the host), those."""
    sized, pos_t = sized_graph(edge_src, edge_dst, edge_mask, B, P,
                               positions=True)
    T, dev = math.prod(edge_src.shape[:-1]), edge_src.device
    if segments is None:
        first, rows = torch.arange(T * B, device=dev, dtype=torch.int32) * P, P
    else:
        first = (segments.start.to(torch.int32) + B * P * torch.arange(
            T, device=dev, dtype=torch.int32)[:, None]).reshape(-1)
        rows = segments.rows
    end = torch.full((1,), T * B * P, device=dev, dtype=torch.int32)
    return AttnGraph(sized, pos_t, torch.cat([first, end]), rows)


def route(graph: AttnGraph) -> str:
    """'staged' where the graph's segments fit the staged kernels'
    shared memory (at most STAGE_ROWS rows, by the host's bound), else
    'walk'."""
    staged = graph.seg is not None and 0 < graph.seg_rows <= STAGE_ROWS
    return "staged" if staged else "walk"


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def shares(segments: int, K: int, sms: int) -> int:
    """Blocks a segment and head is split among: enough for
    _BLOCKS_PER_SM blocks an SM over the grid, at most 8."""
    return max(1, min(8, -(-_BLOCKS_PER_SM * sms // max(segments * K, 1))))


def _terms(graph: AttnGraph, N: int, device):
    """(dst, src) of every term: each row's self term, then each edge."""
    row_ptr, col = graph.sized.csr("fwd")
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.arange(N, device=device)
    dst = torch.cat([rows, torch.repeat_interleave(counts)])
    src = torch.cat([rows, col[:dst.numel() - N].long()])
    return dst, src


def _split(zst: torch.Tensor, K: int, F: int):
    N, KF = zst.shape[0], K * F
    return (zst[:, :KF].reshape(N, K, F), zst[:, KF:KF + K],
            zst[:, KF + K:])


def fwd_plain(graph: AttnGraph, zst: torch.Tensor, K: int, F: int):
    """Plain PyTorch version of the forward kernel: (o (N, K*F), lse
    (N, K)), each row's weighted sum taken before its division by the
    softmax's sum, as the kernel takes it."""
    N = zst.shape[0]
    z, s, t = _split(zst, K, F)
    dst, src = _terms(graph, N, zst.device)
    e = nnf.leaky_relu(t[dst] + s[src], SLOPE)                    # (M, K)
    m = torch.full((N, K), -torch.inf, dtype=zst.dtype, device=zst.device)
    m = m.scatter_reduce(0, dst[:, None].expand(-1, K), e, "amax")
    p = torch.exp(e - m[dst])
    ell = torch.zeros_like(m).index_add_(0, dst, p)
    o = torch.zeros_like(z).index_add_(0, dst, p[..., None] * z[src])
    return (o / ell[..., None]).reshape(N, K * F), m + torch.log(ell)


def bwd_plain(graph: AttnGraph, zst: torch.Tensor, o: torch.Tensor,
              lse: torch.Tensor, g: torch.Tensor, K: int,
              F: int) -> torch.Tensor:
    """Plain PyTorch version of the backward kernels: the gradient of zst
    from g, the gradient of o, with each term's weight recomputed from
    lse."""
    N = zst.shape[0]
    z, s, t = _split(zst, K, F)
    g = g.reshape(N, K, F)
    dst, src = _terms(graph, N, zst.device)
    D = (g * o.reshape(N, K, F)).sum(-1)                          # (N, K)
    x = t[dst] + s[src]
    a = torch.exp(nnf.leaky_relu(x, SLOPE) - lse[dst])
    dot = (g[dst] * z[src]).sum(-1)
    dx = a * (dot - D[dst]) * torch.where(x > 0, 1.0, SLOPE)
    dz = torch.zeros_like(z).index_add_(0, src, a[..., None] * g[dst])
    ds = torch.zeros_like(s).index_add_(0, src, dx)
    dt = torch.zeros_like(t).index_add_(0, dst, dx)
    return torch.cat([dz.reshape(N, K * F), ds, dt], dim=1)


def _lib():
    """The kernels' entry points by (route, direction)."""
    lib = cuda_build.load("gat_attention")
    fns = {("walk", "fwd"): lib.gmeta_gat_attn_fwd,
           ("walk", "bwd"): lib.gmeta_gat_attn_bwd,
           ("staged", "fwd"): lib.gmeta_gat_attn_fwd_staged,
           ("staged", "bwd"): lib.gmeta_gat_attn_bwd_staged}
    if fns["walk", "fwd"].argtypes is None:
        ptrs = {("walk", "fwd"): 5, ("walk", "bwd"): 12,
                ("staged", "fwd"): 6, ("staged", "bwd"): 13}
        for key, fn in fns.items():
            sizes = [ctypes.c_longlong] * (2 if key[0] == "staged" else 1)
            ints = 5 if key[0] == "staged" else 3
            fn.argtypes = [ctypes.c_void_p] * ptrs[key] + sizes \
                + [ctypes.c_int] * ints + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return fns


def _call(how: str, direction: str, graph: AttnGraph, device, args,
          K: int, F: int, ld: int) -> int:
    """The `how` kernels of `direction` on device's current stream with
    args, then the geometry: N rows, for a staged call also the segments,
    their bound and the blocks a segment is split among, then K, F and ld.
    The CUDA error code."""
    N = graph.sized.row_ptr.shape[0] - 1
    geometry = [N]
    if how == "staged":
        S = graph.seg.shape[0] - 1
        geometry += [S, graph.seg_rows, shares(S, K, _sms(device.index))]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        return _lib()[how, direction](*args, *geometry, K, F, ld, stream)


def _check(graph: AttnGraph, zst: torch.Tensor, K: int, F: int):
    if zst.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the attention runs on cpu or cuda, not "
                         f"{zst.device}")
    tensors = tuple(graph.sized) + (graph.pos_t,) + (
        () if graph.seg is None else (graph.seg,))
    if any(t.device != zst.device for t in tensors):
        raise ValueError(f"graph on {graph.sized.row_ptr.device} but zst on "
                         f"{zst.device}")
    if zst.dim() != 2 or zst.shape[1] != K * F + 2 * K:
        raise ValueError(f"want zst (N, K*F + 2K) = (N, {K * F + 2 * K}), "
                         f"got {tuple(zst.shape)}")
    if graph.sized.row_ptr.shape[0] != zst.shape[0] + 1:
        raise ValueError(f"the graph has {graph.sized.row_ptr.shape[0] - 1} "
                         f"rows, zst {zst.shape[0]}")
    if zst.device.type == "cpu":
        return
    if zst.dtype != torch.float32:
        raise TypeError(f"the kernels take float32, got {zst.dtype}")
    if zst.shape[0] > _MAX_ROWS:
        raise ValueError(f"{zst.shape[0]} rows exceed the kernels' 32-bit "
                         f"row index")
    vec = F % 4 == 0 and (K * F + 2 * K) % 4 == 0   # 16-byte rows
    widest = 8 * 32 * (4 if vec else 1)
    if F > widest:
        raise ValueError(f"heads of {F} features exceed the kernels' "
                         f"{widest}")
    if any(t.dtype != torch.int32 or not t.is_contiguous()
           for t in tensors):
        raise TypeError("the graph's tensors must be contiguous int32")


def _launch_fwd(graph: AttnGraph, zst: torch.Tensor, K: int, F: int):
    N = zst.shape[0]
    row_ptr, col = graph.sized.csr("fwd")
    o = torch.empty((N, K * F), dtype=zst.dtype, device=zst.device)
    lse = torch.empty((N, K), dtype=zst.dtype, device=zst.device)
    how = route(graph)
    seg = [graph.seg.data_ptr()] if how == "staged" else []
    err = _call(how, "fwd", graph, zst.device,
                [row_ptr.data_ptr(), col.data_ptr(), *seg, zst.data_ptr(),
                 o.data_ptr(), lse.data_ptr()], K, F, zst.shape[1])
    if err != 0:
        raise RuntimeError(f"gat_attention forward launch failed (CUDA "
                           f"error {err}) at N={N} K={K} F={F} ({how})")
    count(LAUNCHES["fwd"])
    if how == "staged":
        count(STAGED["fwd"])
    return o, lse


def _launch_bwd(graph: AttnGraph, zst, o, lse, g, K: int, F: int):
    N = zst.shape[0]
    sized = graph.sized
    nnz = graph.pos_t.shape[0]
    dzst = torch.empty_like(zst)
    D = torch.empty((N, K), dtype=zst.dtype, device=zst.device)
    dx_t = torch.empty((max(nnz, 1), K), dtype=zst.dtype, device=zst.device)
    dx_self = torch.empty_like(D)
    how = route(graph)
    seg = [graph.seg.data_ptr()] if how == "staged" else []
    err = _call(how, "bwd", graph, zst.device,
                [sized.row_ptr.data_ptr(), sized.row_ptr_t.data_ptr(),
                 sized.col_t.data_ptr(), graph.pos_t.data_ptr(), *seg,
                 zst.data_ptr(), o.data_ptr(), lse.data_ptr(), g.data_ptr(),
                 dzst.data_ptr(), D.data_ptr(), dx_t.data_ptr(),
                 dx_self.data_ptr()], K, F, zst.shape[1])
    if err != 0:
        raise RuntimeError(f"gat_attention backward launch failed (CUDA "
                           f"error {err}) at N={N} K={K} F={F} ({how})")
    count(LAUNCHES["bwd"], 3)
    if how == "staged":
        count(STAGED["bwd"], 3)
    return dzst


class Attention(torch.autograd.Function):
    """o = the attention of zst over the graph (module docstring); its
    backward is the gradient of zst, first order."""

    @staticmethod
    def forward(ctx, graph: AttnGraph, zst, K: int, F: int):
        if zst.device.type == "cpu":
            o, lse = fwd_plain(graph, zst, K, F)
        else:
            o, lse = _launch_fwd(graph, zst, K, F)
        ctx.graph, ctx.K, ctx.F = graph, K, F
        ctx.save_for_backward(zst, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "GAT's attention has a first-order backward only (second-"
                "order MAML is refused for arch='gat')")
        zst, o, lse = ctx.saved_tensors
        with span("attn"):
            if zst.device.type == "cpu":
                dzst = bwd_plain(ctx.graph, zst, o, lse, g, ctx.K, ctx.F)
            else:
                dzst = _launch_bwd(ctx.graph, zst, o, lse, g.contiguous(),
                                   ctx.K, ctx.F)
        return None, dzst, None, None


def attend(graph: AttnGraph, zst: torch.Tensor, K: int,
           F: int) -> torch.Tensor:
    """o (N, K*F): each row's K heads of attention-weighted sums over the
    graph (module docstring), on zst's device, in an `attn` span."""
    _check(graph, zst, K, F)
    with span("attn"):
        return Attention.apply(graph, zst.contiguous(), K, F)
