"""Graphormer's attention over each graph of a packed set, with the
shortest-path bias, and the distances it reads: the graph operand, the
CUDA kernels' wrapper, their plain versions, and the autograd Function.

A *segment* is a range of rows that holds one graph: a bin of P slots in
the slot layout, or an original bin's live rows (and pieces of a task's
tail of padding) in the repacked one (data/repack.py `segments`). Within
a segment, for qkv (N, 3H) whose row i holds q_i, k_i and v_i (K heads of
D = H / K features each) and for each head h:

    A_ij = q_i . k_j / sqrt(D) + b[t, row(phi_ij), h]
    o_i = sum_j softmax_j(A_i)_j v_j

over the keys j of i's segment, where t is the segment's task and b
(T, 512, K) the task's spatial table. A pad slot attends only to itself,
and is no live row's key. phi_ij is the shortest-path distance from i to
j over the segment's edges taken both ways, a byte: 0 on the diagonal,
`NO_PATH` (255) where no path joins them, and a distance above 254 is
254; `row` maps a byte to the table's row, `NO_PATH` to 511 and any
other to itself (rows 255-510 are never read).

The distances are computed once per task set (`spatial_graph`): each
segment's tile of `stride` x `stride` bytes (stride the host's bound on a
segment's rows, rounded up to 64), by a breadth-first search from every
row. With them come each row's in-degree and out-degree over the set's
real edge slots (each duplicate counted), capped at 511, for the input's
centrality encoding (models/graphormer.py).

Replaces no Pallas kernel: the JAX package has no Graphormer, and no op
of the port computed this (the GAT's kernels score edges, not all pairs).
csrc/spatial_attention.cu says what bounds it and how its design answers.

Where each runs is decided by the tensors' device alone: a CPU tensor
takes the plain PyTorch versions (`distances_plain`, `fwd_plain`,
`bwd_plain`, the kernels' arithmetic over each segment's dense tile,
float64 too), a CUDA tensor launches the kernels (float32), and any other
device raises; there is no fallback. The backward is first order: under
create_graph it raises.

`LAUNCHES` names the counts of the CUDA kernel launches (utils/metrics.py):
a forward is one, a backward four (the rows' deltas, the keys' gradients,
the queries' gradients with the table's partial sums, the table's sums),
the distances one. `PAIRS` counts the distance pairs a set computes
(each segment's rows squared), on the host. Every attention call, forward
and backward, runs in an `sattn` span.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from gmeta_tpu_torch.ops import cuda_build
from gmeta_tpu_torch.ops.sized_spmm import sized_graph
from gmeta_tpu_torch.utils.metrics import count, span

# Counted names of kernel launches; only a CUDA launch counts.
LAUNCHES = {"fwd": "spatial_attention.fwd", "bwd": "spatial_attention.bwd",
            "spd": "spatial_attention.spd"}
PAIRS = "spd.pairs"

TABLE_ROWS = 512      # rows of the spatial table and of each degree table
NO_PATH = 255         # phi's byte for a pair no path joins: table row 511
MAX_DISTANCE = 254    # a longer path takes this byte
MAX_DEGREE = TABLE_ROWS - 1
TILE = 64             # phi's stride is a multiple of this
# The forward kernel's rescale step (csrc/spatial_attention.cu `RESCALE`):
# a row's running max moves only to a score more than this many base-2
# units above it
RESCALE = 8.0
# The most rows a segment may hold: the distance kernel keeps a segment's
# adjacency in shared memory as 32 words a row (csrc/spatial_attention.cu)
MAX_ROWS = 1024
# Head widths the kernels are built for (csrc/spatial_attention.cu
# `dispatch`); the plain versions take any
HEAD_WIDTHS = (4, 8, 10)
_MAX_ROWS_N = 2**31 - 1     # the kernels' row index is 32 bits


class SpatialGraph(NamedTuple):
    """A packed set's graphs for the attention (module docstring): `seg`
    (S + 1,) int32 the segments' first rows in order, then N; `per_task`
    segments a task (host), segment s of task s // per_task; `rows` the
    host's bound on a segment's rows; `stride` phi's tile stride; `phi`
    (S * stride * stride,) uint8, segment s's tile at s * stride**2, row i
    of it at i * stride; `live` (N,) uint8, 1 for a live slot; `deg_in`,
    `deg_out` (N,) int64 capped at MAX_DEGREE."""
    seg: torch.Tensor
    per_task: int
    rows: int
    stride: int
    phi: torch.Tensor
    live: torch.Tensor
    deg_in: torch.Tensor
    deg_out: torch.Tensor


def table_row(phi: torch.Tensor) -> torch.Tensor:
    """The spatial table's row of each phi byte (long)."""
    phi = phi.long()
    return torch.where(phi == NO_PATH, TABLE_ROWS - 1, phi)


def spatial_graph(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                  edge_mask: torch.Tensor, node_mask: torch.Tensor, B: int,
                  P: int, segments=None) -> SpatialGraph:
    """The SpatialGraph of (T, E) packed edge lists and their (T, B, P)
    node mask, on their device, with no host sync. Its segments are each
    task's bins of P rows or, given `segments` (data/repack.py
    `Segments`: each task's segments' first rows (T, n) on the device,
    their bound and lengths on the host), those. Counts the pairs under
    PAIRS: each segment's rows squared, from the host's lengths (the
    slot layout's bins are P rows each)."""
    T, dev = math.prod(edge_src.shape[:-1]), edge_src.device
    N = T * B * P
    if segments is None:
        first = torch.arange(T * B, device=dev, dtype=torch.int32) * P
        per_task, rows, pairs = B, P, T * B * P * P
    else:
        first = (segments.start.to(torch.int32) + B * P * torch.arange(
            T, device=dev, dtype=torch.int32)[:, None]).reshape(-1)
        per_task, rows = segments.start.shape[1], segments.rows
        pairs = int(np.square(np.asarray(segments.lengths,
                                         dtype=np.int64)).sum())
    if rows > MAX_ROWS:
        raise ValueError(f"segments of up to {rows} rows: the distances "
                         f"take at most {MAX_ROWS}")
    end = torch.full((1,), N, device=dev, dtype=torch.int32)
    seg = torch.cat([first, end])
    sized = sized_graph(edge_src, edge_dst, edge_mask, B, P)
    stride = -(-rows // TILE) * TILE
    if dev.type == "cpu":
        phi = distances_plain(sized.row_ptr, sized.col, seg, stride)
    else:
        phi = _launch_spd(sized.row_ptr, sized.col, seg, rows, stride)
    count(PAIRS, pairs)

    def degree(row_ptr):
        return (row_ptr[1:] - row_ptr[:-1]).long().clamp_(max=MAX_DEGREE)
    return SpatialGraph(
        seg=seg, per_task=per_task, rows=rows, stride=stride, phi=phi,
        live=(node_mask.reshape(-1) != 0).to(torch.uint8),
        deg_in=degree(sized.row_ptr), deg_out=degree(sized.row_ptr_t))


def distances_plain(row_ptr: torch.Tensor, col: torch.Tensor,
                    seg: torch.Tensor, stride: int) -> torch.Tensor:
    """Plain PyTorch version of the distance kernel: each segment's tile,
    a breadth-first search by boolean products from every row at once,
    over the forward CSR's edges within the segment taken both ways
    (an edge leaving its segment is left out, as the kernel leaves it).
    Waits for the device each level: for the CPU and the tests."""
    S = seg.numel() - 1
    phi = torch.full((S, stride, stride), NO_PATH, dtype=torch.uint8,
                     device=seg.device)
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    dst = torch.repeat_interleave(counts)
    src = col[:dst.numel()].long()
    bounds = seg.long().tolist()
    for s in range(S):
        a, b = bounds[s], bounds[s + 1]
        n = b - a
        if n == 0:
            continue
        inside = (dst >= a) & (dst < b) & (src >= a) & (src < b)
        adj = torch.zeros(n, n, dtype=torch.float32, device=seg.device)
        adj[dst[inside] - a, src[inside] - a] = 1.0
        adj = ((adj + adj.T) > 0).float()
        dist = torch.full((n, n), NO_PATH, dtype=torch.uint8,
                          device=seg.device)
        reach = torch.eye(n, dtype=torch.bool, device=seg.device)
        dist[reach] = 0
        frontier, d = reach.clone(), 0
        while bool(frontier.any()):
            d += 1
            frontier = ((frontier.float() @ adj) > 0) & ~reach
            dist[frontier] = min(d, MAX_DISTANCE)
            reach |= frontier
        phi[s, :n, :n] = dist
    return phi.reshape(-1)


def _windows(graph: SpatialGraph, N: int):
    """(rows (S, R) of each segment's window of R = graph.rows rows,
    clamped into [0, N), which of them lie in the segment, each window's
    task (S,), its (S, R, R) table rows)."""
    S, R, st = graph.seg.numel() - 1, graph.rows, graph.stride
    first, end = graph.seg[:-1].long(), graph.seg[1:].long()
    idx = first[:, None] + torch.arange(R, device=first.device)
    valid = idx < end[:, None]
    task = torch.arange(S, device=first.device) // graph.per_task
    codes = table_row(graph.phi.view(S, st, st)[:, :R, :R])
    return idx.clamp(max=N - 1), valid, task, codes


def _scores(graph: SpatialGraph, qkv, table, K: int, D: int):
    """The windows' (q, k, v) each (S, R, K, D), the scores (S, K, R, R)
    with the masked pairs at -inf, and the windows (`_windows`). A row
    outside its segment keeps only its self pair, so that nothing is
    undefined; it is never written back."""
    N, H = qkv.shape[0], K * D
    idx, valid, task, codes = _windows(graph, N)
    S, R = idx.shape
    q, k, v = (qkv[idx, i * H:(i + 1) * H].view(S, R, K, D)
               for i in range(3))
    bias = table[task[:, None, None], codes].permute(0, 3, 1, 2)
    s = torch.einsum("sikd,sjkd->skij", q, k) / math.sqrt(D) + bias
    live = (graph.live[idx] != 0) & valid
    eye = torch.eye(R, dtype=torch.bool, device=qkv.device)
    keep = (live[:, :, None] & live[:, None, :]) | eye
    keep &= valid[:, :, None] == valid[:, None, :]
    s = s.masked_fill(~keep[:, None], -math.inf)
    return (q, k, v), s, (idx, valid, task, codes)


def fwd_plain(graph: SpatialGraph, qkv: torch.Tensor, table: torch.Tensor,
              K: int, D: int):
    """Plain PyTorch version of the forward kernel: (o (N, K*D), lse
    (N, K)), each segment's dense softmax."""
    N = qkv.shape[0]
    (_, _, v), s, (idx, valid, _, _) = _scores(graph, qkv, table, K, D)
    lse = torch.logsumexp(s, dim=-1)                           # (S, K, R)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("skij,sjkd->sikd", p, v)
    rows = idx[valid]
    out = qkv.new_zeros(N, K * D)
    out[rows] = o[valid].reshape(-1, K * D)
    lse_out = qkv.new_zeros(N, K)
    lse_out[rows] = lse.permute(0, 2, 1)[valid]
    return out, lse_out


def bwd_plain(graph: SpatialGraph, qkv: torch.Tensor, table: torch.Tensor,
              o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor, K: int,
              D: int):
    """Plain PyTorch version of the backward kernels: (the gradient of
    qkv, of the table) from g, the gradient of o, each pair's weight
    recomputed from lse."""
    N, H = qkv.shape[0], K * D
    (q, k, v), s, (idx, valid, task, codes) = _scores(graph, qkv, table,
                                                     K, D)
    S, R = idx.shape
    keep = valid[:, :, None, None].to(qkv.dtype)
    dO = g[idx].view(S, R, K, D) * keep
    Dv = (dO * o[idx].view(S, R, K, D)).sum(-1)                # (S, R, K)
    p = torch.exp(s - lse[idx].permute(0, 2, 1)[..., None])
    dv = torch.einsum("skij,sikd->sjkd", p, dO)
    dp = torch.einsum("sikd,sjkd->skij", dO, v)
    ds = p * (dp - Dv.permute(0, 2, 1)[..., None])
    scale = 1.0 / math.sqrt(D)
    dq = torch.einsum("skij,sjkd->sikd", ds, k) * scale
    dk = torch.einsum("skij,sikd->sjkd", ds, q) * scale
    dqkv = qkv.new_zeros(N, 3 * H)
    dqkv[idx[valid]] = torch.cat([x.reshape(S, R, H) for x in (dq, dk, dv)],
                                 dim=-1)[valid]
    dtable = torch.zeros_like(table)
    dtable.index_put_((task[:, None, None].expand_as(codes), codes),
                      ds.permute(0, 2, 3, 1), accumulate=True)
    return dqkv, dtable


def _lib():
    lib = cuda_build.load("spatial_attention")
    fns = (lib.gmeta_spd, lib.gmeta_sattn_fwd, lib.gmeta_sattn_bwd)
    if fns[0].argtypes is None:
        p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        fns[0].argtypes = [p] * 4 + [ll, ll, i, i, p]
        fns[1].argtypes = [p] * 7 + [ll, ll, i, i, i, i, i, p]
        fns[2].argtypes = [p] * 12 + [ll, ll, i, i, i, i, i, i, p]
        for fn in fns:
            fn.restype = ctypes.c_int
    return fns


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch_spd(row_ptr, col, seg, rows: int, stride: int) -> torch.Tensor:
    S, N = seg.numel() - 1, row_ptr.numel() - 1
    phi = torch.empty(max(S, 1) * stride * stride, dtype=torch.uint8,
                      device=seg.device)
    with torch.cuda.device(seg.device):
        err = _lib()[0](row_ptr.data_ptr(), col.data_ptr(), seg.data_ptr(),
                        phi.data_ptr(), N, S, rows, stride,
                        _stream(seg.device))
    if err != 0:
        raise RuntimeError(f"spatial distance launch failed (CUDA error "
                           f"{err}) at S={S} rows={rows}")
    count(LAUNCHES["spd"])
    return phi


def _check(graph: SpatialGraph, qkv: torch.Tensor, table: torch.Tensor,
           K: int, D: int):
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the attention runs on cpu or cuda, not "
                         f"{qkv.device}")
    tensors = (graph.seg, graph.phi, graph.live, table)
    if any(t.device != qkv.device for t in tensors):
        raise ValueError(f"graph on {graph.seg.device}, table on "
                         f"{table.device}, qkv on {qkv.device}")
    if qkv.dim() != 2 or qkv.shape[1] != 3 * K * D:
        raise ValueError(f"want qkv (N, 3 K D) = (N, {3 * K * D}), got "
                         f"{tuple(qkv.shape)}")
    if graph.live.shape[0] != qkv.shape[0]:
        raise ValueError(f"the graph has {graph.live.shape[0]} rows, qkv "
                         f"{qkv.shape[0]}")
    S = graph.seg.numel() - 1
    if S % graph.per_task or table.shape != (S // graph.per_task,
                                             TABLE_ROWS, K):
        raise ValueError(f"want a table ({S // graph.per_task}, "
                         f"{TABLE_ROWS}, {K}) for {S} segments of "
                         f"{graph.per_task} a task, got "
                         f"{tuple(table.shape)}")
    if qkv.device.type == "cpu":
        return
    if qkv.dtype != torch.float32 or table.dtype != torch.float32:
        raise TypeError(f"the kernels take float32, got {qkv.dtype} and "
                        f"{table.dtype}")
    if D not in HEAD_WIDTHS:
        raise ValueError(f"heads of {D} features: the kernels are built "
                         f"for {HEAD_WIDTHS}")
    if not 1 <= K <= 8:
        raise ValueError(f"{K} heads: the kernels take 1 to 8")
    if qkv.shape[0] > _MAX_ROWS_N or graph.rows > MAX_ROWS:
        raise ValueError(f"{qkv.shape[0]} rows in segments of up to "
                         f"{graph.rows}: the kernels take 32-bit rows and "
                         f"segments of at most {MAX_ROWS}")
    if graph.seg.dtype != torch.int32 or graph.phi.dtype != torch.uint8:
        raise TypeError("the graph's segments must be int32, phi uint8")


def _geometry(graph: SpatialGraph, N: int):
    S = graph.seg.numel() - 1
    return [N, S, graph.per_task, graph.rows, graph.stride]


def _launch_fwd(graph: SpatialGraph, qkv, table, K: int, D: int):
    N = qkv.shape[0]
    o = torch.empty((N, K * D), dtype=qkv.dtype, device=qkv.device)
    lse = torch.empty((N, K), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _lib()[1](qkv.data_ptr(), table.data_ptr(),
                        graph.phi.data_ptr(), graph.seg.data_ptr(),
                        graph.live.data_ptr(), o.data_ptr(), lse.data_ptr(),
                        *_geometry(graph, N), K, D, _stream(qkv.device))
    if err != 0:
        raise RuntimeError(f"spatial attention forward launch failed (CUDA "
                           f"error {err}) at N={N} K={K} D={D}")
    count(LAUNCHES["fwd"])
    return o, lse


QUERY_TILE = 64       # rows a block of the query kernels takes


def query_tiles(rows: int) -> int:
    """Row tiles of a segment in the backward's query kernel
    (csrc/spatial_attention.cu `QT` rows each), which each write one
    partial sum of the table."""
    return -(-rows // QUERY_TILE)


def _launch_bwd(graph: SpatialGraph, qkv, table, o, lse, g, K: int, D: int):
    N = qkv.shape[0]
    S = graph.seg.numel() - 1
    T = table.shape[0]
    dqkv = torch.empty_like(qkv)
    dtable = torch.empty_like(table)
    delta = torch.empty((N, K), dtype=qkv.dtype, device=qkv.device)
    partial = torch.empty((max(S, 1) * query_tiles(graph.rows), 256, K),
                          dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = _lib()[2](qkv.data_ptr(), table.data_ptr(),
                        graph.phi.data_ptr(), graph.seg.data_ptr(),
                        graph.live.data_ptr(), o.data_ptr(), lse.data_ptr(),
                        g.data_ptr(), dqkv.data_ptr(), dtable.data_ptr(),
                        delta.data_ptr(), partial.data_ptr(),
                        *_geometry(graph, N), T, K, D, _stream(qkv.device))
    if err != 0:
        raise RuntimeError(f"spatial attention backward launch failed "
                           f"(CUDA error {err}) at N={N} K={K} D={D}")
    count(LAUNCHES["bwd"], 4)
    return dqkv, dtable


class Attention(torch.autograd.Function):
    """o = the attention of qkv over the graph with the table's bias
    (module docstring); its backward gives the gradients of qkv and of the
    table, first order."""

    @staticmethod
    def forward(ctx, graph: SpatialGraph, qkv, table, K: int, D: int):
        if qkv.device.type == "cpu":
            o, lse = fwd_plain(graph, qkv, table, K, D)
        else:
            o, lse = _launch_fwd(graph, qkv, table, K, D)
        ctx.graph, ctx.K, ctx.D = graph, K, D
        ctx.save_for_backward(qkv, table, o, lse)
        return o

    @staticmethod
    def backward(ctx, g):
        if torch.is_grad_enabled():
            raise NotImplementedError(
                "Graphormer's attention has a first-order backward only "
                "(second-order MAML is refused for arch='graphormer')")
        qkv, table, o, lse = ctx.saved_tensors
        with span("sattn"):
            if qkv.device.type == "cpu":
                dqkv, dtable = bwd_plain(ctx.graph, qkv, table, o, lse, g,
                                         ctx.K, ctx.D)
            else:
                dqkv, dtable = _launch_bwd(ctx.graph, qkv, table, o, lse,
                                           g.contiguous(), ctx.K, ctx.D)
        return None, dqkv, dtable, None, None


def attend(graph: SpatialGraph, qkv: torch.Tensor, table: torch.Tensor,
           K: int, D: int) -> torch.Tensor:
    """o (N, K*D): each row's K heads of attention over its segment with
    the task's spatial bias (module docstring), on qkv's device, in an
    `sattn` span. `table` is (T, 512, K), one per task."""
    _check(graph, qkv, table, K, D)
    with span("sattn"):
        return Attention.apply(graph, qkv.contiguous(), table.contiguous(),
                               K, D)
