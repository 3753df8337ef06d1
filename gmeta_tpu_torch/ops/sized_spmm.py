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

`aggregate_sized_shared` is the JAX batching rule for an adjacency that T
tasks share (pallas_spmm.py:254-264): h (T, S, P, H) goes through one
launch, the tasks on the kernel's grid, with no copy of the graph and none
of h.

The rectangular entry point, `csr_gather`, computes the same function into
out (len(row_ptr) - 1, H) from a table x of any height, through the
kernel's full-graph body: slabs of columns sized to the card's L2
(`slab_width`), and rows of more than `CHUNK` edges cut into chunks whose
float32 partial sums a second kernel adds up (`row_split`, the plan).
The edge-partitioned engine (parallel/edgepart_train.py) runs its
segment-sums over sorted destinations through it, with the autograd pair
`CsrAgg`/`CsrAggT` over a `CsrPair` (both CSRs of one edge set and their
plans, built once on the host).

Where each runs is decided by the tensor's device alone: a CPU tensor takes
the plain PyTorch version (`sized_plain`, `csr_plain`), a CUDA tensor
launches the kernel, and any other device raises. There is no fallback from
the kernel to the plain version. `launches` counts the packed path's kernel
launches per direction, `csr_launches` the rectangular entry point's and
`combine_launches` its combine kernel's, so a run can show which of its
paths went through which kernel (`launches_by_dtype` splits the packed
path's by the dtype of x). Within `spmm.count_aggregation`, every
`launch` (kernel or plain version) also adds its call to the tally, and
while a profiler is active each runs in an `agg` span
(utils/metrics.py).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Tuple

import torch

from gmeta_tpu_torch.ops import cuda_build, spmm
from gmeta_tpu_torch.utils.metrics import span

# Kernel launches per direction; only a CUDA launch adds to them.
launches = {"fwd": 0, "bwd": 0}        # packed sets (launch)
# the same launches split by the dtype of x: a bf16 run aggregates layer 1
# in float32 where that layer aggregates first (models/gcn.py)
launches_by_dtype = {"float32": {"fwd": 0, "bwd": 0},
                     "bfloat16": {"fwd": 0, "bwd": 0}}
csr_launches = {"fwd": 0, "bwd": 0}    # rectangular tables (csr_gather)
combine_launches = {"fwd": 0, "bwd": 0}   # csr_gather's split rows

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_ROWS = 2**31 - 512   # int32 row indices, with a block's overhang
_MAX_TASKS = 65535        # tasks sharing a graph: the grid's y dimension
CHUNK = 128     # csr_gather splits rows of more edges (sweep_sized_spmm.py)


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
         N: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row pointers over keys [0, N), `val` grouped by key, and the order
    (each entry's edge). A stable sort keeps each row's edges in edge
    order; dead edges take key N, after every row."""
    key, order = torch.sort(torch.where(live, key, N), stable=True)
    row_ptr = torch.searchsorted(key, torch.arange(N + 1, device=key.device))
    return row_ptr.to(torch.int32), val[order].to(torch.int32), order


def sized_graph(edge_src: torch.Tensor, edge_dst: torch.Tensor,
                edge_mask: torch.Tensor, B: int, P: int,
                positions: bool = False):
    """Both CSRs of the (..., E) packed edge lists of data/pack.py (leading
    dims are tasks), built on their device with no host sync. They hold
    what `densify` adds up: each edge with a non-zero mask once (masks are
    {0, 1}; a duplicate edge is two entries), its source clamped into its
    destination's bin as `densify` clamps it. Edges with mask 0, such as
    the pad edges (src 0, dst B*P-1), are left out, not weighted by 0, so a
    NaN in a row they name cannot reach the output.

    With `positions`, (the SizedGraph, pos_t): for each entry of the
    forward CSR, the position of the same edge in the transposed CSR
    (int32, one per edge slot), which a backward that walks the transposed
    CSR hands to one that walks the forward CSR (ops/gat_attention.py).
    It costs a scatter and a gather over the edge slots, which the GCN,
    calling without it, does not pay."""
    n_lead = math.prod(edge_dst.shape[:-1])
    dst = edge_dst.reshape(n_lead, -1).long()
    src = edge_src.reshape(n_lead, -1).long()
    start = dst // P * P                          # first slot of dst's bin
    src = start + (src - start).clamp(0, P - 1)
    base = torch.arange(n_lead, device=dst.device)[:, None] * (B * P)
    src, dst = (src + base).reshape(-1), (dst + base).reshape(-1)
    live = edge_mask.reshape(-1) != 0
    N = n_lead * B * P
    row_ptr, col, order = _csr(dst, src, live, N)
    row_ptr_t, col_t, order_t = _csr(src, dst, live, N)
    graph = SizedGraph(row_ptr, col, row_ptr_t, col_t)
    if not positions:
        return graph
    pos_t = torch.empty_like(order_t)
    pos_t[order_t] = torch.arange(order_t.numel(), device=order_t.device)
    return graph, pos_t[order].to(torch.int32)


def sized_plain(row_ptr: torch.Tensor, col: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: out (S, P, H) with
    out.view(N, H)[r] = sum of x.view(N, H)[col[e]] over e in
    [row_ptr[r], row_ptr[r+1]), a gather and an index_add_ summed in
    float32, returned in x's dtype. x (T, S, P, H) holds T tasks that
    share the graph: the same for each."""
    S, P, H = x.shape[-3:]
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(counts)        # each edge's output row
    xt = x.reshape(-1, S * P, H)
    src = xt[:, col[:rows.numel()].long()].float()
    out = torch.zeros(xt.shape, dtype=torch.float32, device=x.device)
    return out.index_add_(1, rows, src).view(x.shape).to(x.dtype)


def _check(row_ptr, col, x):
    if x.dim() not in (3, 4) or row_ptr.dim() != 1 or col.dim() != 1:
        raise ValueError(f"want x ([T,] S, P, H), row_ptr (N+1,), col "
                         f"(nnz,); got {tuple(x.shape)}, "
                         f"{tuple(row_ptr.shape)}, {tuple(col.shape)}")
    S, P, H = x.shape[-3:]
    if x.dim() == 4 and not 0 < x.shape[0] <= _MAX_TASKS:
        raise ValueError(f"{x.shape[0]} tasks: the kernel takes 1 to "
                         f"{_MAX_TASKS}")
    if row_ptr.shape[0] != S * P + 1:
        raise ValueError(f"row_ptr has {row_ptr.shape[0]} entries for "
                         f"x of {S * P} rows")
    if S * P >= _MAX_ROWS:
        raise ValueError(f"{S * P} rows exceed the kernel's int32 rows")
    if x.dtype not in _DTYPE_CODE and not (
            x.dtype == torch.float64 and x.device.type == "cpu"):
        raise TypeError(f"x must be float32 or bfloat16 (or float64 on the "
                        f"CPU), got {x.dtype}")
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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check_devices(row_ptr, col, x):
    if not (row_ptr.device == col.device == x.device):
        raise ValueError(f"graph on {row_ptr.device}/{col.device} but x on "
                         f"{x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"sized_spmm runs on cpu or cuda, not {x.device}")


def _run_kernel(row_ptr, col, x, out, n_rows: int, what: str,
                tasks: int = 1):
    """Launch the gather kernel for `n_rows` output rows of out on x's
    device and current stream, for each of `tasks` (x, out) pairs laid out
    (tasks, n_rows, H); raises if the launch was refused."""
    H = x.shape[-1]
    fn = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(row_ptr.data_ptr(), col.data_ptr(), x.data_ptr(),
                 out.data_ptr(), n_rows, H, tasks, _DTYPE_CODE[x.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"sized_spmm {what} kernel launch failed "
                           f"(CUDA error {err}) at N={n_rows} H={H} "
                           f"tasks={tasks} {x.dtype}")


def launch(direction: str, graph: SizedGraph, x: torch.Tensor) -> torch.Tensor:
    """Run one direction ("fwd" or "bwd") of the graph on x (S, P, H), or
    on x (T, S, P, H) for T tasks that share it, on x's device: the plain
    version on the CPU, one kernel launch on CUDA (counted in
    `launches`), inside an `agg` span."""
    with span("agg"):
        return _launch(direction, graph, x)


def _launch(direction: str, graph: SizedGraph,
            x: torch.Tensor) -> torch.Tensor:
    row_ptr, col = graph.csr(direction)
    _check_devices(row_ptr, col, x)
    _check(row_ptr, col, x)
    S, P, H = x.shape[-3:]
    tasks = x.shape[0] if x.dim() == 4 else 1
    if spmm.tally is not None:
        spmm.tally.add(S, P, tasks * H, row_ptr[-1])
    if x.device.type == "cpu":
        return sized_plain(row_ptr, col, x)
    out = torch.empty_like(x)
    _run_kernel(row_ptr, col, x, out, S * P, direction, tasks)
    launches[direction] += 1
    launches_by_dtype[str(x.dtype).removeprefix("torch.")][direction] += 1
    return out


# --- the rectangular entry point ---------------------------------------------

def csr_plain(row_ptr: torch.Tensor, col: torch.Tensor,
              x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `csr_gather`: out (N, H), N = len(row_ptr)
    - 1, with out[r] = sum of x[col[e]] over e in [row_ptr[r],
    row_ptr[r+1]), a gather and an index_add_ summed in float32 (float64
    for a float64 x), returned in x's dtype. x may have any number of
    rows."""
    N = row_ptr.shape[0] - 1
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(counts)        # each edge's output row
    src = x[col[:rows.numel()].long()].to(acc)
    out = torch.zeros(N, x.shape[1], dtype=acc, device=x.device)
    return out.index_add_(0, rows, src).to(x.dtype)


def _check_rect(row_ptr, col, x):
    if x.dim() != 2 or row_ptr.dim() != 1 or col.dim() != 1:
        raise ValueError(f"want x (rows,H), row_ptr (N+1,), col (nnz,); got "
                         f"{tuple(x.shape)}, {tuple(row_ptr.shape)}, "
                         f"{tuple(col.shape)}")
    if row_ptr.shape[0] < 1:
        raise ValueError("row_ptr needs at least one entry")
    if max(row_ptr.shape[0] - 1, x.shape[0]) >= _MAX_ROWS:
        raise ValueError(f"{row_ptr.shape[0] - 1} output or {x.shape[0]} "
                         f"table rows exceed the kernel's int32 rows")
    if x.dtype not in _DTYPE_CODE and not (
            x.dtype == torch.float64 and x.device.type == "cpu"):
        raise TypeError(f"x must be float32 or bfloat16 (or float64 on the "
                        f"CPU), got {x.dtype}")
    if row_ptr.dtype != torch.int32 or col.dtype != torch.int32:
        raise TypeError(f"row_ptr and col must be int32, got "
                        f"{row_ptr.dtype}, {col.dtype}")
    if not (x.is_contiguous() and row_ptr.is_contiguous()
            and col.is_contiguous()):
        raise ValueError("x, row_ptr and col must be contiguous")


def slab_width(rows: int, H: int, itemsize: int, l2_size: int) -> int:
    """Columns per slab of `csr_gather` over a table of `rows` x H
    elements of `itemsize` bytes: all of H where the table fits in half
    the L2 (the other half holds the CSR, the output and what other SMs
    stream), else the widest power of two, from one 32-byte sector up,
    whose slab (rows x S x itemsize) does."""
    budget = l2_size // 2
    if rows * H * itemsize <= budget:
        return H
    S = max(1, 32 // itemsize)
    while 2 * S < H and rows * 2 * S * itemsize <= budget:
        S *= 2
    return min(S, H)


class RowSplit(NamedTuple):
    """The heavy-row plan of one CSR: the rows of more than `chunk` edges,
    each cut into chunks of `chunk` edges (the last may be shorter), in
    edge order. Chunk c covers edges [chunk_start[c], min(chunk_start[c]
    + chunk, row_ptr[chunk_row[c] + 1])); split row i owns chunks
    [chunk_ptr[i], chunk_ptr[i + 1])."""
    rows: torch.Tensor         # (n_split,) int32, ascending
    chunk_ptr: torch.Tensor    # (n_split + 1,) int32
    chunk_row: torch.Tensor    # (n_chunks,) int32
    chunk_start: torch.Tensor  # (n_chunks,) int32
    chunk: int

    def to(self, device) -> "RowSplit":
        return RowSplit(*(t.to(device) for t in self[:4]), self.chunk)


def row_split(row_ptr: torch.Tensor, chunk: int = CHUNK) -> RowSplit:
    """The plan of a CSR's row pointers, on their device (on CUDA it reads
    the row lengths back to the host once)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.nonzero(counts > chunk).flatten()
    per = (counts[rows] + chunk - 1) // chunk
    chunk_ptr = torch.zeros(rows.numel() + 1, dtype=torch.long,
                            device=row_ptr.device)
    torch.cumsum(per, 0, out=chunk_ptr[1:])
    chunk_row = torch.repeat_interleave(rows, per)
    k = (torch.arange(chunk_row.numel(), device=row_ptr.device)
         - torch.repeat_interleave(chunk_ptr[:-1], per))  # chunk within row
    chunk_start = row_ptr[chunk_row].long() + k * chunk
    return RowSplit(rows.int(), chunk_ptr.int(), chunk_row.int(),
                    chunk_start.int(), chunk)


@functools.lru_cache(maxsize=None)
def l2_bytes(device_index: int) -> int:
    """The L2 cache's bytes of a CUDA device, as the card reports them."""
    fn = cuda_build.load("sized_spmm").gmeta_l2_bytes
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_longlong
    n = fn(device_index)
    if n <= 0:
        raise RuntimeError(f"reading the L2 size of cuda:{device_index} "
                           f"failed (CUDA error {-n})")
    return n


def _slab_lib():
    lib = cuda_build.load("sized_spmm")
    slab, combine = lib.gmeta_csr_slab, lib.gmeta_csr_combine
    if slab.argtypes is None:
        slab.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
            + [ctypes.c_void_p]
        slab.restype = ctypes.c_int
        combine.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        combine.restype = ctypes.c_int
    return slab, combine


def _check_split(split: RowSplit, row_ptr: torch.Tensor):
    for t in split[:4]:
        if t.device != row_ptr.device or t.dtype != torch.int32:
            raise ValueError(f"the row split must be int32 on "
                             f"{row_ptr.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("the row split's tensors must be contiguous")
    if split.rows.shape[0] + 1 != split.chunk_ptr.shape[0]:
        raise ValueError("the row split's rows and chunk_ptr disagree")


def csr_gather(row_ptr: torch.Tensor, col: torch.Tensor, x: torch.Tensor,
               count: str = "fwd", split: RowSplit = None) -> torch.Tensor:
    """out (len(row_ptr) - 1, H) = the CSR times the table x (rows, H), on
    x's device: `csr_plain` on the CPU (which also takes float64), the
    full-graph kernel on CUDA,
    counted in `csr_launches[count]` ("fwd" or "bwd", the direction the
    caller runs), and where `split` cuts rows, the combine kernel after it,
    counted in `combine_launches[count]`. `split` is the CSR's `row_split`
    (built here, with a host sync, when None); the slabs are `slab_width`
    columns for this table and card. Every col entry must lie in [0,
    rows): the kernel does not check it, so `csr_pair` checks that on the
    host."""
    _check_devices(row_ptr, col, x)
    _check_rect(row_ptr, col, x)
    if x.device.type == "cpu":
        return csr_plain(row_ptr, col, x)
    if split is None:
        split = row_split(row_ptr)
    _check_split(split, row_ptr)
    n_rows, H = row_ptr.shape[0] - 1, x.shape[1]
    n_chunks = split.chunk_row.shape[0]
    slab = slab_width(x.shape[0], H, x.element_size(),
                      l2_bytes(x.device.index or 0))
    out = torch.empty((n_rows, H), dtype=x.dtype, device=x.device)
    partial = torch.empty((n_chunks, H), dtype=torch.float32,
                          device=x.device)
    body, _ = _slab_lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = body(row_ptr.data_ptr(), col.data_ptr(), x.data_ptr(),
                   out.data_ptr(), partial.data_ptr(),
                   split.chunk_row.data_ptr(), split.chunk_start.data_ptr(),
                   n_rows, n_chunks, H, _DTYPE_CODE[x.dtype], slab,
                   split.chunk, stream)
        if err != 0:
            raise RuntimeError(f"csr_gather {count} kernel launch failed "
                               f"(CUDA error {err}) at N={n_rows} H={H} "
                               f"{x.dtype} slab={slab}")
        csr_launches[count] += 1
    if split.rows.shape[0]:
        csr_combine(split, partial, out, count)
    return out


def combine_plain(split: RowSplit, partial: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the combine kernel: out[split.rows[i]] =
    the float32 sum of partial[chunk_ptr[i]:chunk_ptr[i + 1]], in out's
    dtype; other rows of out stay. Returns out."""
    per = (split.chunk_ptr[1:] - split.chunk_ptr[:-1]).long()
    owner = torch.repeat_interleave(
        torch.arange(per.numel(), device=per.device), per)
    sums = torch.zeros((per.numel(), partial.shape[1]), dtype=torch.float32,
                       device=partial.device).index_add_(0, owner, partial)
    out[split.rows.long()] = sums.to(out.dtype)
    return out


def csr_combine(split: RowSplit, partial: torch.Tensor, out: torch.Tensor,
                count: str = "fwd") -> torch.Tensor:
    """Write the split rows of out (n_rows, H) from the chunks' float32
    partial sums (n_chunks, H): `combine_plain` on the CPU, the combine
    kernel on CUDA, counted in `combine_launches[count]`. Returns out."""
    if not (partial.device == out.device == split.rows.device):
        raise ValueError("split, partial and out must share a device")
    if out.device.type == "cpu":
        return combine_plain(split, partial, out)
    if partial.dtype != torch.float32 or out.dtype not in _DTYPE_CODE:
        raise TypeError(f"partial must be float32 and out float32 or "
                        f"bfloat16, got {partial.dtype}, {out.dtype}")
    if partial.shape != (split.chunk_row.shape[0], out.shape[1]) or not (
            partial.is_contiguous() and out.is_contiguous()):
        raise ValueError(f"partial {tuple(partial.shape)} does not hold the "
                         f"split's chunks of out {tuple(out.shape)}")
    n_split, H = split.rows.shape[0], out.shape[1]
    _, combine = _slab_lib()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = combine(split.rows.data_ptr(), split.chunk_ptr.data_ptr(),
                      partial.data_ptr(), out.data_ptr(), n_split, H,
                      _DTYPE_CODE[out.dtype], stream)
    if err != 0:
        raise RuntimeError(f"csr_gather {count} combine launch failed (CUDA "
                           f"error {err}) at {n_split} rows H={H}")
    combine_launches[count] += 1
    return out


class CsrPair(NamedTuple):
    """One edge set as two CSRs and their heavy-row plans: `row_ptr`/`col`
    keyed by destination (n_dst rows, columns into a table of n_src rows)
    and `row_ptr_t`/`col_t` keyed by source (n_src rows, columns into
    n_dst)."""
    row_ptr: torch.Tensor    # (n_dst + 1,) int32
    col: torch.Tensor        # (nnz,) int32 source rows, in edge order
    row_ptr_t: torch.Tensor  # (n_src + 1,) int32
    col_t: torch.Tensor      # (nnz,) int32 destination rows
    split: RowSplit          # of row_ptr
    split_t: RowSplit        # of row_ptr_t

    def to(self, device) -> "CsrPair":
        return CsrPair(*(t.to(device) for t in self))


def csr_pair(src, dst, n_src: int, n_dst: int) -> CsrPair:
    """Host: both CSRs of the edges (src[e] -> dst[e]) (numpy), as int32
    CPU tensors, with their row splits (`row_split`). A stable sort keeps
    each row's edges in edge order. Raises where an index lies outside its
    table, which the kernel does not check."""
    import numpy as np
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    for name, idx, n in (("src", src, n_src), ("dst", dst, n_dst)):
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise ValueError(f"{name} indices outside [0, {n})")
    if max(n_src, n_dst, src.size) >= _MAX_ROWS:
        raise ValueError("the kernel's indices are int32")

    def one(key, val, n):
        order = np.argsort(key, kind="stable")
        row_ptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(key, minlength=n), out=row_ptr[1:])
        return (torch.from_numpy(row_ptr.astype(np.int32)),
                torch.from_numpy(val[order].astype(np.int32)))
    row_ptr, col = one(dst, src, n_dst)
    row_ptr_t, col_t = one(src, dst, n_src)
    return CsrPair(row_ptr, col, row_ptr_t, col_t, row_split(row_ptr),
                   row_split(row_ptr_t))


class CsrAgg(torch.autograd.Function):
    """out (n_dst, H) = A @ x over the pair's destination CSR, x (n_src, H).
    Its backward is CsrAggT, whose backward is CsrAgg, so grad-of-grad works
    at any order."""

    @staticmethod
    def forward(ctx, pair, x):
        ctx.pair = pair
        return csr_gather(pair.row_ptr, pair.col, x.contiguous(), "fwd",
                          pair.split)

    @staticmethod
    def backward(ctx, g):
        return None, CsrAggT.apply(ctx.pair, g)


class CsrAggT(torch.autograd.Function):
    """out (n_src, H) = A^T @ g over the pair's source CSR."""

    @staticmethod
    def forward(ctx, pair, g):
        ctx.pair = pair
        return csr_gather(pair.row_ptr_t, pair.col_t, g.contiguous(), "bwd",
                          pair.split_t)

    @staticmethod
    def backward(ctx, g):
        return None, CsrAgg.apply(ctx.pair, g)


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


def aggregate_sized_shared(graph: SizedGraph, h: torch.Tensor) -> torch.Tensor:
    """(T, S, P, H) = A @ h[t] for each of T tasks that share the graph of
    S * P rows: one SizedAgg call, one launch on CUDA with the tasks on
    the kernel's grid. The gradient is one SizedAggT launch."""
    if h.dim() != 4:
        raise ValueError(f"want h (T, S, P, H), got {tuple(h.shape)}")
    return SizedAgg.apply(graph, h)
