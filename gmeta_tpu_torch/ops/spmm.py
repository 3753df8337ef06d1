"""Sparse aggregation over edge lists: the dense block-diagonal path, the
segment-sum, ELL and SDDMM ops.

Replacement for DGL's SpMM `update_all(copy_src, sum)` (learner.py:38-45):
out[v] = sum over edges (u -> v) of h[u]. Counterpart of
gmeta_tpu/ops/spmm.py, all of whose paths are compiler ops in JAX (none is
a Pallas kernel), so plain PyTorch is their counterpart here:

1. `densify` + `aggregate_dense`: the packing (data/pack.py) makes the
   batch adjacency block-diagonal with S blocks of <= P x P, so the
   adjacency is built ONCE per task by a scalar scatter of E edge weights,
   and every GCN layer, inner step and backward pass is then a batched
   matrix product. The size-aware path (ops/sized_spmm.py) builds no
   adjacency: it gathers over the edge lists.
2. `in_degrees` + `aggregate`: the edge-list segment-sum (the oracle).
3. `build_ell` (host, numpy) + `aggregate_ell`: fixed-width neighbour slabs.
4. `sddmm` + `aggregate_weighted`: the weighted SpMM and its backward
   (d/dh by SpMM^T, d/dw by SDDMM).
The edge-partitioned engine (parallel/edgepart_train.py) aggregates with
`ops/sized_spmm.py` `csr_gather` over CSRs built on the host, not with
these.

`count_aggregation` tallies the work of the packed aggregations, dense and
sized, that run within it (bench.py's FLOP count). While a profiler is
active, each of those calls, forward or backward, runs in an `agg` span
(utils/metrics.py).
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from gmeta_tpu_torch.utils.metrics import bracket, span


@dataclasses.dataclass
class AggregationWork:
    """The aggregation calls tallied by `count_aggregation`, each direction
    a call: `flops` at the TPU kernel's own cost estimate, 2 S P^2 H a call
    over S blocks of P rows and H features (gmeta_tpu/ops/pallas_spmm.py:
    159-162), which is also what torch.bmm over the dense blocks does;
    `useful` at 2 nnz H, nnz the call's live edges (duplicates counted)."""
    flops: int = 0
    edges: list = dataclasses.field(default_factory=list)  # (nnz, H)

    def add(self, S: int, P: int, H: int, nnz: torch.Tensor):
        """A call; nnz a 0-d tensor, read only by `useful`."""
        self.flops += 2 * S * P * P * H
        self.edges.append((nnz, H))

    @property
    def useful(self) -> int:
        return sum(2 * int(nnz) * H for nnz, H in self.edges)


tally = None   # the AggregationWork of the active count_aggregation


@contextlib.contextmanager
def count_aggregation():
    """Within the block, every `aggregate_dense` call adds to the yielded
    AggregationWork, and so does its transpose in the backward (a hook on
    the call's output); so does every `sized_spmm.launch`, either
    direction, kernel or plain version. For counting outside timed runs."""
    global tally
    if tally is not None:
        raise RuntimeError("count_aggregation does not nest")
    tally = AggregationWork()
    try:
        yield tally
    finally:
        tally = None


def densify(edge_src: torch.Tensor, edge_dst: torch.Tensor,
            edge_mask: torch.Tensor, S: int, P: int,
            dtype=torch.float32) -> torch.Tensor:
    """(..., S, P, P) block-diagonal adjacency: A[s, v, u] = 1 for each edge
    (u -> v) inside block s (flat slots s*P+u, s*P+v). Leading dims of the
    (..., E) edge arrays carry over (one adjacency per task). Duplicate edges
    accumulate. Real edges never cross blocks (extraction is per subgraph),
    so src // P == dst // P for them; their source index is clamped into
    the block all the same.

    Edges with mask 0, such as the pad edges (src 0, dst S*P-1), add 0, and
    each adds it to a cell of its own (edge e of its task's adjacency into
    cell e mod S*P*P), wherever its endpoints point: all pads of a set
    share one (dst, src) pair, and on a CUDA tensor adds into one cell run
    one after another. The values are the integers 0 and 1, so their sums
    are exact in float32 and bf16 in any order, and `scatter_add_`'s
    unordered adds give JAX's `densify` bit for bit. No host sync."""
    lead = edge_dst.shape[:-1]
    n_lead = 1
    for d in lead:
        n_lead *= d
    edge_src = edge_src.reshape(n_lead, -1).long()
    edge_dst = edge_dst.reshape(n_lead, -1).long()
    edge_mask = edge_mask.reshape(n_lead, -1)
    device = edge_dst.device
    sid = edge_dst // P
    dst_l = edge_dst - sid * P
    src_l = (edge_src - sid * P).clamp(0, P - 1)
    block = S * P * P
    lead_id = torch.arange(n_lead, device=device)[:, None]
    flat = lead_id * block + (sid * P + dst_l) * P + src_l
    own = lead_id * block + torch.arange(edge_dst.shape[-1],
                                         device=device) % block
    flat = torch.where(edge_mask != 0, flat, own)
    A = torch.zeros(n_lead * block, dtype=dtype, device=device)
    A.scatter_add_(0, flat.reshape(-1), edge_mask.reshape(-1).to(dtype))
    return A.view(*lead, S, P, P)


def aggregate_dense(A: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out[s, v] = sum_u A[s, v, u] * h[s, u] over full (P, P) blocks:
    a batched matmul, which the JAX package also leaves to its compiler.
    A: (S, P, P), h: (S, P, H). Accumulates in float32 and returns float32,
    as the reference's preferred_element_type does. Its backward's
    product runs in an `agg` span too (hooks on its autograd node)."""
    with span("agg"):
        if A.dtype == torch.float32 and h.dtype == torch.float32:
            out = torch.bmm(A, h)
        else:
            out = torch.bmm(A.float(), h.float())
    bracket(out, "agg")
    if tally is not None:
        work, (S, P, H) = tally, h.shape
        nnz = A.sum(dtype=torch.float64)
        work.add(S, P, H, nnz)
        if out.requires_grad:
            out.register_hook(lambda g: work.add(S, P, H, nnz))
    return out


def degrees_from_dense(A: torch.Tensor) -> torch.Tensor:
    """(..., S, P) in-degrees — DGL `in_degrees()` (learner.py:29)."""
    return A.sum(dim=-1)


# --- path 2: edge-list segment-sum (the oracle) -----------------------------

def in_degrees(edge_dst: torch.Tensor, edge_mask: torch.Tensor,
               num_nodes: int) -> torch.Tensor:
    """(num_nodes,) in-degrees of an edge list. Padding edges carry mask 0."""
    out = torch.zeros(num_nodes, dtype=edge_mask.dtype,
                      device=edge_mask.device)
    return out.index_add_(0, edge_dst.long(), edge_mask)


def aggregate(h: torch.Tensor, edge_src: torch.Tensor, edge_dst: torch.Tensor,
              edge_mask: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """out[v] = sum_{(u->v)} h[u]; no self-loop is added (the reference's
    GraphConv aggregates only over existing edges, learner.py:38-45)."""
    msgs = h[edge_src.long()] * edge_mask[:, None].to(h.dtype)
    out = torch.zeros((num_nodes,) + tuple(h.shape[1:]), dtype=h.dtype,
                      device=h.device)
    return out.index_add(0, edge_dst.long(), msgs)


# --- path 3: ELLPACK gather --------------------------------------------------

def build_ell(edge_src: np.ndarray, edge_dst: np.ndarray, num_nodes: int,
              row_cap: int = 16, pad_to: int = 8):
    """Host-side: an edge list -> ELL slabs, bit-equal to the JAX
    package's `build_ell`.

    Returns (nbr, mask, row_id) where nbr: (R, row_cap) int32 gather indices
    into the feature table (pad: 0), mask: (R, row_cap) float32, row_id: (R,)
    int32 destination row of each slab. R >= num_nodes; slab r accumulates
    into row_id[r] (rows with > row_cap in-edges own several slabs)."""
    edge_src = np.asarray(edge_src, dtype=np.int64)
    edge_dst = np.asarray(edge_dst, dtype=np.int64)
    deg = np.bincount(edge_dst, minlength=num_nodes)
    slabs_per_row = np.maximum(1, -(-deg // row_cap))
    R = int(slabs_per_row.sum())
    R_pad = ((R + pad_to - 1) // pad_to) * pad_to

    nbr = np.zeros((R_pad, row_cap), np.int32)
    mask = np.zeros((R_pad, row_cap), np.float32)
    row_id = np.zeros(R_pad, np.int32)
    slab_start = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(slabs_per_row, out=slab_start[1:])

    # slab of edge e = slab_start[dst] + rank_within_dst // row_cap
    order = np.argsort(edge_dst, kind="stable")
    src_s, dst_s = edge_src[order], edge_dst[order]
    csr_start = np.zeros(num_nodes + 1, np.int64)
    np.cumsum(deg, out=csr_start[1:])
    rank = np.arange(len(dst_s)) - csr_start[dst_s]
    slab = slab_start[dst_s] + rank // row_cap
    col = rank % row_cap
    nbr[slab, col] = src_s
    mask[slab, col] = 1.0
    # row ids for every slab (empty rows keep one slab each)
    row_id[:R] = np.repeat(np.arange(num_nodes, dtype=np.int32),
                           slabs_per_row)
    row_id[R:] = num_nodes - 1 if num_nodes else 0  # pad slabs: mask all-zero
    return nbr, mask, row_id


def aggregate_ell(h: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor,
                  row_id: torch.Tensor, num_nodes: int) -> torch.Tensor:
    """out[row_id[r]] += sum_k h[nbr[r, k]] * mask[r, k]."""
    slab_sum = torch.einsum("rkh,rk->rh", h[nbr.long()], mask.to(h.dtype))
    out = torch.zeros((num_nodes, h.shape[1]), dtype=h.dtype, device=h.device)
    return out.index_add(0, row_id.long(), slab_sum)


# --- SDDMM + weighted SpMM (the DGL autograd kernel triple) ------------------

def sddmm(g_out: torch.Tensor, h: torch.Tensor, edge_src: torch.Tensor,
          edge_dst: torch.Tensor, edge_mask: torch.Tensor) -> torch.Tensor:
    """values[e] = <g_out[dst_e], h[src_e]> for each edge, masked."""
    return ((g_out[edge_dst.long()] * h[edge_src.long()]).sum(-1)
            * edge_mask)


class _AggregateWeighted(torch.autograd.Function):
    """out = out_rows + sum_{(u->v)} w_e * h[u], with the JAX custom_vjp's
    backward: d/dh by SpMM^T (scatter g back along the reversed edges), d/dw
    by SDDMM at the existing edges, and no gradient for out_rows (the JAX
    rule returns zeros for it). The backward is written in differentiable
    ops, so a double backward works."""

    @staticmethod
    def forward(ctx, h, w, edge_src, edge_dst, edge_mask, out_rows):
        ctx.save_for_backward(h, w, edge_src, edge_dst, edge_mask)
        msgs = h[edge_src.long()] * (w * edge_mask)[:, None]
        return out_rows.index_add(0, edge_dst.long(), msgs)

    @staticmethod
    def backward(ctx, g):
        h, w, edge_src, edge_dst, edge_mask = ctx.saved_tensors
        dh = torch.zeros_like(h).index_add(
            0, edge_src.long(), (w * edge_mask)[:, None] * g[edge_dst.long()])
        dw = sddmm(g, h, edge_src, edge_dst, edge_mask)
        return dh, dw, None, None, None, None


def aggregate_weighted(h, w, edge_src, edge_dst, edge_mask, out_rows):
    """out[v] = out_rows[v] + sum_{(u->v)} w_e * h[u]; out_rows is a zeros
    template of the output shape, as in the JAX package."""
    return _AggregateWeighted.apply(h, w, edge_src, edge_dst, edge_mask,
                                    out_rows)
