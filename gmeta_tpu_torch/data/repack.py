"""One bin per task: a packed set's live slots repacked on the device, so
that the model computes no pad row.

data/pack.py packs a set's subgraphs into B bins of P slots, and every
layer of a model over the packed set (its products, the GraphConv
epilogue, GAT's attention, the elementwise passes) walks all T*B*P rows.
The records fill 57-59% of the slots. No pad row's output is ever read:
pad slots are no real edge's source, so they reach no real node, and the
readout takes only the centres, so their gradients are exactly zero.

`repack` moves each task's live slots, bin by bin in slot order, to the
front of one bin of M slots, M the largest live count among the step's
tasks (`bin_rows`, from counts the host holds, so nothing waits for the
device). The rest of a task's bin is padding: node mask 0, gid 0 and no
edges. The result is an ordinary packed set with B = 1 and P = M, which
the models, their operands and the kernels take as they take any other.

Slot i of bin b moves to start_b + i, start_b the live slots of the bins
before b. The map is monotone, so every real edge (both endpoints in one
bin) keeps its place in the edge order and every row's in-edges stay in
order: the stable sort of ops/sized_spmm.py `sized_graph` gives each row
the same sequence of terms as before. Pad edges go to src 0 and dst M-1
with mask 0, as data/pack.py places them. Only the CSR path takes this
layout: the dense aggregation multiplies a (P, P) block per bin.

The counts `TALLY` names (utils/metrics.py) add up, from host numbers
only, each repacked set's `slots` before (T*B*P), its `rows` after (T*M)
and its `live` nodes.

`segments` gives the repacked set's ranges of rows that no real edge
leaves, for the GAT's staged attention (ops/gat_attention.py): each
original bin's live rows, then the task's tail of padding in pieces, with
the host's bound on their length.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gmeta_tpu_torch.data.pack import SubgraphSet, TaskBatch, round_up
from gmeta_tpu_torch.utils.metrics import count

ROW_MULTIPLE = 8     # M is rounded up to a multiple of this
TALLY = {"slots": "repack.slots", "rows": "repack.rows", "live": "repack.live"}


def live_counts(bin_fill) -> np.ndarray:
    """Each task's live slots, the sum of its bin fills (..., B) -> (...),
    on the host."""
    return np.asarray(bin_fill, dtype=np.int64).sum(axis=-1)


def bin_rows(live) -> int:
    """M for tasks of `live` live slots: the largest, rounded up to
    ROW_MULTIPLE (at least ROW_MULTIPLE)."""
    return round_up(max(int(np.max(live, initial=0)), 1), ROW_MULTIPLE)


def repack(sg: SubgraphSet, M: int, live) -> SubgraphSet:
    """The set (T, B, P) of device tensors as (T, 1, M): each task's live
    slots in order at the front of its one bin, edges and centres moved
    with them, pad edges at slot M-1 with mask 0. `live` holds the tasks'
    live counts (host), none above M, checked on the host (a task of more
    live slots would spill its edges into the next task's rows). A set
    already in that form is returned as it is. Counted under `TALLY`."""
    T, B, P = sg.node_gid.shape
    live = np.asarray(live)
    if live.shape != (T,) or int(np.max(live, initial=0)) > M:
        raise ValueError(f"live counts of shape {live.shape}, largest "
                         f"{np.max(live, initial=0)}, for {T} tasks of "
                         f"{M} rows")
    count(TALLY["slots"], T * B * P)
    count(TALLY["rows"], T * M)
    count(TALLY["live"], int(np.sum(live)))
    if B == 1 and P == M:
        return sg
    dev = sg.node_gid.device
    fill = sg.bin_fill.long()
    end = torch.cumsum(fill, dim=1)                         # (T, B)
    # new slot = old flat slot + shift[bin]
    shift = end - fill - torch.arange(B, device=dev) * P
    j = torch.arange(M, device=dev).repeat(T, 1)            # (T, M)
    on = j < end[:, -1:]
    b = torch.searchsorted(end, j, right=True).clamp_(max=B - 1)
    old = (j - torch.gather(shift, 1, b)).clamp_(0, B * P - 1)
    node_gid = torch.where(
        on, torch.gather(sg.node_gid.reshape(T, B * P), 1, old), 0)

    # an edge's source clamped into its destination's bin, as sized_graph
    # and densify take it
    real = sg.edge_mask != 0
    e_bin = sg.edge_dst // P
    e_shift = torch.gather(shift, 1, e_bin)
    src = e_bin * P + (sg.edge_src - e_bin * P).clamp(0, P - 1)
    edge_src = torch.where(real, src + e_shift, 0)
    edge_dst = torch.where(real, sg.edge_dst + e_shift, M - 1)
    c = sg.centers
    centers = c + torch.gather(shift, 1, (c // P).reshape(T, -1)).view(
        c.shape)
    return SubgraphSet(
        node_gid=node_gid[:, None], node_mask=on.to(sg.node_mask.dtype)[
            :, None], edge_src=edge_src, edge_dst=edge_dst,
        edge_mask=sg.edge_mask, centers=centers, labels=sg.labels,
        bin_fill=end[:, -1:].to(sg.bin_fill.dtype))


class Segments(NamedTuple):
    """Ranges of a (T, 1, M) set's rows that no real edge leaves: range q
    of task t runs from start[t, q] to start[t, q + 1] (the last to M)."""
    start: torch.Tensor   # (T, n) int32 on the set's device, nondecreasing
    rows: int             # host: no range holds more rows


def segments(bin_fill: torch.Tensor, M: int, fills) -> Segments:
    """The Segments of `repack(sg, M, ...)`, from the set's bin fills
    before the repack, (T, B) on the device and `fills` the same on the
    host: each original bin's live rows (the repack keeps them contiguous,
    in bin order, and edges never leave a bin), then each task's padding
    from its live count to M in pieces of at most `rows` rows, `rows` the
    largest fill (at least 1). Pieces past M are empty. Nothing waits for
    the device."""
    fills = np.asarray(fills, dtype=np.int64)
    if fills.shape != tuple(bin_fill.shape):
        raise ValueError(f"host fills of shape {fills.shape} for a set of "
                         f"{tuple(bin_fill.shape)} bins")
    rows = max(int(fills.max(initial=0)), 1)
    pad = M - int(fills.sum(axis=-1).min(initial=M))
    fill = bin_fill.to(torch.int32)
    end = torch.cumsum(fill, dim=1, dtype=torch.int32)
    start = [end - fill]
    if pad > 0:
        start.append(end[:, -1:] + rows * torch.arange(
            -(-pad // rows), device=fill.device, dtype=torch.int32))
    return Segments(torch.cat(start, dim=1).clamp_(max=M), rows)


def repack_batch(batch: TaskBatch, rows, live) -> TaskBatch:
    """`repack` of both sets: rows = (M_spt, M_qry), live = the tasks'
    (support, query) live counts."""
    return TaskBatch(*(repack(sg, m, n)
                       for sg, m, n in zip(batch, rows, live)))
