"""Static-shape packing of ragged subgraph batches.

The reference packs a task's subgraphs with `dgl.batch` into one ragged
block-diagonal graph (subgraph_data_processing.py:399-400) — the one idea
that does not batch into fixed-shape tensors. Here each task
set (support or query) is BIN-PACKED into B dense blocks of P node slots:
subgraphs are placed first-fit-decreasing into bins of capacity P (a bucketed
bound on subgraph size; the reference's own `sample_nodes` cap,
subgraph_data_processing.py:312-314, guarantees P <= ~sample_nodes), several
small subgraphs sharing one bin.

The binned layout makes aggregation a batched matrix product: the packed
adjacency is block-diagonal over bins (edges never cross subgraphs, so they
never cross bins), so message passing is (B,P,P)@(B,P,H) — see
models/gcn.py — and B ~= ceil(sum n_k / P) instead of one P-slot per
subgraph, so FLOPs and device bytes scale with TOTAL nodes, not
S * max-size. The edge lists below are densified into A ONCE per task (a
scalar scatter outside the inner loop), not per GCN layer; the size-aware
path (ops/sized_spmm) instead sorts them into CSRs once per task and builds
no A.

Padding contract:
- pad node slots: gid 0, node_mask 0
- pad edges: src 0, dst B*P-1, edge_mask 0 (dst=B*P-1 keeps dst nondecreasing
  within each bin's range so the segment_sum oracle path can use
  indices_are_sorted)
- pad bins (beyond the last used bin, up to a split-global B): all zeros
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import numpy as np

from gmeta_tpu_torch.data.extract import Subgraph
from gmeta_tpu_torch.data.graph import GraphStore


class SubgraphSet(NamedTuple):
    """One packed set of S subgraphs (a task's support or query set).

    Nodes live in B bins of P slots; subgraph k occupies a contiguous slot
    range inside exactly one bin. Leaves are numpy on the host, torch tensors
    on the device; a leading task axis is added by stack_tasks. B and P are
    node_gid.shape[-2:]; S is centers.shape[-2].
    """
    node_gid: np.ndarray    # (B, P) int32 global feature-table row (pad: 0)
    node_mask: np.ndarray   # (B, P) float32 {0,1}
    edge_src: np.ndarray    # (E,) int32 flat slot index bin*P+i (pad: 0)
    edge_dst: np.ndarray    # (E,) int32 flat slot, nondecreasing (pad: B*P-1)
    edge_mask: np.ndarray   # (E,) float32 {0,1}
    centers: np.ndarray     # (S, 2) int32 flat center slots (col 1 = col 0
                            #   for node tasks; second endpoint for link tasks)
    labels: np.ndarray      # (S,) int32
    bin_fill: np.ndarray = None  # (B,) int32 live node rows per bin (rows
                            #   [0, fill) are real; the rest padding)

    @property
    def num_subgraphs(self) -> int:
        return self.centers.shape[-2]

    @property
    def num_blocks(self) -> int:
        return self.node_gid.shape[-2]

    @property
    def stride(self) -> int:
        return self.node_gid.shape[-1]


class TaskBatch(NamedTuple):
    spt: SubgraphSet
    qry: SubgraphSet


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def ffd_bins(sizes: Sequence[int], P: int) -> List[int]:
    """First-fit-decreasing bin assignment: bin index per subgraph, bins of
    capacity P. Deterministic (stable sort by -size). FFD is within 11/9 of
    the optimal bin count."""
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    fill: List[int] = []
    assign = [0] * len(sizes)
    for i in order:
        n = sizes[i]
        assert n <= P, (n, P)
        for b, f in enumerate(fill):
            if f + n <= P:
                assign[i] = b
                fill[b] += n
                break
        else:
            assign[i] = len(fill)
            fill.append(n)
    return assign


def num_bins(sizes: Sequence[int], P: int) -> int:
    a = ffd_bins(sizes, P)
    return max(a) + 1 if a else 0


def bins_for(sizes: Sequence[int], P: int, one_per_bin: bool = False):
    """The bin of each subgraph: FFD's (`ffd_bins`) or, `one_per_bin`,
    subgraph k in bin k (models/graphormer.py attends over one graph a
    bin)."""
    if not one_per_bin:
        return ffd_bins(sizes, P)
    assert all(n <= P for n in sizes), (max(sizes), P)
    return list(range(len(sizes)))


def pack_set(subs: Sequence[Subgraph], graph_idxs: Sequence[int],
             labels: np.ndarray, store: GraphStore,
             P: int, E: int, B: int = None,
             one_per_bin: bool = False) -> SubgraphSet:
    """Bin-pack S subgraphs into B bins of P node slots with edge budget E:
    first-fit-decreasing or, `one_per_bin`, one subgraph a bin in order.
    B=None uses exactly the bins the placement needs; pass a split-global
    B to get a fixed stackable shape."""
    S = len(subs)
    sizes = [s.num_nodes for s in subs]
    assign = bins_for(sizes, P, one_per_bin)
    need = (max(assign) + 1) if assign else 0
    if B is None:
        B = need
    assert need <= B, (need, B)
    total_edges = sum(s.num_edges for s in subs)
    assert total_edges <= E, (total_edges, E)

    V = B * P
    node_gid = np.zeros((B, P), dtype=np.int32)
    node_mask = np.zeros((B, P), dtype=np.float32)
    edge_src = np.zeros(E, dtype=np.int32)
    edge_dst = np.full(E, V - 1, dtype=np.int32)
    edge_mask = np.zeros(E, dtype=np.float32)
    centers = np.zeros((S, 2), dtype=np.int32)

    # Place subgraphs bin by bin in index order within each bin, so edge_dst
    # stays nondecreasing when emitted bin-major.
    fill = [0] * B
    offsets = [0] * S
    for k in range(S):
        b = assign[k]
        offsets[k] = fill[b]
        fill[b] += sizes[k]

    e_off = 0
    emit_order = sorted(range(S), key=lambda k: (assign[k], offsets[k]))
    for k in emit_order:
        sub, g = subs[k], graph_idxs[k]
        n, e = sub.num_nodes, sub.num_edges
        n_off = assign[k] * P + offsets[k]
        b = assign[k]
        node_gid[b, offsets[k]:offsets[k] + n] = store.global_ids(g, sub.parents)
        node_mask[b, offsets[k]:offsets[k] + n] = 1.0
        edge_src[e_off:e_off + e] = sub.edge_src + n_off
        edge_dst[e_off:e_off + e] = sub.edge_dst + n_off
        edge_mask[e_off:e_off + e] = 1.0
        c = sub.centers
        centers[k, 0] = c[0] + n_off
        centers[k, 1] = (c[1] if len(c) > 1 else c[0]) + n_off
        e_off += e

    return SubgraphSet(node_gid=node_gid, node_mask=node_mask,
                       edge_src=edge_src, edge_dst=edge_dst,
                       edge_mask=edge_mask, centers=centers,
                       labels=np.asarray(labels, dtype=np.int32),
                       bin_fill=np.asarray(fill, dtype=np.int32))


def pack_task(spt_subs, spt_graphs, spt_labels,
              qry_subs, qry_graphs, qry_labels,
              store: GraphStore, P_spt: int, E_spt: int,
              P_qry: int, E_qry: int,
              B_spt: int = None, B_qry: int = None) -> TaskBatch:
    return TaskBatch(
        spt=pack_set(spt_subs, spt_graphs, spt_labels, store, P_spt, E_spt,
                     B=B_spt),
        qry=pack_set(qry_subs, qry_graphs, qry_labels, store, P_qry, E_qry,
                     B=B_qry),
    )


def _stack_set(sets: Sequence[SubgraphSet]) -> SubgraphSet:
    return SubgraphSet(*(None if xs[0] is None else np.stack(xs, axis=0)
                         for xs in zip(*sets)))


def stack_tasks(tasks: List[TaskBatch]) -> TaskBatch:
    """Stack T same-shape tasks into arrays with a leading task axis, field
    by field (numpy only)."""
    return TaskBatch(spt=_stack_set([t.spt for t in tasks]),
                     qry=_stack_set([t.qry for t in tasks]))
