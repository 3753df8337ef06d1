"""Device-side h-hop subgraph extraction: batched frontier expansion with
fixed-width tensors over CSR arrays on the device.

Counterpart of gmeta_tpu/data/device_extract.py, in PyTorch: a batch of C
centers is expanded at once with nothing but fixed-shape gathers, sorts and
segment arithmetic. Per center (rows of (C, width) tensors):

1. frontier expansion, h rounds: members is a fixed-width sorted id array
   (pad = V). Each round gathers the concatenated in-neighbor lists of all
   current members through one segmented gather (cumsum + searchsorted over
   a flat edge budget), then unions them in by a sort and a dedup. Matches
   {i} ∪ N(i) ∪ ... ∪ N^h(i) exactly, the oracle's set (data/extract.py).
2. node cap: if the set exceeds `sample_nodes`, keep a uniform random
   subset with the center(s) pinned into it (uniform scores from the
   extractor's `torch.Generator`, +2 on the centers, top-k). The kept set
   has exactly `sample_nodes` nodes; membership follows the uniform law
   without replacement, but no host engine draws the same bits.
3. induced edges: one more segmented gather of the selected nodes' CSR
   rows, membership test by binary search into the sorted parent list,
   fixed-shape compaction. Emission order is the host oracle's (dst-major,
   CSR order within a row), so uncapped extractions are BIT-EQUAL to
   data/extract.py and to the native engine.

Link-prediction tasks need the union of both endpoints' 2-hop
neighborhoods: seeding the member set with both centers and running 2
rounds gives exactly that union.

Every shape is static; overflow of any budget (full-set width, gather
budget, edge budget, output width) is returned as a per-center flag, and
`extract_batch` raises on it rather than truncating. The budgets times the
number of centers per pass set the memory: about 11 MB per center at the
default budgets (int64 ids), so `chunk` centers go through at a time. The
default, 256, is the knee measured on an H100 at arxiv scale: 94% of the
rate of 1024 centers per pass at 38% of its peak memory (PERF.md).

STATUS — a correctness oracle, as in the JAX package, not the production
extractor: build_datasets does not use it. Extraction is pointer-chasing,
and the threaded C++ engine (data/native.py) is the production path.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from gmeta_tpu_torch.data.extract import Subgraph
from gmeta_tpu_torch.data.graph import CSRGraph
from gmeta_tpu_torch.utils.device import resolve_device


class DeviceSubgraphs(NamedTuple):
    """One extracted batch, on the device. Pad node id = V (sentinel)."""
    parents: torch.Tensor        # (C, P) int64 sorted global ids (pad: V)
    n_nodes: torch.Tensor        # (C,)
    n_full: torch.Tensor         # (C,) size of the h-hop set before the cap
    centers_local: torch.Tensor  # (C, n_c) local index of each center
    edge_src: torch.Tensor       # (C, E_out) local (pad: 0)
    edge_dst: torch.Tensor       # (C, E_out) local, nondecreasing (pad P-1)
    edge_mask: torch.Tensor      # (C, E_out) float32
    n_edges: torch.Tensor        # (C,)
    overflow: torch.Tensor       # (C,) bool — any budget exceeded


def _segmented_gather(indptr, indices, nodes, budget, V):
    """Concatenated in-neighbor lists of each row of `nodes` (C, W) (pad
    id V: no neighbors), flattened into a fixed `budget`-wide window per
    row. Returns (cand ids (C, budget) with pad V, owner slot (C, budget),
    valid (C, budget), total real entries (C,))."""
    C, W = nodes.shape
    valid_n = nodes < V
    safe = torch.where(valid_n, nodes, 0)
    starts = indptr[safe]
    degs = torch.where(valid_n, indptr[safe + 1] - starts, 0)
    cum = torch.cumsum(degs, dim=1)
    total = cum[:, -1]
    j = torch.arange(budget, device=nodes.device).expand(C, budget)
    owner = torch.searchsorted(cum, j.contiguous(), right=True)
    owner = owner.clamp(max=W - 1)
    prev = torch.where(owner > 0, cum.gather(1, (owner - 1).clamp(min=0)), 0)
    pos = starts.gather(1, owner) + (j - prev)
    valid = j < total.clamp(max=budget)[:, None]
    if indices.numel():
        cand = indices[pos.clamp(0, indices.numel() - 1)]
    else:
        cand = torch.full_like(pos, V)
    cand = torch.where(valid, cand, V)
    return cand, owner, valid, total


def _compact(values, keep, width, fill):
    """The kept entries of each row of `values`, in order, left-aligned in
    a (C, width) tensor padded with `fill` (entries past `width` are
    dropped; callers flag that)."""
    C = values.shape[0]
    pos = torch.cumsum(keep, dim=1) - 1
    dest = torch.where(keep & (pos < width), pos, width)   # width: discard
    out = torch.full((C, width + 1), fill, dtype=values.dtype,
                     device=values.device)
    out.scatter_(1, dest, values)
    return out[:, :width]


def _union_sorted(members, cand, width, V):
    """Sort-based dedup union of two padded id arrays (C, *) -> (sorted
    padded (C, width), true count (C,)). Pad id V sorts to the tail."""
    s = torch.sort(torch.cat([members, cand], dim=1), dim=1).values
    fresh = torch.ones_like(s, dtype=torch.bool)
    fresh[:, 1:] = s[:, 1:] != s[:, :-1]
    fresh &= s < V
    return _compact(s, fresh, width, V).contiguous(), fresh.sum(dim=1)


class DeviceExtractor:
    """Extraction of many centers at once on a device, with the same output
    type as the host paths.

    Runs on CUDA unless the caller names another device (`device="cpu"`).
    `extract_arrays` keeps the results on the device; `extract_batch`
    materializes host `Subgraph`s and raises where a budget overflowed.
    The cap draws its scores from a `torch.Generator` on the device, seeded
    by `seed` and advanced by every call."""

    def __init__(self, g: CSRGraph, h: int, sample_nodes: int, *,
                 n_centers: int = 1, seed: int = 0, device=None,
                 chunk: int = 256, set_cap: int = 1 << 15,
                 hop_budget: int = 1 << 17, edge_budget: int = 1 << 16,
                 edge_out: int = 1 << 14):
        self.device = resolve_device(device)
        self.V = g.num_nodes
        self.h = h
        self.n_centers = n_centers
        self.sample_nodes = sample_nodes
        self.P = sample_nodes + n_centers
        if set_cap < self.P:
            raise ValueError(
                f"set_cap ({set_cap}) must hold at least sample_nodes + "
                f"n_centers ({self.P}) ids — it bounds the FULL pre-cap "
                f"h-hop set")
        self.chunk = chunk
        self.set_cap, self.hop_budget = set_cap, hop_budget
        self.edge_budget, self.edge_out = edge_budget, edge_out
        self.indptr = torch.as_tensor(g.indptr, dtype=torch.int64).to(
            self.device)
        self.indices = torch.as_tensor(g.indices, dtype=torch.int64).to(
            self.device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def _extract(self, centers: torch.Tensor) -> DeviceSubgraphs:
        C, nc = centers.shape
        V, P, dev = self.V, self.P, self.device
        indptr, indices = self.indptr, self.indices
        members = torch.full((C, self.set_cap), V, dtype=torch.int64,
                             device=dev)
        members[:, :nc] = torch.sort(centers, dim=1).values
        count = torch.full((C,), nc, dtype=torch.int64, device=dev)
        over = torch.zeros(C, dtype=torch.bool, device=dev)

        for _ in range(self.h):
            cand, _, _, total = _segmented_gather(
                indptr, indices, members, self.hop_budget, V)
            over |= total > self.hop_budget
            members, count = _union_sorted(members, cand, self.set_cap, V)
            over |= count > self.set_cap

        # cap: uniform scores, +2 pins the centers into the kept set
        u = torch.rand(members.shape, generator=self.gen, device=dev)
        scores = torch.where(members < V, u, -torch.inf)
        pos_c = torch.searchsorted(members, centers).clamp(
            max=self.set_cap - 1)
        scores.scatter_add_(1, pos_c, torch.full(pos_c.shape, 2.0,
                                                 device=dev))
        keep_n = count.clamp(max=self.sample_nodes).clamp(min=nc)
        sel = torch.topk(scores, P, dim=1).indices
        slot = torch.arange(P, device=dev)
        ids = torch.where(slot < keep_n[:, None], members.gather(1, sel), V)
        parents = torch.sort(ids, dim=1).values
        centers_local = torch.searchsorted(parents, centers)

        # induced edges: gather the selected rows, keep edges whose source
        # is also selected; dst slot = row owner (parents are sorted, so
        # dst is nondecreasing — the host oracle's emission order)
        cand, owner, valid_e, total = _segmented_gather(
            indptr, indices, parents, self.edge_budget, V)
        over |= total > self.edge_budget
        src_pos = torch.searchsorted(parents, cand).clamp(max=P - 1)
        keep = valid_e & (parents.gather(1, src_pos) == cand)
        n_edges = keep.sum(dim=1)
        over |= n_edges > self.edge_out
        e_src = _compact(src_pos, keep, self.edge_out, 0)
        e_dst = _compact(owner, keep, self.edge_out, P - 1)
        e_valid = (torch.arange(self.edge_out, device=dev)
                   < n_edges.clamp(max=self.edge_out)[:, None])
        return DeviceSubgraphs(
            parents=parents, n_nodes=keep_n, n_full=count,
            centers_local=centers_local, edge_src=e_src, edge_dst=e_dst,
            edge_mask=e_valid.float(), n_edges=n_edges, overflow=over)

    def extract_arrays(self, centers) -> DeviceSubgraphs:
        """Centers (C,) or (C, n_centers) -> DeviceSubgraphs on the device,
        `chunk` centers per pass."""
        centers = torch.as_tensor(np.asarray(centers, np.int64)).reshape(
            -1, self.n_centers).to(self.device)
        parts = [self._extract(centers[i:i + self.chunk])
                 for i in range(0, centers.shape[0], self.chunk)]
        return DeviceSubgraphs(*(torch.cat(f) for f in zip(*parts)))

    def extract_batch(self, centers) -> List[Subgraph]:
        out = DeviceSubgraphs(*(x.cpu().numpy()
                                for x in self.extract_arrays(centers)))
        if out.overflow.any():
            raise OverflowError(
                f"{int(out.overflow.sum())} centers exceeded a static "
                "budget; raise set_cap/hop_budget/edge_budget/edge_out or "
                "route these centers to the host extractor")
        subs = []
        for c in range(out.parents.shape[0]):
            n, e = int(out.n_nodes[c]), int(out.n_edges[c])
            subs.append(Subgraph(
                parents=out.parents[c, :n],
                centers=out.centers_local[c].astype(np.int32),
                edge_src=out.edge_src[c, :e].astype(np.int32),
                edge_dst=out.edge_dst[c, :e].astype(np.int32)))
        return subs
