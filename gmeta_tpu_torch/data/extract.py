"""h-hop local subgraph extraction (host path).

Replicates the reference's extraction semantics exactly
(subgraph_data_processing.py:294-346) but vectorized over CSR arrays instead
of per-node Python loops over a DGL graph:

- frontier expansion over *in*-neighbors for h in {1,2,3} (:300-311)
- if the neighborhood exceeds `sample_nodes`: uniform downsample without
  replacement, then force-re-add the center(s) (:312-314,337-339)
- `cap_strategy="degree"` replaces the uniform downsample with degree-
  centrality scoring: keep the `sample_nodes` highest in-degree nodes
  (deterministic; ties break by node id). The reference only ever samples
  uniformly — this is the rebuild's centrality-scored extraction mode
  (BASELINE.json north star), off by default for reference parity.
- induced subgraph with nodes relabeled 0..n-1; we fix sorted order (the
  node order is permutation-irrelevant to the GCN math; np.unique already
  sorts in the capped path :314)
- link-pred variant: union of the 2-hop neighborhoods of both endpoints,
  ignoring `h` like the reference (:323-346)
- memoized per name, like `self.subgraphs` (:296-297,319) — but shared
  process-wide instead of silently diverging per DataLoader worker

This is the oracle and the fallback; data/native.py is the threaded C++
engine that `build_datasets` prefers where it can be built.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np

from gmeta_tpu_torch.data.graph import CSRGraph


@dataclasses.dataclass
class Subgraph:
    """One extracted local subgraph, nodes relabeled to 0..n-1 (sorted parents)."""
    parents: np.ndarray       # (n,) int64 sorted parent node ids
    centers: np.ndarray       # (1,) or (2,) int32 local indices of the center(s)
    edge_src: np.ndarray      # (e,) int32 local
    edge_dst: np.ndarray      # (e,) int32 local, nondecreasing

    @property
    def num_nodes(self) -> int:
        return len(self.parents)

    @property
    def num_edges(self) -> int:
        return len(self.edge_src)


class SubgraphExtractor:
    def __init__(self, graphs: Sequence[CSRGraph], h: int, sample_nodes: int,
                 seed: int = 222, cap_strategy: str = "uniform"):
        assert cap_strategy in ("uniform", "degree"), cap_strategy
        self.graphs = list(graphs)
        self.h = h
        self.sample_nodes = sample_nodes
        self.cap_strategy = cap_strategy
        self.rng = np.random.RandomState(seed)
        self.cache: Dict[str, Subgraph] = {}

    # -- frontier expansion ---------------------------------------------------

    def _neighborhood(self, G: CSRGraph, i: int) -> np.ndarray:
        """Nodes of the h-hop in-neighborhood of i, including i (unsorted-set
        semantics of :300-311; we return sorted unique)."""
        f_hop = G.in_neighbors(i).astype(np.int64)
        if self.h == 1:
            nodes = np.append(f_hop, i)
        elif self.h == 2:
            n2 = G.in_neighbors_of(f_hop).astype(np.int64)
            nodes = np.concatenate([n2, f_hop, [i]])
        else:  # h == 3
            n2 = G.in_neighbors_of(f_hop).astype(np.int64)
            n3 = G.in_neighbors_of(n2).astype(np.int64)
            nodes = np.concatenate([n2, n3, f_hop, [i]])
        return np.unique(nodes)

    def _cap(self, G: CSRGraph, nodes: np.ndarray, centers) -> np.ndarray:
        if len(nodes) > self.sample_nodes:
            if self.cap_strategy == "degree":
                # keep top-sample_nodes by in-degree, ties by node id
                deg = G.in_degrees(nodes)
                order = np.lexsort((nodes, -deg))
                nodes = nodes[order[:self.sample_nodes]]
            else:
                nodes = self.rng.choice(nodes, self.sample_nodes,
                                        replace=False)
            nodes = np.unique(np.append(nodes, centers))
        return nodes

    # -- public API -------------------------------------------------------------

    def extract_node(self, g_idx: int, i: int, name: str) -> Subgraph:
        if name in self.cache:
            return self.cache[name]
        G = self.graphs[g_idx]
        nodes = self._cap(G, self._neighborhood(G, i), [i])
        sub = self._induce(G, nodes, [i])
        self.cache[name] = sub
        return sub

    def extract_link(self, g_idx: int, i: int, j: int, name: str) -> Subgraph:
        """Union of the (always-)2-hop neighborhoods of both endpoints
        (subgraph_data_processing.py:323-339 hardcodes 2 hops)."""
        if name in self.cache:
            return self.cache[name]
        G = self.graphs[g_idx]

        def two_hop(c):
            f_hop = G.in_neighbors(c).astype(np.int64)
            n2 = G.in_neighbors_of(f_hop).astype(np.int64)
            return np.unique(np.concatenate([n2, f_hop, [c]]))

        nodes = np.union1d(two_hop(i), two_hop(j))
        nodes = self._cap(G, nodes, [i, j])
        sub = self._induce(G, nodes, [i, j])
        self.cache[name] = sub
        return sub

    def extract(self, name: str) -> Subgraph:
        parts = [int(p) for p in name.split("_")]
        if len(parts) == 2:
            return self.extract_node(parts[0], parts[1], name)
        return self.extract_link(parts[0], parts[1], parts[2], name)

    # -- induced subgraph -------------------------------------------------------

    @staticmethod
    def _induce(G: CSRGraph, nodes: np.ndarray, centers) -> Subgraph:
        nodes = np.asarray(nodes, dtype=np.int64)
        src, dst = G.induced_edges(nodes)
        center_local = np.searchsorted(nodes, np.asarray(centers, dtype=np.int64))
        return Subgraph(parents=nodes,
                        centers=center_local.astype(np.int32),
                        edge_src=src, edge_dst=dst)
