"""ctypes bindings for the native extraction engine (csrc/extract.cpp).

Counterpart of gmeta_tpu/data/native.py: the same C ABI and classes, over
the port's own copy of the C++ source, which `ops/cuda_build.build_host`
compiles with g++ at first use into build/gmeta_tpu_torch/. Same outputs as
the numpy oracle (data/extract.py) where no cap applies; under the cap,
each subgraph's sampling stream is derived from its name's content, so a
result does not depend on extraction order, batching or threads, and the
JAX package's engine gives the same bits.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Sequence

import numpy as np

from gmeta_tpu_torch.data.extract import Subgraph
from gmeta_tpu_torch.data.graph import CSRGraph
from gmeta_tpu_torch.ops import cuda_build

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)


def _lib() -> ctypes.CDLL:
    """The engine's library, built at first use, with its signatures."""
    lib = cuda_build.load_host("extract")
    lib.gx_new.restype = ctypes.c_void_p
    lib.gx_new.argtypes = []
    lib.gx_free.argtypes = [ctypes.c_void_p]
    lib.gx_add_graph.argtypes = [ctypes.c_void_p, _i64p, _i32p,
                                 ctypes.c_int64, ctypes.c_int64]
    lib.gx_extract_batch.argtypes = [
        ctypes.c_void_p, _i64p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_uint64, ctypes.c_int32, ctypes.c_int32,
        _i64p]
    lib.gx_result_sizes.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    _i64p, _i64p, _i64p]
    lib.gx_result_fetch.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    _i64p, _i32p, _i32p, _i32p]
    lib.gx_clear_results.argtypes = [ctypes.c_void_p]
    for f in ("gx_free", "gx_add_graph", "gx_extract_batch",
              "gx_result_sizes", "gx_result_fetch", "gx_clear_results"):
        getattr(lib, f).restype = None
    return lib


def available() -> bool:
    """Whether the engine is built or buildable here. Its library is named
    by the compiler's version, so both take g++ on PATH."""
    return cuda_build.host_compiler() is not None


class NativeEngine:
    """Owns a C++ engine with the graph set loaded once."""

    def __init__(self, graphs: Sequence[CSRGraph], n_threads: int = 0):
        self._lib = _lib()
        self._h = self._lib.gx_new()
        self.n_threads = n_threads or (os.cpu_count() or 4)
        self._sizes = [g.num_nodes for g in graphs]
        self._keepalive = []
        for g in graphs:
            indptr = np.ascontiguousarray(g.indptr, dtype=np.int64)
            indices = np.ascontiguousarray(g.indices, dtype=np.int32)
            self._keepalive.append((indptr, indices))
            self._lib.gx_add_graph(
                self._h, indptr.ctypes.data_as(_i64p),
                indices.ctypes.data_as(_i32p),
                ctypes.c_int64(g.num_nodes), ctypes.c_int64(g.num_edges))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.gx_free(self._h)
            self._h = None

    def _check(self, items: np.ndarray) -> None:
        """The engine indexes without bounds checks: refuse rows that name
        a graph or node that is not there."""
        if items.ndim != 2 or items.shape[1] != 3:
            raise ValueError(f"items must be (N, 3), got {items.shape}")
        if not len(items):
            return
        g = items[:, 0]
        if g.min() < 0 or g.max() >= len(self._sizes):
            raise ValueError(
                f"graph index out of range 0..{len(self._sizes) - 1}")
        n = np.asarray(self._sizes, np.int64)[g]
        c2 = items[:, 2]
        if ((items[:, 1] < 0) | (items[:, 1] >= n) | (c2 < -1)
                | (c2 >= n)).any():
            raise ValueError("center out of range of its graph")

    def extract_batch(self, items: np.ndarray, hops: int, sample_nodes: int,
                      seed: int = 222,
                      cap_strategy: str = "uniform") -> List[Subgraph]:
        """items: (N, 3) int64 rows (graph, center1, center2 or -1)."""
        items = np.ascontiguousarray(items, dtype=np.int64)
        self._check(items)
        n = len(items)
        ids = np.zeros(n, dtype=np.int64)
        self._lib.gx_extract_batch(
            self._h, items.ctypes.data_as(_i64p), ctypes.c_int64(n),
            ctypes.c_int32(hops), ctypes.c_int64(sample_nodes),
            ctypes.c_uint64(seed),
            ctypes.c_int32(1 if cap_strategy == "degree" else 0),
            ctypes.c_int32(self.n_threads),
            ids.ctypes.data_as(_i64p))
        out = []
        nn = np.zeros(1, np.int64)
        ne = np.zeros(1, np.int64)
        nc = np.zeros(1, np.int64)
        for i in range(n):
            self._lib.gx_result_sizes(
                self._h, ctypes.c_int64(ids[i]),
                nn.ctypes.data_as(_i64p), ne.ctypes.data_as(_i64p),
                nc.ctypes.data_as(_i64p))
            parents = np.zeros(int(nn[0]), np.int64)
            centers = np.zeros(int(nc[0]), np.int32)
            esrc = np.zeros(int(ne[0]), np.int32)
            edst = np.zeros(int(ne[0]), np.int32)
            self._lib.gx_result_fetch(
                self._h, ctypes.c_int64(ids[i]),
                parents.ctypes.data_as(_i64p),
                centers.ctypes.data_as(_i32p),
                esrc.ctypes.data_as(_i32p), edst.ctypes.data_as(_i32p))
            out.append(Subgraph(parents=parents, centers=centers,
                                edge_src=esrc, edge_dst=edst))
        self._lib.gx_clear_results(self._h)
        return out


class NativeSubgraphExtractor:
    """API-compatible with extract.SubgraphExtractor, C++-backed, memoized."""

    def __init__(self, graphs: Sequence[CSRGraph], h: int, sample_nodes: int,
                 seed: int = 222, n_threads: int = 0,
                 cap_strategy: str = "uniform"):
        assert cap_strategy in ("uniform", "degree"), cap_strategy
        self.engine = NativeEngine(graphs, n_threads=n_threads)
        self.h = h
        self.sample_nodes = sample_nodes
        self.seed = seed
        self.cap_strategy = cap_strategy
        self.cache = {}

    def extract(self, name: str) -> Subgraph:
        return self.extract_many([name])[0]

    def extract_node(self, g: int, i: int, name: str) -> Subgraph:
        return self.extract_many([f"{g}_{i}"])[0]

    def extract_link(self, g: int, i: int, j: int, name: str) -> Subgraph:
        return self.extract_many([f"{g}_{i}_{j}"])[0]

    def extract_many(self, names: Sequence[str]) -> List[Subgraph]:
        # sorted: a deterministic batch order keeps thread scheduling
        # replayable (results do not depend on it: the per-item RNG is
        # content-derived)
        missing = sorted(n for n in set(names) if n not in self.cache)
        if missing:
            items = np.full((len(missing), 3), -1, dtype=np.int64)
            for k, n in enumerate(missing):
                parts = [int(p) for p in n.split("_")]
                items[k, :len(parts)] = parts
            subs = self.engine.extract_batch(items, self.h, self.sample_nodes,
                                             seed=self.seed,
                                             cap_strategy=self.cap_strategy)
            for n, s in zip(missing, subs):
                self.cache[n] = s
        return [self.cache[n] for n in names]
