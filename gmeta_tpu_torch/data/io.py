"""Dataset IO: the reference's on-disk contract plus a native format.

On-disk contract (G-Meta/README.md:188-203, loaded at train.py:41-53 and
subgraph_data_processing.py:36-40,119-148):
  - graph_dgl.pkl : list of DGL graphs (needs dgl to unpickle; we also accept
    a native `graphs.npz` with CSR arrays, and provide a converter)
  - features.npy  : object array of per-graph feature matrices (2-D = single
    graph, auto-wrapped like train.py:63-65)
  - label.pkl     : dict 'G_N' -> label (nodes) or 'G_U_V' -> {0,1} (edges)
  - {train,val,test}.csv (+ _spt/_qry variants in link-pred mode); data rows
    are (row_idx, name, label) — loadCSV reads row[1], row[2]
    (subgraph_data_processing.py:127-131)
Tissue-PPI task_mode nests label/csv files under root/task{n}/ (train.py:50-51).
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Dict, List, Tuple

import numpy as np

from gmeta_tpu_torch.data.graph import CSRGraph, GraphStore


class SplitIndex:
    """Parsed episode index of one CSV split: the three dicts of
    subgraph_data_processing.py:119-148 (label->names, graph->names,
    graph->label->names), preserving file order.
    """

    def __init__(self, rows: List[Tuple[str, str]]):
        self.dictLabels: Dict[str, List[str]] = {}
        self.dictGraphs: Dict[int, List[str]] = {}
        self.dictGraphsLabels: Dict[int, Dict[str, List[str]]] = {}
        for name, label in rows:
            g_idx = int(name.split("_")[0])
            self.dictGraphs.setdefault(g_idx, []).append(name)
            self.dictGraphsLabels.setdefault(g_idx, {}).setdefault(label, []).append(name)
            self.dictLabels.setdefault(label, []).append(name)


def load_csv_index(path: str) -> SplitIndex:
    rows = []
    with open(path) as f:
        reader = csv.reader(f, delimiter=",")
        next(reader, None)  # header, skipped like subgraph_data_processing.py:126
        for row in reader:
            rows.append((row[1], row[2]))
    return SplitIndex(rows)


def parse_name(name: str) -> Tuple[int, ...]:
    """'G_N' -> (G, N); 'G_U_V' -> (G, U, V)."""
    return tuple(int(p) for p in name.split("_"))


def load_labels(path: str) -> Dict[str, int]:
    with open(path, "rb") as f:
        info = pickle.load(f)
    # Label values may be numpy ints / strings; normalise to python int where
    # possible (the reference uses them verbatim as class ids, meta.py:35,60).
    return {str(k): int(v) for k, v in info.items()}


def load_features(path: str) -> List[np.ndarray]:
    feat = np.load(path, allow_pickle=True)
    if feat.ndim == 2:  # single graph auto-wrap (train.py:63-65)
        return [np.asarray(feat, dtype=np.float32)]
    return [np.asarray(f, dtype=np.float32) for f in feat]


def save_graphs_npz(path: str, graphs: List[CSRGraph]) -> None:
    arrays = {}
    for i, g in enumerate(graphs):
        arrays[f"indptr_{i}"] = g.indptr
        arrays[f"indices_{i}"] = g.indices
    arrays["num_graphs"] = np.array(len(graphs))
    np.savez_compressed(path, **arrays)


def load_graphs_npz(path: str) -> List[CSRGraph]:
    z = np.load(path)
    n = int(z["num_graphs"])
    return [CSRGraph(indptr=z[f"indptr_{i}"], indices=z[f"indices_{i}"])
            for i in range(n)]


def _csr_from_dgl(dgl_graphs) -> List[CSRGraph]:
    """CSRGraphs of unpickled DGL graphs. Edge direction is preserved
    exactly: CSR row v lists the sources of v's in-edges, i.e. DGL's
    `G.in_edges(v)[0]`."""
    out = []
    for G in dgl_graphs:
        src, dst = G.all_edges()
        out.append(CSRGraph.from_edges(
            np.asarray(src), np.asarray(dst), G.number_of_nodes()))
    return out


def convert_dgl_pickle(pkl_path: str, out_path: str) -> None:
    """Convert the reference's graph_dgl.pkl into native graphs.npz.

    Unpickling needs dgl (and torch) at conversion time only, and dgl is
    imported by pickle, never by this module; the training path never
    touches DGL."""
    with open(pkl_path, "rb") as f:
        dgl_graphs = pickle.load(f)
    save_graphs_npz(out_path, _csr_from_dgl(dgl_graphs))


def load_graph_list(root: str) -> List[CSRGraph]:
    npz = os.path.join(root, "graphs.npz")
    if os.path.exists(npz):
        return load_graphs_npz(npz)
    pkl = os.path.join(root, "graph_dgl.pkl")
    if os.path.exists(pkl):
        try:
            import dgl  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                f"{pkl} needs dgl to unpickle. Run "
                "gmeta_tpu_torch.data.io.convert_dgl_pickle on a machine "
                "with dgl to produce graphs.npz, or provide graphs.npz "
                "directly."
            ) from e
        with open(pkl, "rb") as f:
            return _csr_from_dgl(pickle.load(f))
    raise FileNotFoundError(f"no graphs.npz or graph_dgl.pkl under {root}")


class Dataset:
    """A loaded dataset directory: store + labels + per-split episode indices."""

    def __init__(self, root: str, task_setup: str, link_pred_mode: bool,
                 task_mode: bool = False, task_n: int = 1):
        # Graph/feature files may live one level up when `root` is a fold
        # subdirectory (node_process.py:82-99 writes csvs under fold{n}/ but
        # graphs at the top level).
        graph_root = root
        if not (os.path.exists(os.path.join(graph_root, "graphs.npz"))
                or os.path.exists(os.path.join(graph_root, "graph_dgl.pkl"))):
            parent = os.path.dirname(os.path.abspath(root))
            if (os.path.exists(os.path.join(parent, "graphs.npz"))
                    or os.path.exists(os.path.join(parent, "graph_dgl.pkl"))):
                graph_root = parent
        self.graphs = load_graph_list(graph_root)
        self.feature_list = load_features(os.path.join(graph_root, "features.npy"))
        self.store = GraphStore(self.graphs, self.feature_list)
        # task_mode rewrites the root for labels/CSVs only; the graphs and
        # features stay at the top level (train.py:41-53).
        if task_setup == "Shared" and task_mode:
            root = os.path.join(root, f"task{task_n}")
        self.root = root
        self.labels = load_labels(os.path.join(root, "label.pkl"))
        self.total_class = len(np.unique(np.array(list(self.labels.values()))))
        self.link_pred_mode = link_pred_mode
        self.splits = {}
        for mode in ("train", "val", "test"):
            entry = {"main": load_csv_index(os.path.join(root, f"{mode}.csv"))}
            if link_pred_mode:
                entry["spt"] = load_csv_index(os.path.join(root, f"{mode}_spt.csv"))
                entry["qry"] = load_csv_index(os.path.join(root, f"{mode}_qry.csv"))
            self.splits[mode] = entry

    @property
    def feat_dim(self) -> int:
        return self.store.feat_dim
