"""Offline dataset preparation — the reference's `data_process/` templates as
runnable tools (SURVEY.md L5; node_process.py, link_process.py).

Counterpart of gmeta_tpu/data/prepare.py: the same tools writing the same
files for the same inputs and seed.

Emits the exact on-disk contract of G-Meta/README.md:188-203 that
gmeta_tpu_torch.data.io loads (with native graphs.npz in place of
graph_dgl.pkl):

- node / Disjoint  (node_process.py:26-52): partition the LABEL space into
  train/val/test label sets; one csv per split.
- node / Shared    (node_process.py:82-99): fold-based partition of the
  GRAPH space; per-fold subdirectories fold{n}/.
- link prediction  (link_process.py): per graph, `training_edges_fraction`
  of positive edges -> support pool, rest -> query pool; negative pairs
  sampled degree-proportionally (5*avg_degree candidates per node,
  link_process.py:50-56), deduped, len(edges) of them kept; the
  message-passing graph contains ALL positive edges PLUS the sampled
  negative edges (SEAL-style negative injection, link_process.py:44-47,
  83-87) in a single direction; graph-space split into train/val/test;
  emits {split}.csv, {split}_spt.csv, {split}_qry.csv.

CSV rows are (row_index, name, label) with a header line, matching what
pandas reset_index().to_csv() produced and loadCSV consumes
(subgraph_data_processing.py:126-131).
"""

from __future__ import annotations

import csv
import os
import pickle
from typing import Dict, List, Sequence, Tuple

import numpy as np

from gmeta_tpu_torch.data.graph import CSRGraph
from gmeta_tpu_torch.data.io import save_graphs_npz


def _write_csv(path: str, rows: List[Tuple[str, object]]) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["", "name", "label"])
        w.writerows((i, name, label) for i, (name, label) in enumerate(rows))


def _write_common(out_dir: str, graphs: Sequence[CSRGraph],
                  features: Sequence[np.ndarray],
                  info: Dict[str, int]) -> None:
    os.makedirs(out_dir, exist_ok=True)
    save_graphs_npz(os.path.join(out_dir, "graphs.npz"), list(graphs))
    feats = np.empty(len(features), dtype=object)
    for i, f in enumerate(features):
        feats[i] = np.asarray(f, dtype=np.float32)
    np.save(os.path.join(out_dir, "features.npy"),
            feats if len(features) > 1 else np.asarray(features[0], np.float32))
    with open(os.path.join(out_dir, "label.pkl"), "wb") as f:
        pickle.dump(info, f)


def prepare_node_disjoint(out_dir: str, graphs: Sequence[CSRGraph],
                          features: Sequence[np.ndarray],
                          label_map: Sequence[np.ndarray],
                          num_label_set: int, seed: int = 0) -> None:
    """Disjoint-label split: `num_label_set` labels each for test and val,
    the rest train (node_process.py:35-44)."""
    rng = np.random.RandomState(seed)
    info = {f"{g}_{n}": int(label_map[g][n])
            for g in range(len(graphs)) for n in range(graphs[g].num_nodes)}
    labels = np.unique([v for v in info.values()])
    test_labels = set(rng.choice(labels, num_label_set, replace=False).tolist())
    left = np.array([l for l in labels if l not in test_labels])
    val_labels = set(rng.choice(left, num_label_set, replace=False).tolist())
    _write_common(out_dir, graphs, features, info)
    splits = {"train": lambda y: y not in test_labels and y not in val_labels,
              "val": lambda y: y in val_labels,
              "test": lambda y: y in test_labels}
    for mode, pred in splits.items():
        rows = [(k, v) for k, v in info.items() if pred(v)]
        _write_csv(os.path.join(out_dir, f"{mode}.csv"), rows)


def prepare_node_shared(out_dir: str, graphs: Sequence[CSRGraph],
                        features: Sequence[np.ndarray],
                        label_map: Sequence[np.ndarray],
                        folds: Sequence[Tuple[int, int]]) -> None:
    """Shared-label fold split: fold n holds out (val_graph, test_graph),
    written under out_dir/fold{n+1}/ (node_process.py:82-99). Graph files
    live at the top level; csvs per fold."""
    info = {f"{g}_{n}": int(label_map[g][n])
            for g in range(len(graphs)) for n in range(graphs[g].num_nodes)}
    _write_common(out_dir, graphs, features, info)
    for fold_n, (val_g, test_g) in enumerate(folds):
        fold_dir = os.path.join(out_dir, f"fold{fold_n + 1}")
        os.makedirs(fold_dir, exist_ok=True)
        with open(os.path.join(fold_dir, "label.pkl"), "wb") as f:
            pickle.dump(info, f)
        by = {"train": [], "val": [], "test": []}
        for k, v in info.items():
            g = int(k.split("_")[0])
            mode = "val" if g == val_g else "test" if g == test_g else "train"
            by[mode].append((k, v))
        for mode, rows in by.items():
            _write_csv(os.path.join(fold_dir, f"{mode}.csv"), rows)


def prepare_node_shared_tasks(out_dir: str, graphs: Sequence[CSRGraph],
                              features: Sequence[np.ndarray],
                              task_labels: Sequence[Sequence[np.ndarray]],
                              val_graph: int, test_graph: int) -> None:
    """Tissue-PPI-style multi-task layout: graphs/features at the top level,
    one `task{n}/` subdirectory per task holding that task's label.pkl +
    graph-space split CSVs (train.py:50-51 rewrites the data root to
    root/task{task_n}). `task_labels[t][g]` is graph g's per-node label array
    for task t (binary protein-function labels in the reference dataset —
    params printout implies total_class=2, test.ipynb cell 1)."""
    _write_common(out_dir, graphs, features,
                  {f"{g}_{n}": int(task_labels[0][g][n])
                   for g in range(len(graphs))
                   for n in range(graphs[g].num_nodes)})
    for t, label_map in enumerate(task_labels):
        task_dir = os.path.join(out_dir, f"task{t + 1}")
        os.makedirs(task_dir, exist_ok=True)
        info = {f"{g}_{n}": int(label_map[g][n])
                for g in range(len(graphs))
                for n in range(graphs[g].num_nodes)}
        with open(os.path.join(task_dir, "label.pkl"), "wb") as f:
            pickle.dump(info, f)
        by = {"train": [], "val": [], "test": []}
        for k, v in info.items():
            g = int(k.split("_")[0])
            mode = ("val" if g == val_graph
                    else "test" if g == test_graph else "train")
            by[mode].append((k, v))
        for mode, rows in by.items():
            _write_csv(os.path.join(task_dir, f"{mode}.csv"), rows)


def prepare_link(out_dir: str, pos_edges: Sequence[np.ndarray],
                 num_nodes: Sequence[int],
                 features: Sequence[np.ndarray],
                 training_edges_fraction: float = 0.3,
                 val_frac: float = 0.1, seed: int = 0) -> None:
    """Link-prediction prep per link_process.py. `pos_edges[g]` is an
    (E, 2) array of unique undirected positive pairs of graph g."""
    rng = np.random.RandomState(seed)
    graphs, info = [], {}
    pools: Dict[int, Dict[str, List[Tuple[str, int]]]] = {}

    for g, edges in enumerate(pos_edges):
        edges = np.asarray(edges)
        n, m = int(num_nodes[g]), len(edges)
        k_spt = int(m * training_edges_fraction)
        sampled = rng.choice(m, k_spt, replace=False)
        spt_mask = np.zeros(m, bool)
        spt_mask[sampled] = True

        # degree-proportional negative candidates: 5*avg_degree per node
        # (link_process.py:50-56), deduped against positives and reversals,
        # then exactly m kept (:64-67). Fully vectorized (first-occurrence
        # dedupe in a random candidate order == the original sequential scan)
        # so Tree-of-Life-scale replicas prepare in minutes, not hours.
        per_node = max(int(5 * (2 * m / n)), 1)
        cand_src = np.repeat(np.arange(n, dtype=np.int64), per_node)
        cand_dst = rng.randint(0, n - 1, size=len(cand_src)).astype(np.int64)
        cand_dst = np.where(cand_dst >= cand_src, cand_dst + 1, cand_dst)
        order = rng.permutation(len(cand_src))
        a_c, b_c = cand_src[order], cand_dst[order]
        # unordered-pair key: matches the original's `key in seen or rkey in
        # seen` check and its bidirectional pos_keys set
        ukey = np.minimum(a_c, b_c) * n + np.maximum(a_c, b_c)
        _, first = np.unique(ukey, return_index=True)
        first.sort()
        a_c, b_c, ukey = a_c[first], b_c[first], ukey[first]
        e_lo = np.minimum(edges[:, 0], edges[:, 1]).astype(np.int64)
        e_hi = np.maximum(edges[:, 0], edges[:, 1]).astype(np.int64)
        pos_ukey = np.unique(e_lo * n + e_hi)
        ins = np.searchsorted(pos_ukey, ukey)
        ins = np.minimum(ins, len(pos_ukey) - 1)
        keep = pos_ukey[ins] != ukey
        negs = np.stack([a_c[keep], b_c[keep]], axis=1)[:m]
        neg_spt_idx = rng.choice(len(negs), k_spt, replace=False)
        neg_mask = np.zeros(len(negs), bool)
        neg_mask[neg_spt_idx] = True

        # message-passing graph: ALL positives + injected negatives, single
        # direction (link_process.py:44-47,83-87)
        src = np.concatenate([edges[:, 0], negs[:, 0]])
        dst = np.concatenate([edges[:, 1], negs[:, 1]])
        graphs.append(CSRGraph.from_edges(src, dst, n))

        pools[g] = {"spt": [], "qry": []}
        for (a, b), is_spt in [
            *(((e[0], e[1]), spt_mask[i]) for i, e in enumerate(edges)),
        ]:
            name = f"{g}_{a}_{b}"
            info[name] = 1
            pools[g]["spt" if is_spt else "qry"].append((name, 1))
        for i, (a, b) in enumerate(negs):
            name = f"{g}_{a}_{b}"
            info[name] = 0
            pools[g]["spt" if neg_mask[i] else "qry"].append((name, 0))

    _write_common(out_dir, graphs, features, info)

    # graph-space split (link_process.py:124-132)
    n_graphs = len(pos_edges)
    n_hold = max(int(val_frac * n_graphs), 1)
    order = rng.permutation(n_graphs)
    test_g = set(order[:n_hold].tolist())
    val_g = set(order[n_hold:2 * n_hold].tolist())
    mode_of = {g: ("test" if g in test_g else "val" if g in val_g else "train")
               for g in range(n_graphs)}

    rows = {m: {"spt": [], "qry": [], "main": []}
            for m in ("train", "val", "test")}
    for g in range(n_graphs):
        m = mode_of[g]
        for pool in ("spt", "qry"):
            rows[m][pool].extend(pools[g][pool])
            rows[m]["main"].extend(pools[g][pool])
    for m in ("train", "val", "test"):
        _write_csv(os.path.join(out_dir, f"{m}.csv"), rows[m]["main"])
        _write_csv(os.path.join(out_dir, f"{m}_spt.csv"), rows[m]["spt"])
        _write_csv(os.path.join(out_dir, f"{m}_qry.csv"), rows[m]["qry"])
