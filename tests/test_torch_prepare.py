"""The port's dataset tools (gmeta_tpu_torch.data.prepare, io's
convert_dgl_pickle) against the JAX package's on the same inputs and seed,
and the port's CLI (`main`) from a prepared directory to a FitResult."""

import csv
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from fake_dgl import FakeDGLGraph
from gmeta_tpu.data import io as jio
from gmeta_tpu.data import prepare as jprep
from gmeta_tpu.data.graph import synthetic_store
from gmeta_tpu_torch.data import io, prepare
from gmeta_tpu_torch.run.train import FitResult, main

torch.set_num_threads(2)


def _node_inputs(num_graphs=3, n=120, classes=9, seed=0):
    store, labels = synthetic_store(num_graphs=num_graphs, nodes_per_graph=n,
                                    avg_degree=6, feat_dim=8,
                                    num_classes=classes, seed=seed,
                                    class_signal=2.0)
    feats = [store.features[store.node_offsets[g]:store.node_offsets[g + 1]]
             for g in range(num_graphs)]
    return store.graphs, feats, labels


def _link_inputs(num_graphs=5, n=80, seed=0):
    rng = np.random.RandomState(seed)
    pos, feats = [], []
    for _ in range(num_graphs):
        a, b = rng.randint(0, n, 160), rng.randint(0, n, 160)
        pairs = np.unique(a[a < b] * n + b[a < b])
        pos.append(np.stack([pairs // n, pairs % n], 1))
        feats.append(rng.randn(n, 8).astype(np.float32))
    return pos, [n] * num_graphs, feats


def _assert_same_dir(a: Path, b: Path):
    """Same file tree; graphs, features and labels equal; every other file
    (the CSVs) byte-identical."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb and fa
    for rel in fa:
        x, y = a / rel, b / rel
        if rel.name == "graphs.npz":
            gx, gy = jio.load_graphs_npz(str(x)), io.load_graphs_npz(str(y))
            assert len(gx) == len(gy)
            for g, h in zip(gx, gy):
                np.testing.assert_array_equal(g.indptr, h.indptr)
                np.testing.assert_array_equal(g.indices, h.indices)
        elif rel.name == "features.npy":
            for f, h in zip(jio.load_features(str(x)),
                            io.load_features(str(y))):
                np.testing.assert_array_equal(f, h)
        elif rel.suffix == ".pkl":
            with open(x, "rb") as f, open(y, "rb") as g:
                assert pickle.load(f) == pickle.load(g)
        else:
            assert x.read_bytes() == y.read_bytes(), rel


@pytest.mark.parametrize("tool", ["node_disjoint", "node_shared",
                                  "node_shared_tasks", "link"])
def test_prepare_writes_what_jax_writes(tmp_path, tool):
    a, b = tmp_path / "jax", tmp_path / "port"
    if tool == "link":
        args = _link_inputs()
        kw = dict(training_edges_fraction=0.3, val_frac=0.2, seed=4)
    else:
        graphs, feats, labels = _node_inputs()
        if tool == "node_disjoint":
            args, kw = (graphs, feats, labels), dict(num_label_set=2, seed=3)
        elif tool == "node_shared":
            args, kw = (graphs, feats, labels), dict(folds=[(0, 1), (1, 2)])
        else:
            rng = np.random.RandomState(5)
            tasks = [[rng.randint(0, 2, g.num_nodes) for g in graphs]
                     for _ in range(2)]
            args, kw = (graphs, feats, tasks), dict(val_graph=1,
                                                    test_graph=2)
    getattr(jprep, f"prepare_{tool}")(str(a), *args, **kw)
    getattr(prepare, f"prepare_{tool}")(str(b), *args, **kw)
    _assert_same_dir(a, b)


def test_convert_dgl_pickle_equals_jax(tmp_path):
    rng = np.random.RandomState(0)
    gs = [FakeDGLGraph(rng.randint(0, n, m), rng.randint(0, n, m), n)
          for n, m in ((40, 160), (25, 60), (1, 0))]
    pkl = tmp_path / "graph_dgl.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(gs, f)
    jio.convert_dgl_pickle(str(pkl), str(tmp_path / "jax.npz"))
    io.convert_dgl_pickle(str(pkl), str(tmp_path / "port.npz"))
    want = jio.load_graphs_npz(str(tmp_path / "jax.npz"))
    got = io.load_graphs_npz(str(tmp_path / "port.npz"))
    assert len(got) == len(want) == 3
    for fake, g, h in zip(gs, got, want):
        np.testing.assert_array_equal(g.indptr, h.indptr)
        np.testing.assert_array_equal(g.indices, h.indices)
        src, dst = (np.asarray(t) for t in fake.all_edges())
        for v in range(g.num_nodes):       # row v: DGL's in_edges(v)[0]
            np.testing.assert_array_equal(np.sort(g.in_neighbors(v)),
                                          np.sort(src[dst == v]))


def test_loader_points_at_the_converter(tmp_path):
    with open(tmp_path / "graph_dgl.pkl", "wb") as f:
        pickle.dump([], f)
    try:
        import dgl  # noqa: F401
        pytest.skip("dgl is installed: the loader reads the pickle itself")
    except ImportError:
        pass
    with pytest.raises(RuntimeError,
                       match="gmeta_tpu_torch.data.io.convert_dgl_pickle"):
        io.load_graph_list(str(tmp_path))


TINY = ["--k_spt", "2", "--k_qry", "3", "--h", "2", "--hidden_dim", "8",
        "--epoch", "1", "--task_num", "2", "--batchsz", "4",
        "--eval_batchsz", "4", "--update_step", "2", "--update_step_test",
        "2", "--train_result_report_steps", "1", "--device", "cpu",
        "--agg", "sized"]


@pytest.mark.parametrize("setup", ["disjoint", "shared_fold", "link",
                                   "dgl_pickle"])
def test_main_from_a_prepared_directory(tmp_path, setup):
    out = tmp_path / "ds"
    if setup == "link":
        prepare.prepare_link(str(out), *_link_inputs(), seed=0)
        argv = ["--data_dir", str(out), "--task_setup", "Shared",
                "--link_pred_mode", "True", "--n_way", "2",
                "--sample_nodes", "48"]
    elif setup == "shared_fold":
        graphs, feats, labels = _node_inputs(num_graphs=4, classes=3)
        prepare.prepare_node_shared(str(out), graphs, feats, labels,
                                    folds=[(0, 1), (2, 3)])
        argv = ["--data_dir", str(out / "fold1"), "--task_setup", "Shared",
                "--sample_nodes", "32"]
    else:
        graphs, feats, labels = _node_inputs(num_graphs=2, n=150)
        prepare.prepare_node_disjoint(str(out), graphs, feats, labels,
                                      num_label_set=3, seed=0)
        if setup == "dgl_pickle":
            # the reference's layout: graph_dgl.pkl in place of graphs.npz,
            # converted before training
            fakes = [FakeDGLGraph(g.indices,
                                  np.repeat(np.arange(g.num_nodes),
                                            np.diff(g.indptr)), g.num_nodes)
                     for g in graphs]
            os.remove(out / "graphs.npz")
            with open(out / "graph_dgl.pkl", "wb") as f:
                pickle.dump(fakes, f)
            io.convert_dgl_pickle(str(out / "graph_dgl.pkl"),
                                  str(out / "graphs.npz"))
        argv = ["--data_dir", str(out), "--task_setup", "Disjoint",
                "--n_way", "3", "--sample_nodes", "32"]
    res = main(argv + TINY)
    assert isinstance(res, FitResult) and res.global_step == 2
    assert 0.0 <= res.test_acc_final <= 1.0
    rows = list(csv.reader(open(next(out.rglob("train.csv")))))
    assert rows[0] == ["", "name", "label"] and len(rows) > 1
