"""The port's trainer (gmeta_tpu_torch.run.train) against the JAX package's
Trainer on the tiny data of tests/test_trainer.py, plus the entry points'
device rule and the launch check of the mesh options."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from gmeta_tpu.config import Config as JConfig
from gmeta_tpu.data.graph import synthetic_store
from gmeta_tpu.data.prepare import prepare_node_disjoint
from gmeta_tpu.data.synthetic import synthetic_disjoint as j_synthetic
from gmeta_tpu.run.train import Trainer as JTrainer
from gmeta_tpu_torch.config import Config
from gmeta_tpu_torch.convert import params_from_jax
from gmeta_tpu_torch.data import native
from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
from gmeta_tpu_torch.run import train as train_mod
from gmeta_tpu_torch.run.train import Trainer

torch.set_num_threads(2)

DATA = dict(num_graphs=1, nodes_per_graph=300, avg_degree=6, feat_dim=16,
            num_classes=9, n_way=3, k_spt=3, k_qry=4, batchsz=8, h=2,
            sample_nodes=64, seed=3)
CFG = dict(n_way=3, k_spt=3, k_qry=4, h=2, hidden_dim=16, epoch=2,
           task_num=4, update_step=2, update_step_test=3, update_lr=0.05,
           meta_lr=1e-3, train_result_report_steps=1, agg="sized")


def _records(path):
    return [json.loads(line) for line in open(path)]


def test_fit_matches_jax_trainer(tmp_path):
    jstore, jds = j_synthetic(**DATA)
    jcfg = JConfig(**CFG, metrics_path=str(tmp_path / "jax.jsonl"))
    jtr = JTrainer(jcfg, jstore, jds, labels_num=3)
    start = [np.asarray(p) for p in jtr.learner.params]
    jres = jtr.fit()

    store, ds = synthetic_disjoint(**DATA)
    cfg = Config(**CFG, metrics_path=str(tmp_path / "port.jsonl"))
    tr = Trainer(cfg, store, ds, labels_num=3, device="cpu")
    tr.learner.set_params(params_from_jax(start))
    tr.best_params = tr.learner.snapshot()
    res = tr.fit()

    assert res.epochs_run == jres.epochs_run == 2
    assert res.global_step == jres.global_step == 4
    for f in ("test_acc_ref", "test_acc_final", "best_test_acc",
              "early_stopped_ref", "val_max_acc"):
        np.testing.assert_allclose(getattr(res, f), getattr(jres, f),
                                   atol=1e-6, err_msg=f)
    port, ref = _records(cfg.metrics_path), _records(jcfg.metrics_path)
    kinds = [r["kind"] for r in port]
    assert "train_step" in kinds and "val" in kinds and "fit_result" in kinds
    pv = [r["acc_curve"] for r in port if r["kind"] == "val"]
    jv = [r["acc_curve"] for r in ref if r["kind"] == "val"]
    np.testing.assert_allclose(pv, jv, atol=1e-6)
    for r in (r for r in port if r["kind"] == "train_step"):
        assert np.isfinite(r["meta_loss"]) and r["nan_skip"] == 0
    # final params: every parameter but the head bias, whose meta-gradient
    # is analytically zero (tests/test_torch_meta.py::_assert_params_close);
    # that one moves at most meta_lr per step in either package
    for i, (a, b) in enumerate(zip(jtr.learner.params, tr.learner.params)):
        a, b = np.asarray(a), b.detach().numpy()
        if i == len(start) - 1:
            assert np.abs(b - start[i]).max() <= 4 * cfg.meta_lr * 1.001
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-5,
                                       err_msg=f"param {i}")


def test_entry_points_need_cuda_or_an_explicit_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store, ds = synthetic_disjoint(**DATA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config(**CFG), store, ds, labels_num=3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_mod.main(["--data_dir", "unused"])


@pytest.mark.parametrize("override", [dict(mesh_tasks=2),
                                      dict(mesh_edges=2)])
def test_unported_options_raise(override, monkeypatch):
    """Every option is ported now: --mesh_tasks and --mesh_edges run, and
    one that asks for more ranks than the world has raises, saying how to
    launch them; every Config option, remat_inner and the native
    extractor included, is taken."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    (flag, value), = override.items()
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2"):
        train_mod.main(["--data_dir=unused", f"--{flag}={value}",
                        "--device=cpu"])
    store, ds = synthetic_disjoint(**DATA)
    Trainer(dataclasses.replace(Config(**CFG), remat_inner=True), store, ds,
            labels_num=3, device="cpu")


def test_cli_builds_datasets_like_jax_and_trains(tmp_path, capsys):
    """main() over a dataset on disk in the reference format: the port's
    build_datasets gives the JAX package's episodes with the numpy
    extractor, and a CPU run ends with a FitResult."""
    from gmeta_tpu.run.train import build_datasets as j_build

    store, labels = synthetic_store(num_graphs=2, nodes_per_graph=150,
                                    avg_degree=6, feat_dim=8, num_classes=9,
                                    seed=0, class_signal=2.0)
    feats = [store.features[store.node_offsets[g]:store.node_offsets[g + 1]]
             for g in range(2)]
    out = str(tmp_path / "ds")
    prepare_node_disjoint(out, store.graphs, feats, labels, num_label_set=3,
                          seed=0)
    flags = dict(data_dir=out, n_way=3, k_spt=2, k_qry=3, h=2,
                 sample_nodes=40, batchsz=8, eval_batchsz=4,
                 extractor="numpy")
    jstore, jds, jn = j_build(JConfig(**flags))
    tstore, tds, tn = train_mod.build_datasets(Config(**flags))
    assert jn == tn == 3
    np.testing.assert_array_equal(jstore.features, tstore.features)
    for split in ("train", "val", "test"):
        jb = next(jds[split].batches(4, shuffle=False))
        tb = next(tds[split].batches(4, shuffle=False))
        for a, b in zip(jb.spt + jb.qry, tb.spt + tb.qry):
            np.testing.assert_array_equal(a, b)
    capsys.readouterr()
    argv = [f"--{k}={v}" for k, v in flags.items()]
    fit = ["--hidden_dim=8", "--epoch=1", "--task_num=4", "--update_step=2",
           "--update_step_test=2", "--agg=sized", "--device=cpu"]
    res = train_mod.main(argv + fit + ["--extractor=auto"])
    engine = "native C++" if native.available() else "numpy"
    assert f"extractor: {engine} (requested 'auto')" in \
        capsys.readouterr().out
    assert res.global_step == 2 and 0.0 <= res.test_acc_final <= 1.0
    if native.available():
        res = train_mod.main(argv + fit + ["--extractor=native"])
        assert "extractor: native C++ (requested 'native')" in \
            capsys.readouterr().out
        assert res.global_step == 2
    with pytest.raises(ValueError, match="mesh_tasks 2"):
        train_mod.main(argv + ["--mesh_tasks=2", "--device=cpu"])


def test_stream_timings_split_the_iterators_wait_from_the_steps(
        tmp_path, monkeypatch):
    """The streaming loop's records: data_s is the host's wait in the batch
    iterator alone, compute_s each step's dispatch to the end of its work,
    both summed over every step of the report window (here two steps, the
    first report one)."""
    import time
    sleep = 1.5     # three times a loaded CPU's two tiny steps
    store, ds = synthetic_disjoint(**dict(DATA, batchsz=12))
    train = ds["train"]
    batches = train.batches

    def slow(*a, **k):
        for b in batches(*a, **k):
            time.sleep(sleep)
            yield b
    monkeypatch.setattr(train, "batches", slow)
    cfg = Config(**dict(CFG, epoch=1, train_result_report_steps=2),
                 metrics_path=str(tmp_path / "m.jsonl"))
    Trainer(cfg, store, ds, labels_num=3, device="cpu").fit()
    recs = [r for r in _records(cfg.metrics_path) if r["kind"] == "train_step"]
    assert [r["step"] for r in recs] == [0, 2]
    for r, n in zip(recs, (1, 2)):
        assert r["data_s"] >= n * sleep, r
        assert 0 < r["compute_s"] < sleep, r
