"""The port's parity runner and replicas (gmeta_tpu_torch.run.parity,
gmeta_tpu_torch.data.replicas) against the JAX package's
(scripts/run_parity.py, scripts/make_replicas.py): byte-identical replica
files, the DATASET marker of a run of record's checkpoint, evaluation from
that checkpoint against the JAX Trainer resumed from it, the JAX initial
theta files, and the per-layer oracle check."""

import dataclasses
import hashlib
import sys
import time
import types
import zipfile
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from gmeta_tpu.config import PRESETS as JPRESETS
from gmeta_tpu.meta.maml import MetaLearner as JMetaLearner
from gmeta_tpu_torch.config import build_model_config
from gmeta_tpu_torch.data import replicas
from gmeta_tpu_torch.run import parity
from gmeta_tpu_torch.run.train import build_datasets

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "parity_torch"))
import jax_reference  # noqa: E402
import make_replicas  # noqa: E402

torch.set_num_threads(2)

FULL = ("fold_ppi", "firstmm_db", "tissue_ppi")


# zipfile stamps each member with the wall clock; pinned, so that two
# writes of the same arrays are the same bytes
_FIXED_TIME = types.SimpleNamespace(time=lambda: 1.7e9,
                                    localtime=time.localtime)


def _digests(d):
    return {str(p.relative_to(d)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(Path(d).rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    """The three full replicas, written by each package at one pinned
    zip time: {recipe: (port dir, JAX dir)}."""
    root = tmp_path_factory.mktemp("replicas")
    out = {}
    with mock.patch.object(zipfile, "time", _FIXED_TIME):
        for name in FULL:
            mine, theirs = root / "port" / name, root / "jax" / name
            replicas.RECIPES[name](str(mine))
            make_replicas.RECIPES[name](str(theirs))
            out[name] = (mine, theirs)
    return out


@pytest.mark.parametrize("name", FULL)
def test_replica_files_byte_identical(made, name):
    mine, theirs = made[name]
    got, want = _digests(mine), _digests(theirs)
    assert "graphs.npz" in got and len(got) >= 5, sorted(got)
    assert got == want


def _arxiv_like(mod, out, n=3_000):
    """make_arxiv's body at a small n, from one package's generators."""
    rng = np.random.RandomState(0)
    pairs = mod.ring_hub_pairs(n, local_k=5, hub_deg=3.6, hub_alpha=0.85,
                               rng=rng)
    g = mod.CSRGraph.from_edges(pairs[:, 0], pairs[:, 1], n,
                                make_bidirectional=True)
    y = mod.block_labels(n, 40, noise=0.65, rng=rng)
    centers = mod.shared_subspace_centers(40, 128, 6.5, rng)
    x = mod.class_features(y, 128, signal=0.27, centers=centers, rng=rng)
    mod.prepare_node_disjoint(str(out), [g], [x], [y], num_label_set=8,
                              seed=0)


def _tree_of_life_like(mod, out):
    """make_tree_of_life at 12 graphs of 400 nodes."""
    mod._link_recipe(str(out), n_graphs=12, n=400, feat_dim=1, local_k=3,
                     hub_deg=7.5, seed=4, feature_kind="degree", noise=0.4,
                     beta=2.5, z_win=32)


@pytest.mark.parametrize("make", [_arxiv_like, _tree_of_life_like],
                         ids=["arxiv", "tree_of_life"])
def test_small_generators_agree(tmp_path, make):
    with mock.patch.object(zipfile, "time", _FIXED_TIME):
        make(replicas, tmp_path / "port")
        make(make_replicas, tmp_path / "jax")
    got = _digests(tmp_path / "port")
    assert len(got) >= 5 and got == _digests(tmp_path / "jax")


def test_replica_size_matches_checkpoint_marker(made):
    for name in FULL:
        ckpt_dir = ROOT / "parity" / f"{name}.ckpt"
        size = parity.check_replica(str(made[name][0]), str(ckpt_dir))
        assert size == parity.dataset_marker_size(str(ckpt_dir))
    with pytest.raises(ValueError, match="DATASET marker"):
        parity.check_replica(str(made["fold_ppi"][0]),
                             str(ROOT / "parity" / "firstmm_db.ckpt"))


@pytest.mark.parametrize("name", ["fold_ppi", "firstmm_db"])
def test_eval_from_checkpoint_matches_jax(made, name):
    """The port's dual final test from a run of record's completed
    checkpoint, 4 test tasks (and one meta-batch of train tasks, which
    the evaluation does not read), against the JAX Trainer's from the same
    checkpoint: every per-task accuracy, at every finetune step, within
    one query."""
    cfg0 = JPRESETS[name]
    cut = dict(batchsz=cfg0.task_num, eval_batchsz=4)
    mine, theirs = made[name]
    cfg = parity.eval_config(name, str(mine), **cut)
    store, ds, labels_num = build_datasets(cfg)
    got = parity.eval_checkpoint(cfg, store, ds, labels_num,
                                 str(ROOT / "parity" / f"{name}.ckpt"),
                                 device="cpu")
    assert got["agg"] == "dense" and got["n_test_tasks"] == 4
    jres, jcurves, _ = jax_reference.jax_eval(
        name, str(theirs), str(ROOT / "parity" / f"{name}.ckpt"), **cut)
    one_query = 1.0 / (cfg0.n_way * cfg0.k_qry)
    for mine_c, jax_c in zip((got["curves_last"], got["curves_best"]),
                             jcurves):
        assert mine_c.shape == jax_c.shape == (4, cfg0.update_step_test + 1)
        assert np.abs(mine_c - jax_c).max() <= one_query + 1e-6
    assert got["acc"]["val_max"] == pytest.approx(jres.val_max_acc,
                                                  abs=1e-7)
    for key, f in (("test_acc_ref_style", "test_acc_ref"),
                   ("test_acc_final_step", "test_acc_final"),
                   ("best_model_acc", "best_test_acc")):
        assert abs(got["acc"][key] - getattr(jres, f)) <= one_query + 1e-6


@pytest.mark.parametrize("name", sorted(parity.REF))
def test_init_files_are_the_jax_initial_theta(name):
    """parity_torch/init/<recipe>.npz (parity_torch/jax_reference.py) is
    the JAX MetaLearner's initial theta of the preset, bit for bit, and
    loads into the port's spec of the replica."""
    cfg, spec, labels = jax_reference.spec_of(name)
    jml = JMetaLearner(spec, labels, update_lr=cfg.update_lr,
                       meta_lr=cfg.meta_lr, update_step=cfg.update_step,
                       update_step_test=cfg.update_step_test, seed=cfg.seed)
    arrs = np.load(ROOT / "parity_torch" / "init" / f"{name}.npz")
    assert len(arrs.files) == len(jml.params)
    for i, p in enumerate(jml.params):
        np.testing.assert_array_equal(arrs[f"p{i}"], np.asarray(p))
    params = parity.load_init(name, build_model_config(
        cfg, jax_reference.FEAT_DIM[name], labels))
    assert sum(p.numel() for p in params) == parity.REF[name]["params"]


def test_activation_parity_on_a_small_replica(tmp_path):
    """The per-layer oracle check on a small link replica (the
    tree_of_life generator at 12 graphs of 400 nodes): the packed path
    equals the numpy oracle to 1e-4 at every layer and the logits."""
    _tree_of_life_like(replicas, tmp_path / "tol")
    cfg = dataclasses.replace(
        parity.eval_config("tree_of_life", str(tmp_path / "tol")),
        batchsz=8, eval_batchsz=8, dtype="float32")
    store, ds, labels_num = build_datasets(cfg)
    spec = build_model_config(cfg, store.feat_dim, labels_num)
    act = parity.activation_parity(store, ds["test"], spec,
                                   cfg.link_pred_mode, torch.device("cpu"))
    assert act["n_checked"] == 6 and len(act["max_rel_diff_per_layer"]) == 2
    assert act["allclose_1e-4"], act


def test_report_lists_each_tag_and_checks_it(tmp_path, monkeypatch):
    """--report writes a row per training result and tag of REPORT_TAGS
    (a run under agg="auto" beside the earlier one), with its aggregation
    and wall split; --check fails once a row disagrees with its JSON."""
    import json
    import shutil
    monkeypatch.setattr(parity, "REPORT", str(tmp_path / "REPORT.md"))
    shutil.copy(ROOT / "parity_torch" / "fold_ppi.json",
                tmp_path / "fold_ppi.json")
    auto = json.loads((ROOT / "parity_torch" / "fold_ppi.json").read_text())
    auto.update(agg="sized", tasks_per_s=701.25)
    (tmp_path / "fold_ppi_auto.json").write_text(json.dumps(auto))
    parity.write_report(str(tmp_path))
    rows = [l for l in (tmp_path / "REPORT.md").read_text().splitlines()
            if l.startswith("| fold_ppi")]
    assert [r.split("|")[1].strip() for r in rows] == ["fold_ppi",
                                                       "fold_ppi_auto"]
    assert "| dense |" in rows[0] and "| sized | 701.2 (" in rows[1]
    w = auto["wall_s"]
    assert (f"| {w['replica_gen']} / {w['data_and_extraction']} / "
            f"{w['train_and_eval']} |") in rows[1]
    auto["agg"] = "dense"
    (tmp_path / "fold_ppi_auto.json").write_text(json.dumps(auto))
    with pytest.raises(SystemExit, match="fold_ppi_auto: table lacks"):
        parity.check_report(str(tmp_path))
