"""The JAX package's side of the port's parity checks, run on the CPU.

    JAX_PLATFORMS=cpu python parity_torch/jax_reference.py inits
    JAX_PLATFORMS=cpu python parity_torch/jax_reference.py eval \
        fold_ppi firstmm_db tissue_ppi

`inits` writes parity_torch/init/<recipe>.npz for the five presets: the
initial theta that the JAX MetaLearner draws for the preset
(`init_params(jax.random.PRNGKey(cfg.seed), spec)`, gmeta_tpu/meta/maml.py),
as arrays p0, p1, ... in the flat (W, b, W, b, ...) order. The port's
parity runner starts a training run from it (`--init_from_jax`), so that
the port's run and the run of record differ by rounding, not by an init
draw. threefry draws the same bits on every platform.

`eval` resumes the JAX Trainer on the CPU from the completed checkpoint of
each run of record (parity/<recipe>.ckpt, copied to a temporary
directory) on its replica, so that `fit` goes straight to the dual final
test, and writes parity_torch/<recipe>.eval_cpu_jax.json: the five
accuracies, the per-task curves of the last and of the best model, and
the seconds it took. The record's preset overrides apply except
`device_task_pool` (an execution mode of training; nothing is trained
here), and the aggregation is the record's. This is the tight reference
of the port's evaluation parity: the same checkpoint and episodes, true
float32 products (the record's own products ran at the TPU's default
matmul precision).

This script is not part of the port: it imports jax and the JAX package.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

# input width of each replica and the output width of its head (Disjoint:
# n_way; Shared: the dataset's class count, 2 for these three)
FEAT_DIM = {"arxiv": 128, "tissue_ppi": 50, "fold_ppi": 512,
            "firstmm_db": 5, "tree_of_life": 1}
PARAMS_REF = {"arxiv": 99_587, "tissue_ppi": 23_298, "fold_ppi": 82_563,
              "firstmm_db": 17_794, "tree_of_life": 67_330}


def spec_of(name):
    from gmeta_tpu.config import PRESETS, build_model_config
    cfg = PRESETS[name]
    labels = cfg.n_way if cfg.task_setup == "Disjoint" else 2
    return cfg, build_model_config(cfg, FEAT_DIM[name], labels), labels


def write_inits(out_dir):
    from gmeta_tpu.meta.maml import MetaLearner
    os.makedirs(out_dir, exist_ok=True)
    for name in FEAT_DIM:
        cfg, spec, labels = spec_of(name)
        ml = MetaLearner(spec, labels, update_lr=cfg.update_lr,
                         meta_lr=cfg.meta_lr, update_step=cfg.update_step,
                         update_step_test=cfg.update_step_test,
                         seed=cfg.seed)
        arrs = {f"p{i}": np.asarray(p) for i, p in enumerate(ml.params)}
        n = sum(a.size for a in arrs.values())
        assert n == PARAMS_REF[name], (name, n)
        np.savez(os.path.join(out_dir, f"{name}.npz"), **arrs)
        print(f"{name}: {len(arrs)} arrays, {n} parameters")


def jax_eval(name, rep_dir, ckpt_dir, **cut):
    """The JAX Trainer resumed on the CPU from a copy of a completed
    checkpoint: (FitResult, [test curves of the last model, of the best],
    config). The record's preset overrides apply except
    `device_task_pool`, the aggregation is the record's, and `cut`
    overrides fields (e.g. eval_batchsz)."""
    from gmeta_tpu.config import PRESETS
    from gmeta_tpu.run.train import Trainer, build_datasets

    with open(os.path.join(ROOT, "parity", f"{name}.json")) as f:
        record = json.load(f)
    cfg = dataclasses.replace(PRESETS[name])
    for k, v in record["preset_overrides"].items():
        if k != "device_task_pool":
            setattr(cfg, k, v)
    cfg.data_dir = rep_dir
    cfg.agg = record["agg"]
    cfg.track_train_curve = False
    for k, v in cut.items():
        setattr(cfg, k, v)
    store, datasets, labels_num = build_datasets(cfg)
    with tempfile.TemporaryDirectory() as tmp:
        cfg.checkpoint_dir = os.path.join(tmp, "ckpt")
        shutil.copytree(ckpt_dir, cfg.checkpoint_dir, symlinks=True)
        tr = Trainer(cfg, store, datasets, labels_num)
        assert tr.start_epoch == cfg.epoch, tr.start_epoch
        curves = []
        evaluate = tr.evaluate

        def keep(split, params=None):
            c = evaluate(split, params)
            if split == "test":
                curves.append(c)
            return c
        tr.evaluate = keep
        res = tr.fit()
    return res, curves, cfg


def eval_record(name, replicas, out_dir):
    import jax
    from make_replicas import RECIPES

    rep_dir = os.path.join(replicas, name)
    if not os.path.exists(os.path.join(rep_dir, "graphs.npz")):
        RECIPES[name](rep_dir)
    src = os.path.join(ROOT, "parity", f"{name}.ckpt")
    with open(os.path.join(src, "DATASET")) as f:
        want = int(f.read().split("_")[0])
    got = os.path.getsize(os.path.join(rep_dir, "graphs.npz"))
    assert got == want, (name, got, want)
    with open(os.path.join(ROOT, "parity", f"{name}.json")) as f:
        record = json.load(f)
    t0 = time.time()
    res, curves, cfg = jax_eval(name, rep_dir, src)
    out = {
        "recipe": name, "backend": jax.default_backend(),
        "jax": jax.__version__, "agg": cfg.agg, "dtype": cfg.dtype,
        "n_test_tasks": int(curves[0].shape[0]),
        "acc": {"test_acc_ref_style": res.test_acc_ref,
                "test_acc_final_step": res.test_acc_final,
                "best_model_acc": res.best_test_acc,
                "early_stopped_ref_style": res.early_stopped_ref,
                "val_max": res.val_max_acc},
        "record_acc": record["acc"],
        "curves_last": np.round(curves[0], 6).tolist(),
        "curves_best": np.round(curves[1], 6).tolist(),
        "wall_s": {"data_and_eval": round(time.time() - t0, 1)},
    }
    path = os.path.join(out_dir, f"{name}.eval_cpu_jax.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(name, json.dumps(out["acc"]), out["wall_s"], flush=True)


def main():
    ap = argparse.ArgumentParser("jax_reference")
    ap.add_argument("what", choices=("inits", "eval"))
    ap.add_argument("recipes", nargs="*")
    ap.add_argument("--replicas", default=os.path.join(ROOT, "replicas"))
    ap.add_argument("--out", default=os.path.dirname(os.path.abspath(
        __file__)))
    args = ap.parse_args()
    if args.what == "inits":
        write_inits(os.path.join(args.out, "init"))
    else:
        for name in args.recipes:
            eval_record(name, args.replicas, args.out)


if __name__ == "__main__":
    main()
