"""Accuracy-parity runner of the port: the five reference recipes.

Counterpart of scripts/run_parity.py. It trains or evaluates a recipe on
its replica (data/replicas.py) through the port's production driver
(run/train.py `Trainer`, `PRESETS` of config.py) and records:

- the reference-protocol accuracies (accs[1] of the last model as the
  reference prints it, the clean final-step and best-model accuracies, the
  contaminated "Early Stopped" average, the best val accuracy) beside the
  run of record's (parity/<recipe>.json, the JAX package on a TPU) and the
  reference's own numbers (test.ipynb cells 0-4; BASELINE.md);
- warm tasks/s and edges/s from the metric stream, peak RSS and peak
  device memory, the wall time split into replica generation, data and
  extraction, and training;
- per-layer GCN activation parity against the numpy DGL-semantics oracle
  (tests/oracle.py, which imports only numpy and is loaded by path) on
  real capped subgraphs of the replica's test split.

Modes:
- training (default): results go to parity_torch/<recipe><tag>.json and
  .metrics.jsonl; nothing is written under parity/. The run of record's
  preset overrides (parity/<recipe>.json) apply, and the flags override
  them (an `--epoch` cut, for example). `--init_from_jax` starts from the
  JAX run's initial theta (parity_torch/init/<recipe>.npz, written by
  parity_torch/jax_reference.py), so that the two runs differ by
  rounding, not by an init draw.
- `--eval_from DIR`: evaluation parity with no training (`eval_from`).
  DIR (a run of record's completed checkpoint, e.g. parity/fold_ppi.ckpt)
  is copied to a temporary directory; the replica's graphs.npz must have
  the size in the copy's `DATASET` marker (`<bytes>_<mtime>`; the mtime
  differs by construction and is not compared); `Trainer.fit` resumes
  the completed checkpoint and goes straight to the dual final test. The
  record's preset overrides apply except `device_task_pool` (an
  execution mode of training). It runs twice on one store, with the
  record's aggregation and then with `sized`, or once with `--agg`'s;
  on the full test set each pass is held at `EVAL_BOUNDS` against the
  JAX package's CPU evaluation of the same checkpoint
  (<recipe>.eval_cpu_jax.json) and the record, and the second pass
  against the first. The result, with per-task curves, goes to
  <out>/<recipe><tag>.eval.json; a missed bound fails the command.
- `--report` writes PARITY_TORCH.md from the training results; `--check`
  verifies it against them.

Training resolves the aggregation `auto` through data/pipeline.py
`agg_for`: on the card by the card's own crossover in real edges per
slot, on the CPU by the JAX package's rule (`suggested_agg`). The
evaluation passes run the record's aggregation, then sized. Every result
records the aggregation that ran; `--report` lists the training results
of each tag in REPORT_TAGS beside the untagged ones (`_auto`: a run with
no `--agg`; `_dense`: `--agg dense` in the same call).

Runs on the card unless `--device` names another.

Usage:
  python -m gmeta_tpu_torch.run.parity fold_ppi --init_from_jax
  python -m gmeta_tpu_torch.run.parity fold_ppi \\
      --eval_from parity/fold_ppi.ckpt [--agg sized]
  python -m gmeta_tpu_torch.run.parity --report
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import os
import resource
import shutil
import subprocess
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT = os.path.join(ROOT, "parity_torch")

# Reference baselines: test.ipynb cells 0-4 (verbatim in BASELINE.md).
REF = {
    "arxiv": dict(final=0.421, early=0.436, tasks_per_s=6.5, rss_gb=42.5,
                  params=99_587, total_s=17_206),
    "tissue_ppi": dict(final=0.780, early=0.774, tasks_per_s=7.3, rss_gb=37.9,
                       params=23_298, total_s=4_852),
    "fold_ppi": dict(final=0.578, early=0.656, tasks_per_s=4.3, rss_gb=44.4,
                     params=82_563, total_s=7_150),
    "firstmm_db": dict(final=0.769, early=0.756, tasks_per_s=12.3,
                       rss_gb=14.9, params=17_794, total_s=2_536),
    "tree_of_life": dict(final=0.694, early=0.723, tasks_per_s=11.1,
                         rss_gb=68.6, params=67_330, total_s=11_569),
}
ACC_KEYS = ("test_acc_ref_style", "test_acc_final_step", "best_model_acc",
            "early_stopped_ref_style", "val_max")


def peak_rss_gb() -> float:
    """This process's peak RSS (ru_maxrss is KiB on Linux)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1024 ** 2)


def card(device: torch.device) -> dict:
    """The device a result was measured on: for CUDA the card's name and
    `nvidia-smi`'s name and power limit."""
    if device.type != "cuda":
        return {"backend": device.type}
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    line = r.stdout.strip().splitlines()[0] if r.returncode == 0 else None
    return {"backend": "cuda", "device": torch.cuda.get_device_name(device),
            "card": line}


def record(name: str) -> dict:
    """The run of record of a recipe (the JAX package on a TPU)."""
    with open(os.path.join(ROOT, "parity", f"{name}.json")) as f:
        return json.load(f)


def record_val_curve(name: str) -> list:
    """The run of record's val accuracy at each epoch (last finetune
    step), from parity/<recipe>.metrics.jsonl."""
    out = []
    with open(os.path.join(ROOT, "parity", f"{name}.metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            if rec["kind"] == "val":
                out.append(rec["acc_curve"][-1])
    return out


def fit_acc(result) -> dict:
    """The five accuracies of a FitResult under the records' names."""
    return {"test_acc_ref_style": result.test_acc_ref,
            "test_acc_final_step": result.test_acc_final,
            "best_model_acc": result.best_test_acc,
            "early_stopped_ref_style": result.early_stopped_ref,
            "val_max": result.val_max_acc}


def replica(name: str, replicas: str):
    """(directory, seconds spent generating it) of a recipe's replica,
    generated where it is missing."""
    from gmeta_tpu_torch.data.replicas import RECIPES
    rep_dir = os.path.join(replicas, name)
    gen_s = 0.0
    if not os.path.exists(os.path.join(rep_dir, "graphs.npz")):
        print(f"# building replica {name} -> {rep_dir}", flush=True)
        t0 = time.time()
        RECIPES[name](rep_dir)
        gen_s = time.time() - t0
    return rep_dir, gen_s


def dataset_marker_size(ckpt_dir: str) -> int:
    """The byte size recorded in a checkpoint's DATASET marker."""
    with open(os.path.join(ckpt_dir, "DATASET")) as f:
        return int(f.read().strip().split("_")[0])


def check_replica(rep_dir: str, ckpt_dir: str) -> int:
    """The replica's graphs.npz size, which must equal the checkpoint's
    DATASET marker: a checkpoint is valid only for its own replica."""
    size = os.path.getsize(os.path.join(rep_dir, "graphs.npz"))
    want = dataset_marker_size(ckpt_dir)
    if size != want:
        raise ValueError(f"{rep_dir}/graphs.npz has {size} bytes, the "
                         f"checkpoint's DATASET marker {want}: another "
                         f"replica than the checkpoint's")
    return size


def load_oracle():
    """tests/oracle.py by path: numpy only, part of neither package."""
    spec = importlib.util.spec_from_file_location(
        "oracle", os.path.join(ROOT, "tests", "oracle.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- per-layer activation parity vs the numpy oracle ------------------------

def activation_parity(store, ds_test, spec, link_pred: bool, device,
                      n_checks: int = 6, seed: int = 0) -> dict:
    """Forward real test-split subgraphs through the production packed path
    (float32, agg="dense") and the raw-edge-list numpy oracle with the SAME
    random params; report the max relative difference per GCN layer and at
    the logits. Subgraphs are chosen largest-first so capped
    (sample_nodes-hit) neighborhoods are covered."""
    from gmeta_tpu_torch.data.pack import pack_set, round_up
    from gmeta_tpu_torch.meta.maml import _set_to
    from gmeta_tpu_torch.models.gcn import forward, init_params

    oracle = load_oracle()
    params = tuple(p.to(device) for p in init_params(
        torch.Generator().manual_seed(3), spec))
    np_params = [p.cpu().numpy().astype(np.float64) for p in params]
    n_gcn = sum(1 for n, _ in spec if n == "GraphConv")

    names = sorted({
        n for i in range(min(len(ds_test), 40))
        for group in (ds_test.sampler.support_x_batch[i],
                      ds_test.sampler.query_x_batch[i])
        for sub in group for n in sub})
    subs = [(nm, ds_test.extractor.extract(nm)) for nm in names]
    subs.sort(key=lambda t: -len(t[1].parents))
    rng = np.random.RandomState(seed)
    chosen = subs[:n_checks // 2] + [
        subs[i] for i in rng.choice(len(subs), n_checks - n_checks // 2,
                                    replace=False)]

    feats_dev = torch.as_tensor(np.asarray(store.features, np.float32),
                                device=device)
    layer_diff = np.zeros(n_gcn)
    logit_diff = 0.0
    sizes = []
    for name, sub in chosen:
        g_idx = int(name.split("_")[0])
        n = len(sub.parents)
        sizes.append(n)
        P = round_up(max(n, 1), 128)
        E = round_up(max(len(sub.edge_src), 1), 2048)
        packed = pack_set([sub], [g_idx], [0], store, P, E, B=1)
        sg = _set_to(type(packed)(*(None if x is None else x[None]
                                    for x in packed)), device)
        coll: list = []
        with torch.no_grad():
            logits = forward(params, sg, feats_dev, spec,
                             compute_dtype=torch.float32, agg="dense",
                             collect=coll)
        logits = logits[0].cpu().numpy()

        gids = store.global_ids(g_idx, sub.parents)
        h = store.features[gids].astype(np.float64)
        for li in range(n_gcn):
            w, b = np_params[2 * li], np_params[2 * li + 1]
            h = oracle.gcn_layer(h, sub.edge_src, sub.edge_dst, n, w, b)
            got = coll[li][0, 0, :n].cpu().numpy()
            # relative to the layer's activation scale: the production path
            # is float32, the oracle float64
            rel = np.abs(got - h) / (np.abs(h) + 1.0)
            layer_diff[li] = max(layer_diff[li], float(rel.max()))
        c = sub.centers
        ro = (np.concatenate([h[c[0]], h[c[1]]]) if link_pred else h[c[0]])
        ref_logits = ro @ np_params[-2].T + np_params[-1]
        rel = np.abs(logits[0] - ref_logits) / (np.abs(ref_logits) + 1.0)
        logit_diff = max(logit_diff, float(rel.max()))

    return {"n_checked": len(chosen),
            "subgraph_nodes": sizes,
            "max_rel_diff_per_layer": [round(d, 8) for d in layer_diff],
            "max_rel_diff_logits": round(logit_diff, 8),
            "allclose_1e-4": bool(logit_diff < 1e-4
                                  and max(layer_diff) < 1e-4)}


# ---- evaluation parity from a completed checkpoint --------------------------

def eval_config(name: str, rep_dir: str, agg: str = "", **overrides):
    """The preset with the run of record's overrides, except the training
    execution mode `device_task_pool`; the record's aggregation unless
    `agg` names one; then `overrides` (e.g. a cut of eval_batchsz)."""
    from gmeta_tpu_torch.config import PRESETS
    rec = record(name)
    cfg = dataclasses.replace(PRESETS[name])
    for k, v in rec["preset_overrides"].items():
        if k != "device_task_pool":
            setattr(cfg, k, v)
    cfg.data_dir = rep_dir
    cfg.agg = agg or rec["agg"]
    cfg.track_train_curve = False
    for k, v in overrides.items():
        setattr(cfg, k, v)
    return cfg.validate()


def eval_checkpoint(cfg, store, datasets, labels_num, ckpt_dir: str,
                    device=None) -> dict:
    """Resume a completed checkpoint (copied to a temporary directory) and
    run the dual final test: the five accuracies, the per-task curves of
    the last and the best model, the aggregation that ran and the
    seconds."""
    from gmeta_tpu_torch.run.train import Trainer
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, "ckpt")
        shutil.copytree(ckpt_dir, copy, symlinks=True)
        cfg = dataclasses.replace(cfg, checkpoint_dir=copy)
        tr = Trainer(cfg, store, datasets, labels_num, device=device)
        if tr.start_epoch != cfg.epoch or tr.start_batch:
            raise ValueError(f"{ckpt_dir} is not a completed run of "
                             f"{cfg.epoch} epochs (resumes at epoch "
                             f"{tr.start_epoch} batch {tr.start_batch})")
        curves = []
        evaluate = tr.evaluate

        def keep(split, params=None):
            c = evaluate(split, params)
            if split == "test":
                curves.append(c)
            return c
        tr.evaluate = keep
        t0 = time.time()
        result = tr.fit()
        if tr.device.type == "cuda":
            torch.cuda.synchronize(tr.device)
        eval_s = time.time() - t0
    return {"agg": tr.agg, "dtype": cfg.dtype, "acc": fit_acc(result),
            "n_test_tasks": int(curves[0].shape[0]),
            "curves_last": curves[0], "curves_best": curves[1],
            "eval_s": eval_s}


def compare(got: dict, name: str, jax_cpu: dict = None) -> dict:
    """Differences of an evaluation from the run of record's rounded
    accuracies and, where given, from the JAX package's CPU evaluation of
    the same checkpoint (its accuracies and the per-task curves, in
    queries)."""
    rec = record(name)["acc"]
    out = {"vs_record": {k: got["acc"][k] - rec[k] for k in ACC_KEYS}}
    if jax_cpu is not None:
        out["vs_jax_cpu"] = {k: got["acc"][k] - jax_cpu["acc"][k]
                             for k in ACC_KEYS}
        out["max_task_diff"] = max(
            float(np.abs(np.asarray(got[k]) - np.asarray(jax_cpu[k])).max())
            for k in ("curves_last", "curves_best"))
    return out


def jax_cpu_eval(name: str):
    """The JAX package's CPU evaluation of the run of record's checkpoint
    (parity_torch/jax_reference.py), or None."""
    p = os.path.join(OUT, f"{name}.eval_cpu_jax.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


# absolute bounds on the four test accuracies, (float32, bfloat16): against
# the JAX package's CPU evaluation of the same checkpoint, against the
# rounded TPU record, and a second pass against the first; every per-task
# curve within one query of the JAX CPU evaluation's and the first pass's
EVAL_BOUNDS = {"jax_cpu": (0.003, 0.01), "record": (0.01, 0.02),
               "first_pass": (0.003, 0.01)}
BOUNDED = ("test_acc_ref_style", "test_acc_final_step", "best_model_acc",
           "early_stopped_ref_style")


def _max_task_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max())
               for k in ("curves_last", "curves_best"))


def eval_from(name: str, ckpt_dir: str, replicas: str, device=None,
              agg: str = "", **over) -> dict:
    """Evaluation parity of a run of record's completed checkpoint: the
    replica made where missing and held against the checkpoint's DATASET
    marker, then the dual final test on one store, with the record's
    aggregation and then agg="sized", or with `agg` alone. With no cut in
    `over` (batchsz, eval_batchsz), each pass is held at EVAL_BOUNDS
    against the JAX package's CPU evaluation of the same checkpoint and
    the record, and the second against the first; `misses` lists every
    bound missed. Each pass records its kernel launches (fwd, bwd)."""
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.run.train import build_datasets
    from gmeta_tpu_torch.utils.device import resolve_device
    from gmeta_tpu_torch.utils.metrics import counted
    device = resolve_device(device)
    rep_dir, gen_s = replica(name, replicas)
    size = check_replica(rep_dir, ckpt_dir)
    cfg = eval_config(name, rep_dir, **over)
    aggs = [agg] if agg else list(dict.fromkeys([cfg.agg, "sized"]))
    t0 = time.time()
    store, datasets, labels_num = build_datasets(cfg)
    data_s = time.time() - t0
    one_query = 1.0 / len(datasets["test"].tasks[0].qry_labels)
    jax_cpu = None if over else jax_cpu_eval(name)
    f32 = cfg.dtype == "float32"
    passes, misses = {}, []

    def miss(what, diffs, which):
        bound = EVAL_BOUNDS[which][0 if f32 else 1]
        misses.extend(f"{name} {what} {k}: {diffs[k]:+.4f} (bound {bound})"
                      for k in BOUNDED if abs(diffs[k]) > bound)

    first = None
    for a in aggs:
        with counted() as c:
            got = eval_checkpoint(dataclasses.replace(cfg, agg=a), store,
                                  datasets, labels_num, ckpt_dir,
                                  device=device)
        got["launches"] = c.of(sp.LAUNCHES)
        d = compare(got, name, jax_cpu)
        res = {k: got[k] for k in ("agg", "acc", "launches", "curves_last",
                                   "curves_best", "eval_s")}
        res.update(d)
        if first is not None:
            res["vs_first_pass"] = {k: got["acc"][k] - first["acc"][k]
                                    for k in BOUNDED}
            res["max_task_diff_vs_first_pass"] = _max_task_diff(got, first)
        if not over:
            miss(f"{a} vs record", d["vs_record"], "record")
            if jax_cpu is not None:
                miss(f"{a} vs JAX CPU", d["vs_jax_cpu"], "jax_cpu")
                if d["max_task_diff"] > one_query + 1e-6:
                    misses.append(f"{name} {a} vs JAX CPU: a task's curve "
                                  f"{d['max_task_diff']:.4f} off (bound "
                                  f"one query, {one_query:.4f})")
            if first is not None:
                miss(f"{a} vs {first['agg']}", res["vs_first_pass"],
                     "first_pass")
                if res["max_task_diff_vs_first_pass"] > one_query + 1e-6:
                    misses.append(
                        f"{name} {a} vs {first['agg']}: a task's curve "
                        f"{res['max_task_diff_vs_first_pass']:.4f} off "
                        f"(bound one query, {one_query:.4f})")
        passes[a] = res
        first = first or got
        print(json.dumps({"recipe": name, "agg": a, "acc": got["acc"],
                          "vs_record": d["vs_record"],
                          "launches": got["launches"]}), flush=True)
    return {"recipe": name, **card(device), "eval_from": ckpt_dir,
            "graphs_npz_bytes": size, "overrides": over, "dtype": cfg.dtype,
            "n_test_tasks": len(datasets["test"]), "one_query": one_query,
            "record_acc": record(name)["acc"],
            "jax_cpu_acc": None if jax_cpu is None else jax_cpu["acc"],
            "checked": not over, "bounds": EVAL_BOUNDS, "misses": misses,
            "passes": passes,
            "wall_s": {"replica_gen": round(gen_s, 1),
                       "data_and_extraction": round(data_s, 1)}}


def _eval_cli(name: str, args) -> dict:
    """The `--eval_from` mode of the CLI: the result, its per-task curves
    rounded, into <out>/<recipe><tag>.eval.json; raises on a miss."""
    over = {k: getattr(args, k) for k in ("batchsz", "eval_batchsz")
            if getattr(args, k)}
    out = eval_from(name, args.eval_from, args.replicas, args.device,
                    args.agg, **over)
    for res in out["passes"].values():
        for k in ("curves_last", "curves_best"):
            res[k] = np.round(res[k], 6).tolist()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{name}{args.tag}.eval.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    if out["misses"]:
        raise SystemExit("evaluation parity out of bounds:\n  "
                         + "\n  ".join(out["misses"]))
    return out


# ---- one recipe -------------------------------------------------------------

def load_init(name: str, spec):
    """The JAX MetaLearner's initial theta of a preset
    (parity_torch/init/<recipe>.npz), checked against the spec's shapes."""
    from gmeta_tpu_torch.convert import params_from_jax
    from gmeta_tpu_torch.models.gcn import init_params
    arrs = np.load(os.path.join(OUT, "init", f"{name}.npz"))
    params = [arrs[f"p{i}"] for i in range(len(arrs.files))]
    want = [tuple(p.shape) for p in init_params(torch.Generator(), spec)]
    if [p.shape for p in params] != want:
        raise ValueError(f"init/{name}.npz has shapes "
                         f"{[p.shape for p in params]}, the spec {want}")
    return params_from_jax(params)


def run_recipe(name: str, args) -> dict:
    from gmeta_tpu_torch.config import PRESETS
    from gmeta_tpu_torch.models.gcn import count_params
    from gmeta_tpu_torch.run.train import Trainer, build_datasets
    from gmeta_tpu_torch.utils import checkpoint as ckpt
    from gmeta_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    rep_dir, gen_s = replica(name, args.replicas)
    cfg = dataclasses.replace(PRESETS[name])
    cfg.data_dir = rep_dir
    # telemetry query-evals off: trains identically (config.py)
    cfg.track_train_curve = False
    scaled = dict(record(name)["preset_overrides"])
    if args.probe:
        scaled.update(batchsz=min(cfg.batchsz, 400), eval_batchsz=50,
                      epoch=min(cfg.epoch, 3))
    for k in ("epoch", "batchsz", "eval_batchsz"):
        if getattr(args, k):
            scaled[k] = getattr(args, k)
    if args.task_n is not None:
        scaled["task_n"] = args.task_n
    if args.device_task_pool:
        scaled["device_task_pool"] = True
    if args.agg:
        scaled["agg"] = args.agg
    if args.dtype:
        scaled["dtype"] = args.dtype
    if args.remat:
        scaled["remat_inner"] = True
    for k, v in scaled.items():
        setattr(cfg, k, v)
    if args.checkpoint:
        # resumable long runs; a checkpoint is valid only against the SAME
        # replica, and a completed one must not turn a rerun into an
        # evaluation: both are wiped
        cfg.checkpoint_dir = os.path.join(args.out, f"{name}{args.tag}.ckpt")
        cfg.checkpoint_every_steps = 50
        st = os.stat(os.path.join(rep_dir, "graphs.npz"))
        ident = f"{st.st_size}_{int(st.st_mtime)}"
        marker = os.path.join(cfg.checkpoint_dir, "DATASET")
        if os.path.isdir(cfg.checkpoint_dir):
            old = open(marker).read() if os.path.exists(marker) else ""
            latest = ckpt.latest_path(cfg.checkpoint_dir)
            done = False
            if latest:
                st_ck = ckpt.restore(latest)
                done = (int(st_ck.get("batch_in_epoch", -1)) < 0
                        and int(st_ck["epoch"]) + 1 >= cfg.epoch)
            if old != ident or done:
                shutil.rmtree(cfg.checkpoint_dir)
                print("# wiped a stale or completed checkpoint dir")
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        with open(marker, "w") as f:
            f.write(ident)
    os.makedirs(args.out, exist_ok=True)
    cfg.metrics_path = os.path.join(args.out,
                                    f"{name}{args.tag}.metrics.jsonl")
    if os.path.exists(cfg.metrics_path):
        os.remove(cfg.metrics_path)
    cfg.validate()

    t0 = time.time()
    store, datasets, labels_num = build_datasets(cfg)
    data_s = time.time() - t0

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    trainer = Trainer(cfg, store, datasets, labels_num, device=device)
    if args.init_from_jax and trainer.global_step == 0:
        trainer.learner.set_params(load_init(name, trainer.spec))
        trainer.best_params = trainer.learner.snapshot()
    n_params = count_params(trainer.learner.params)
    t0 = time.time()
    result = trainer.fit()
    train_s = time.time() - t0
    peak_dev = (torch.cuda.max_memory_allocated(device) / 1e9
                if device.type == "cuda" else None)
    trainer.metrics.close()

    # steady-state throughput: mean of the last half of the train records
    tps, eps, val = [], [], []
    with open(cfg.metrics_path) as f:
        for line in f:
            rec = json.loads(line)
            if rec["kind"] in ("train_step", "train_window"):
                tps.append(rec.get("tasks_per_s", 0.0))
                eps.append(rec.get("edges_per_s", 0.0))
            elif rec["kind"] == "val":
                val.append(rec["acc_curve"][-1])
    tail = max(len(tps) // 2, 1)
    tasks_per_s = float(np.mean(tps[-tail:])) if tps else 0.0
    edges_per_s = float(np.mean(eps[-tail:])) if eps else 0.0

    act = activation_parity(store, datasets["test"], trainer.spec,
                            cfg.link_pred_mode, device)

    ref = REF[name]
    rec = record(name)
    acc = {k: round(v, 4) for k, v in fit_acc(result).items()}
    rec_val = record_val_curve(name)
    out = {
        "recipe": name,
        **card(device),
        "preset_overrides": scaled,
        "init_from_jax": bool(args.init_from_jax),
        "epochs": cfg.epoch, "batchsz": cfg.batchsz,
        "train_tasks_total": cfg.epoch * (len(datasets["train"])
                                          // cfg.task_num) * cfg.task_num,
        "params": n_params,
        "params_ref": ref["params"],
        "agg": trainer.agg,
        "dtype": cfg.dtype,
        "buckets": trainer.buckets,
        "mean_bin_fill": round(datasets["train"].mean_bin_fill, 4),
        "acc": acc,
        "record_acc": rec["acc"],
        "vs_record": {k: round(acc[k] - rec["acc"][k], 4) for k in ACC_KEYS},
        "val_curve": [round(v, 4) for v in val],
        "record_val_curve": [round(v, 4) for v in rec_val[:len(val)]],
        "val_max_abs_diff": round(max(
            (abs(a - b) for a, b in zip(val, rec_val)), default=0.0), 4),
        "reference_acc": {"final": ref["final"], "early_stopped": ref["early"]},
        "tasks_per_s": round(tasks_per_s, 2),
        "edges_per_s": round(edges_per_s, 1),
        "tasks_per_s_ref": ref["tasks_per_s"],
        "tasks_per_s_record": rec["tasks_per_s"],
        "vs_ref_throughput": round(tasks_per_s / ref["tasks_per_s"], 2)
        if tasks_per_s else 0.0,
        "peak_rss_gb": round(peak_rss_gb(), 2),
        "peak_rss_gb_ref": ref["rss_gb"],
        "peak_device_gb": None if peak_dev is None else round(peak_dev, 2),
        "wall_s": {"replica_gen": round(gen_s, 1),
                   "data_and_extraction": round(data_s, 1),
                   "train_and_eval": round(train_s, 1)},
        "record_wall_s": rec["wall_s"],
        "total_s_ref": ref["total_s"],
        "activation_parity": act,
    }
    path = os.path.join(args.out, f"{name}{args.tag}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


# ---- report -----------------------------------------------------------------

REPORT = os.path.join(ROOT, "PARITY_TORCH.md")


def _acc_cell(a: dict) -> str:
    return (f"{a['test_acc_ref_style']:.3f} / {a['test_acc_final_step']:.3f}"
            f" / {a['best_model_acc']:.3f}")


REPORT_TAGS = ("", "_auto", "_dense")


def _results(out_dir: str):
    """(label, path, result) of every training result on disk, by recipe
    and then by REPORT_TAGS."""
    for name in REF:
        for tag in REPORT_TAGS:
            p = os.path.join(out_dir, f"{name}{tag}.json")
            if os.path.exists(p):
                with open(p) as f:
                    yield name + tag, p, json.load(f)


def _wall_cell(r: dict) -> str:
    w = r["wall_s"]
    return (f"{w['replica_gen']} / {w['data_and_extraction']} / "
            f"{w['train_and_eval']}")


def write_report(out_dir: str = OUT) -> None:
    rows = list(_results(out_dir))
    lines = [
        "# PARITY_TORCH — the five recipes trained by the port",
        "",
        "Each recipe trained by `python -m gmeta_tpu_torch.run.parity"
        " <recipe> --init_from_jax`",
        "on its replica (`gmeta_tpu_torch/data/replicas.py`), from the JAX"
        " run of record's initial",
        "theta, with the run of record's preset overrides and the cuts in"
        " the overrides column.",
        "The run of record is the JAX package on a TPU (`parity/<recipe>.json`,"
        " `PARITY.md`); its",
        "accuracies stand beside the port's. Evaluation parity from the"
        " records' checkpoints is in",
        "`PERF.md` §6 (chip_smoke.py phase 11).",
        "",
        "Rows tagged `_auto` ran with no `--agg`, so `auto` chose the"
        " aggregation (`agg`), and rows",
        "tagged `_dense` with `--agg dense` in the same call; the untagged"
        " rows are earlier runs.",
        "Wall s: replica / data and extraction / training and"
        " evaluation.",
        "",
        "| recipe | device | params | epochs | acc ref-style / final-step /"
        " best | record | val max abs diff | agg | tasks/s (record) |"
        " wall s | peak RSS GB | peak device GB | logit parity max rel Δ |"
        " overrides |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for label, _, r in rows:
        ov = ", ".join(f"{k}={v}" for k, v in r["preset_overrides"].items())
        lines.append(
            f"| {label} | {r.get('card') or r.get('backend')} "
            f"| {r['params']:,} | {r['epochs']} "
            f"| {_acc_cell(r['acc'])} | {_acc_cell(r['record_acc'])} "
            f"| {r['val_max_abs_diff']:.4f} | {r['agg']} "
            f"| {r['tasks_per_s']:.1f} ({r['tasks_per_s_record']}) "
            f"| {_wall_cell(r)} "
            f"| {r['peak_rss_gb']:.1f} | {r['peak_device_gb']} "
            f"| {r['activation_parity']['max_rel_diff_logits']:.2e} "
            f"| {ov or 'none'} |")
    lines += ["", "Val accuracy at the last finetune step, per epoch,"
              " port / record:", ""]
    lines += [f"- {label}: " + ", ".join(
        f"{a:.4f} / {b:.4f}" for a, b in zip(r["val_curve"],
                                             r["record_val_curve"]))
        for label, _, r in rows]
    lines += ["", "Per-recipe details (val curve per epoch beside the"
              " record's, wall-clock split, per-layer",
              "activation differences) are in"
              " `parity_torch/<recipe><tag>.json`, the metric streams in",
              "`parity_torch/<recipe><tag>.metrics.jsonl`.", ""]
    with open(REPORT, "w") as f:
        f.write("\n".join(lines))
    print(f"PARITY_TORCH.md written ({len(rows)} recipes)")
    check_report(out_dir)


def check_report(out_dir: str = OUT) -> None:
    """Fail if PARITY_TORCH.md's table disagrees with the results on
    disk (parity_torch/<recipe><tag>.json, each tag of REPORT_TAGS)."""
    with open(REPORT) as f:
        rows = {l.split("|")[1].strip(): l for l in f if l.startswith("| ")}
    errors = []
    for name, p, r in _results(out_dir):
        if name not in rows:
            errors.append(f"{name}: a result exists but no table row")
            continue
        for want in (_acc_cell(r["acc"]), f"{r['tasks_per_s']:.1f} (",
                     f"| {r['agg']} |"):
            if want not in rows[name]:
                errors.append(f"{name}: table lacks {want!r} (json {p})")
    if errors:
        raise SystemExit("PARITY_TORCH.md is stale:\n  "
                         + "\n  ".join(errors))
    print("PARITY_TORCH.md consistent with parity_torch/*.json")


def main(argv=None):
    ap = argparse.ArgumentParser("gmeta_tpu_torch.run.parity",
                                 allow_abbrev=False)
    ap.add_argument("recipes", nargs="*", choices=list(REF) + [[]])
    ap.add_argument("--init_from_jax", action="store_true",
                    help="start from the JAX run's initial theta "
                         "(parity_torch/init/<recipe>.npz)")
    ap.add_argument("--eval_from", default="",
                    help="evaluate a completed checkpoint directory (a "
                         "copy of it) instead of training")
    ap.add_argument("--probe", action="store_true",
                    help="short calibration run (batchsz<=400, 3 epochs)")
    ap.add_argument("--epoch", type=int, default=0)
    ap.add_argument("--batchsz", type=int, default=0)
    ap.add_argument("--eval_batchsz", type=int, default=0)
    ap.add_argument("--device_task_pool", action="store_true")
    ap.add_argument("--agg", default="",
                    help="override the aggregation (dense|sized)")
    ap.add_argument("--dtype", default="",
                    help="compute dtype override (bfloat16|float32)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each inner step in the backward")
    ap.add_argument("--task_n", type=int, default=None,
                    help="tissue_ppi: which shared task to train")
    ap.add_argument("--tag", default="",
                    help="suffix of the output files (e.g. _task2)")
    ap.add_argument("--checkpoint", action="store_true",
                    help="snapshots under <out>/<name>.ckpt; a rerun "
                         "resumes a killed run")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    ap.add_argument("--replicas", default=os.path.join(ROOT, "replicas"))
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="verify PARITY_TORCH.md against the results "
                         "without rewriting it")
    args = ap.parse_args(argv)

    if args.check:
        check_report(args.out)
        return None
    results = [_eval_cli(name, args) if args.eval_from
               else run_recipe(name, args) for name in args.recipes]
    if args.report:
        write_report(args.out)
    return results


if __name__ == "__main__":
    main()
