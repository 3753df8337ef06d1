"""Train-in-the-loop calibration of the link-prediction replicas
(firstmm_db, tree_of_life).

Counterpart of scripts/calibrate_link.py. For each candidate of the
feature-noise knob and of the activity-assortativity beta it generates the
full-scale replica (data/replicas.py `_link_recipe`, the recipe's other
arguments as `make_firstmm_db` / `make_tree_of_life` give them), trains it
through the port's production trainer (run/parity.py `run_recipe`: the
record's aggregation unless `--agg` names one, the device task pool) over
the whole preset or, with `--probe`, 3 epochs of at most 400 tasks, and
records the accuracies beside the reference target. Every run starts from
the JAX package's initial theta (parity_torch/init/<recipe>.npz); the
knobs change no parameter shape, which `run_recipe`'s `load_init` checks.
The tags, the row schema and <recipe>_sweep.json are the JAX script's.

    python -m gmeta_tpu_torch.scripts.calibrate_link firstmm_db
        [--noises 0.30,0.22,0.15] [--betas 2.5] [--probe] [--agg sized]
        [--device cpu] [--out parity_torch/cal]

Runs on the card unless given `--device cpu`. Each run's results go to
<out>/res_<tag>/, its replica to <out>/<tag>/ (removed after the run).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

from gmeta_tpu_torch.data import replicas
from gmeta_tpu_torch.run import parity
from gmeta_tpu_torch.scripts.calibrate_fold import OUT, runner_args
from gmeta_tpu_torch.utils.device import resolve_device

TARGETS = {"firstmm_db": 0.769, "tree_of_life": 0.694}


def probe_once(recipe: str, noise: float, beta: float, out_dir: str,
               full: bool = True, keep_replica: bool = False, agg: str = "",
               device=None) -> dict:
    """One knob: its replica and one `run_recipe`."""
    tag = f"{recipe}_n{noise:.2f}_b{beta:.2f}"
    rep_root = os.path.join(out_dir, tag)
    rep = os.path.join(rep_root, recipe)
    if not os.path.exists(os.path.join(rep, "graphs.npz")):
        print(f"# generating {recipe} replica noise={noise} beta={beta}",
              flush=True)
        if recipe == "firstmm_db":
            replicas._link_recipe(
                rep, n_graphs=41, n=1_350, feat_dim=5, local_k=1,
                hub_deg=4.0, seed=3, feature_kind="structural",
                noise=noise, beta=beta, z_win=32)
        else:
            replicas._link_recipe(
                rep, n_graphs=1_840, n=2_900, feat_dim=1, local_k=3,
                hub_deg=7.5, seed=4, feature_kind="degree",
                noise=noise, beta=beta, z_win=32)
    args = runner_args(rep_root, os.path.join(out_dir, f"res_{tag}"), full,
                       agg, device)
    res = parity.run_recipe(recipe, args)
    if not keep_replica:
        shutil.rmtree(rep, ignore_errors=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser("gmeta_tpu_torch.scripts.calibrate_link")
    ap.add_argument("recipe", choices=list(TARGETS))
    ap.add_argument("--noises", default="0.30,0.22,0.15")
    ap.add_argument("--betas", default="2.5")
    ap.add_argument("--probe", action="store_true",
                    help="truncated probe runs instead of the full preset")
    ap.add_argument("--agg", default="",
                    help="the runner's aggregation (dense|sized); default "
                         "the record's")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without one) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    target = TARGETS[args.recipe]
    rows = []
    for b in [float(x) for x in args.betas.split(",")]:
        for n in [float(x) for x in args.noises.split(",")]:
            res = probe_once(args.recipe, n, b, args.out,
                             full=not args.probe, agg=args.agg,
                             device=device)
            a = res["acc"]
            rows.append({"noise": n, "beta": b,
                         "final": a["test_acc_final_step"],
                         "best": a["best_model_acc"],
                         "ref_style": a["test_acc_ref_style"]})
            print(f"# noise={n} beta={b}: final"
                  f" {a['test_acc_final_step']:.3f} (target {target})",
                  flush=True)

    with open(os.path.join(args.out, f"{args.recipe}_sweep.json"),
              "w") as f:
        json.dump({"target": target, "rows": rows}, f, indent=1)
    print(json.dumps(rows))
    return rows


if __name__ == "__main__":
    main()
