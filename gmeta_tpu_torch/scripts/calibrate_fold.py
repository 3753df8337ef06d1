"""Train-in-the-loop calibration of the fold_ppi replica.

Counterpart of scripts/calibrate_fold.py. The numpy proxy
(calibrate_replicas.py) scores seen-class separability, while the
recipe's number is unseen-class (Disjoint) transfer after meta-training,
so this script calibrates with the thing itself: for each candidate knob
(class signal, ring label noise, hub assortativity, shared-subspace rank,
private-centre strength) it generates the full-scale replica
(data/replicas.py `make_fold_ppi`), trains it through the port's
production trainer (run/parity.py `run_recipe`: the record's aggregation,
the device task pool) at probe length (3 epochs, batchsz <= 400) or, with
`--full`, the whole 5-epoch preset, and records the accuracies and the
val curve per epoch beside the target.

Every run starts from the JAX package's initial theta
(parity_torch/init/fold_ppi.npz, which the JAX calibrator's
`init_params(PRNGKey(seed))` draws bit for bit); the knobs change no
parameter shape, which `run_recipe`'s `load_init` checks. The tags, the
row schema and fold_sweep.json are the JAX script's.

    python -m gmeta_tpu_torch.scripts.calibrate_fold [--signals 0.22,0.27]
        [--noises 0.50] [--assorts 0.5] [--ranks 6] [--privates 0.0]
        [--full] [--target 0.578] [--agg sized] [--device cpu]
        [--out parity_torch/cal]

Runs on the card unless given `--device cpu`. Each run's results go to
<out>/res_<tag>/, its replica to <out>/<tag>/ (removed after the run).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

from gmeta_tpu_torch.data.replicas import make_fold_ppi
from gmeta_tpu_torch.run import parity
from gmeta_tpu_torch.utils.device import resolve_device

OUT = os.path.join(parity.OUT, "cal")


def runner_args(rep_root: str, out: str, full: bool, agg: str,
                device) -> argparse.Namespace:
    """The JAX calibrators' runner arguments, plus what the port's runner
    reads: the JAX initial theta, the device."""
    return argparse.Namespace(
        probe=not full, epoch=0, batchsz=0, eval_batchsz=0, agg=agg,
        dtype="", remat=False, device_task_pool=True, checkpoint=False,
        task_n=None, tag="", replicas=rep_root, out=out,
        init_from_jax=True, device=device)


def probe_once(signal: float, out_dir: str, keep_replica: bool = False,
               noise: float = 0.50, assort: float = 0.5,
               private: float = 0.0, full: bool = False,
               rank: int = 6, agg: str = "", device=None) -> dict:
    """One knob: its replica, one `run_recipe`, the val curve per epoch.
    `full=True` runs the whole 5-epoch preset instead of the 3-epoch
    probe, for when the quantity under calibration is the early-stop
    structure (val peak epoch, best > final gap)."""
    tag = (f"s{signal:.3f}_p{private:.2f}_r{rank}"
           f"_n{noise:.2f}_a{assort:.2f}")
    rep_root = os.path.join(out_dir, tag)
    rep = os.path.join(rep_root, "fold_ppi")
    if not os.path.exists(os.path.join(rep, "graphs.npz")):
        print(f"# generating fold_ppi replica signal={signal}"
              f" private={private}", flush=True)
        make_fold_ppi(rep, signal=signal, noise=noise, assort=assort,
                      private=private, rank=rank)
    args = runner_args(rep_root, os.path.join(out_dir, f"res_{tag}"), full,
                       agg, device)
    res = parity.run_recipe("fold_ppi", args)
    # per-epoch val curve: the early-stop structure under calibration
    vals = []
    with open(os.path.join(args.out, "fold_ppi.metrics.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            if r["kind"] == "val":
                vals.append(round(r["acc_curve"][-1], 4))
    res["val_by_epoch"] = vals
    if not keep_replica:
        shutil.rmtree(rep, ignore_errors=True)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser("gmeta_tpu_torch.scripts.calibrate_fold")
    ap.add_argument("--signals", default="0.22,0.27,0.33")
    ap.add_argument("--noises", default="0.50",
                    help="ring label-flip fractions (homophily knob)")
    ap.add_argument("--assorts", default="0.5",
                    help="hub class-assortativity values")
    ap.add_argument("--ranks", default="6",
                    help="shared-subspace ranks to cross (one-step transfer "
                         "knob)")
    ap.add_argument("--privates", default="0.0",
                    help="private-center strengths to cross with signals"
                         " (early-stop-gap knob)")
    ap.add_argument("--full", action="store_true",
                    help="full 5-epoch preset per probe (early-stop"
                         " structure needs the whole schedule)")
    ap.add_argument("--target", type=float, default=0.578)
    ap.add_argument("--agg", default="",
                    help="the runner's aggregation (dense|sized); default "
                         "the record's")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without one) or cpu")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    os.makedirs(args.out, exist_ok=True)

    rows = []
    ranks = [int(x) for x in args.ranks.split(",")]
    for rk in ranks:
        for nz in [float(x) for x in args.noises.split(",")]:
            for az in [float(x) for x in args.assorts.split(",")]:
                for p in [float(x) for x in args.privates.split(",")]:
                    for s in [float(x) for x in args.signals.split(",")]:
                        rows.append(_row(args, s, p, rk, nz, az, device))

    with open(os.path.join(args.out, "fold_sweep.json"), "w") as f:
        json.dump({"target": args.target, "rows": rows}, f, indent=1)
    print(json.dumps(rows))
    return rows


def _row(args, s, p, rk, nz, az, device) -> dict:
    res = probe_once(s, args.out, private=p, full=args.full, rank=rk,
                     noise=nz, assort=az, agg=args.agg, device=device)
    acc = res["acc"]["test_acc_final_step"]
    print(f"# signal={s} private={p} rank={rk} noise={nz} assort={az}: "
          f"final {acc:.3f} ref_style {res['acc']['test_acc_ref_style']:.3f}"
          f" best {res['acc']['best_model_acc']:.3f} val_by_epoch "
          f"{res['val_by_epoch']} (target {args.target})", flush=True)
    return {"signal": s, "private": p, "rank": rk, "noise": nz, "assort": az,
            "probe_acc": acc,
            "best": res["acc"]["best_model_acc"],
            "early_ref": res["acc"]["early_stopped_ref_style"],
            "ref_style": res["acc"]["test_acc_ref_style"],
            "val_by_epoch": res["val_by_epoch"]}


if __name__ == "__main__":
    main()
