"""The readings the comparison's limits are set from, at a cell's own
sizes, many seeds in one process:

    python3 benchmark/control.py --workload arxiv.pool --seeds 1,2,3 \
        [--out FILE]

Per seed it draws the cell's inputs with a pool of just the checked steps'
tasks (their sizes are the cell's; only the pool is smaller) and reads the
comparison's three numbers (correct.readings), with the cell's model's
plain reference (`models/<model>.py` `Reference`), for:
- `program`: the program's first three meta-steps, as a run reads them
  (the lower readings);
- `control`: the plain reference with every matrix product in TF32, in
  the program's place: the nearest precision below the configuration's
  float32 (with TF32 off, as the program runs);
- `half_batch`: the reference with half of each step's tasks left out and
  the mean taken over the rest, in the program's place (a fault);
- `float64`: the plain reference in float64, for scale.
A state left unchanged reads 1 for `update3` by its definition and needs
no run. One JSON line per seed on standard output, then a summary line:
per reader and number, the largest and the smallest reading.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(cell, seed: int, device) -> dict:
    import torch

    from benchmark import correct, harness

    cfg, Reference = cell.cfg, cell.model.Reference
    T = cfg["task_num"]
    n = harness.CHECK_STEPS * T
    theta0, feats, spt, qry, order, first, checked = harness.inputs(
        cell, seed, device, n)
    ml, _ = harness.learner(cfg, cell.traffic["agg"], theta0, feats, spt,
                            qry, device)
    prog = harness.first_steps(ml, first)
    del ml, spt, qry
    if device.type == "cuda":
        torch.cuda.empty_cache()
    feats = torch.as_tensor(feats).to(device)
    tasks = harness.reference_tasks(checked, T)
    ref = Reference(cfg).run(theta0, tasks, feats)
    out = {"program": correct.readings(theta0, prog, ref)}
    for name, r, t in (
            ("control", Reference(cfg, tf32=True), tasks),
            ("half_batch", Reference(cfg),
             harness.reference_tasks(checked, T, keep=T // 2)),
            ("float64", Reference(cfg, dtype=torch.float64), tasks)):
        out[name] = correct.readings(theta0, r.run(theta0, t, feats), ref)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)

    import torch

    from benchmark.cell import load_cell
    from gmeta_tpu_torch.utils.device import resolve_device

    cell = load_cell(args.workload)
    device = resolve_device(args.device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    lines, summary = [], {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = readings(cell, seed, device)
        line = {"workload": cell.name, "seed": seed, "device": kind,
                "seconds": time.perf_counter() - t0, **r}
        lines.append(line)
        print(json.dumps(line), flush=True)
        for who, nums in r.items():
            for k, v in nums.items():
                if isinstance(v, list):
                    continue
                lo, hi = summary.setdefault(who, {}).get(k, (v, v))
                summary[who][k] = (min(lo, v), max(hi, v))
    last = {"workload": cell.name, "seeds": len(lines), "device": kind,
            "min_max": summary}
    print(json.dumps(last), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for line in lines + [last]:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
