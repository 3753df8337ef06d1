"""Whole meta-steps on both aggregation paths where agg="auto" decides:
the check of data/pipeline.py `agg_for` against the bench.

The port's own script; the JAX package has none. For each geometry it
runs gmeta_tpu_torch/bench.py's `bench_shape` (bf16, the pool resident)
with agg dense and sized in turns (dense, sized, sized, dense), and
records what `auto` resolves to there on the card and on the CPU
(`agg_for` at the shape's widths), each run's tasks/s, step s, mfu, peak
GB and profiled busy share with its largest kernels, and which path was
faster on the mean of its two runs. The geometries:

- the five runs of record's (`parity/<recipe>.json`), as the bench
  replays them;
- two synthetic ones on either side of the card's crossover: the
  SYNTH_SHAPE recipe's record buckets and fill, in SYNTH_DTYPE, with
  EDGE_FACTORS x the crossover's real edges per slot
  (at that dtype, P and the shape's hidden width: read from `--sweep`,
  bench_kernels' `--crossover` JSON, where it has a crossing there, else
  from `card_crossover`), E grown to hold them with the sweep's share of
  pad slots, over a pool of SYNTH_POOL tasks.

    python -m gmeta_tpu_torch.scripts.bench_agg [--sweep PATH]
        [--steps 16] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import json
import os

import torch

from gmeta_tpu_torch import bench
from gmeta_tpu_torch.data.pack import round_up
from gmeta_tpu_torch.data.pipeline import (agg_for, aggregation_width,
                                           card_crossover, edges_per_slot)
from gmeta_tpu_torch.scripts import common
from gmeta_tpu_torch.scripts.bench_kernels import SWEEP_PADS

# P 1024, H 256 at layer 2; in float32 its crossover (86.8) lies where the
# card, not the host, sets the step on both sides
SYNTH_SHAPE = "tree_of_life"
SYNTH_DTYPE = "float32"
EDGE_FACTORS = (0.5, 2.0)
SYNTH_POOL = 16
TURNS = ("dense", "sized", "sized", "dense")
PROFILE_TOP = 60     # enough kernels that densify's scatter is listed


def spec_of(name, s):
    """The layer spec bench_shape trains for a recipe's shape."""
    meta = bench.REPLICA_META[name]
    return bench.shape_spec(s, meta["feat"], meta["n_out"])


def sweep_crossover(path, dtype, P, H):
    """The crossover at (dtype, P, H) in a bench_kernels --crossover JSON
    (the lower of its fills' crossings), or None."""
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        cross = json.load(f)["crossover"]
    tag = {"float32": "f32", "bfloat16": "bf16"}[dtype]
    found = [c["edges_per_slot"] for k, c in cross.items()
             if k.startswith(f"{tag} P={P} H={H} ") and c["edges_per_slot"]]
    return min(found) if found else None


def synth_record(rec, per_slot):
    """A run of record's dict at `rec`'s buckets and fill with `per_slot`
    real edges per slot, E of each set grown to hold its share of them
    with SWEEP_PADS pad slots per real edge."""
    b = dict(rec["buckets"])
    slots = b["B_spt"] * b["P_spt"] + b["B_qry"] * b["P_qry"]
    edges = per_slot * slots
    for k in ("spt", "qry"):
        share = b[f"B_{k}"] * b[f"P_{k}"] / slots
        b[f"E_{k}"] = round_up(int((1 + SWEEP_PADS) * edges * share) + 1,
                               2048)
    return {"buckets": b, "mean_bin_fill": rec["mean_bin_fill"],
            "agg": "dense", "tasks_per_s": 1.0, "edges_per_s": edges,
            "preset_overrides": {"device_task_pool": True}}


# densify's scatter in a profile: scatter_add_'s kernel (whose name the
# gathers of torch.gather share, so a sum over these is an upper bound),
# or the sorted index_put_ it replaced
SCATTER = ("scatter_gather", "indexing_backward", "index_put")


def reading(r) -> dict:
    """A run's numbers, its six largest kernels and densify's scatter
    (ms of the profiled step, summed over the kernels SCATTER names)."""
    prof = r["profile"]
    return {"tasks_per_s": r["tasks_per_s"], "step_s": r["step_s"],
            "mfu": r["mfu"], "peak_gb": r["peak_gb"],
            "busy_share": prof and prof["busy_share"],
            "busy_ms": prof and prof["busy_ms"],
            "top": prof and prof["top"][:6],
            "scatter_ms": prof and sum(
                ms for k, ms in prof["top"]
                if any(n in k for n in SCATTER))}


def run_geometry(name, rec, device, steps, pool,
                 dtype="bfloat16") -> dict:
    s = bench.SHAPES[name]
    geo = bench.record_geometry(rec)
    spec = spec_of(name, s)
    P = max(geo.P_spt, geo.P_qry)
    H = aggregation_width(spec)
    data = bench.shape_data(name, s, rec=rec, pool=pool)
    runs = {"dense": [], "sized": []}
    for agg in TURNS:
        runs[agg].append(reading(bench.bench_shape(
            name, s, agg=agg, device=device, steps=steps, data=data,
            dtype=getattr(torch, dtype), profile_top=PROFILE_TOP)))
    mean = {a: sum(r["tasks_per_s"] for r in rs) / len(rs)
            for a, rs in runs.items()}
    return {"shape": name, "buckets": geo._asdict(),
            "edges_per_slot": edges_per_slot(geo), "P": P, "H": H,
            "dtype": dtype, "crossover": card_crossover(P, H, dtype),
            "auto_card": agg_for(geo, torch.device("cuda"), spec, dtype),
            "auto_cpu": agg_for(geo, torch.device("cpu"), spec, dtype),
            "record_agg": rec.get("agg"),
            "runs": runs, "mean_tasks_per_s": mean,
            "faster": max(mean, key=mean.get)}


def main(argv=None) -> dict:
    ap = common.parser("bench_agg", __doc__)
    ap.add_argument("--sweep", default=str(common.OUT_DIR
                                          / "bench_crossover.json"))
    ap.add_argument("--steps", type=int, default=bench.MEASURE_STEPS)
    args = ap.parse_args(argv)
    device, head = common.start(args.device)
    rows = {}
    for name in bench.SHAPES:
        rec = bench._load_parity(name)
        if rec is not None:
            rows[name] = run_geometry(name, rec, device, args.steps,
                                      bench.POOL)
    base = bench._load_parity(SYNTH_SHAPE)
    s = bench.SHAPES[SYNTH_SHAPE]
    P = max(base["buckets"]["P_spt"], base["buckets"]["P_qry"])
    H = aggregation_width(spec_of(SYNTH_SHAPE, s))
    swept = sweep_crossover(args.sweep, SYNTH_DTYPE, P, H)
    cross = swept or card_crossover(P, H, SYNTH_DTYPE)
    for f in EDGE_FACTORS:
        key = f"{SYNTH_SHAPE}@{f:g}x_crossover"
        rows[key] = run_geometry(SYNTH_SHAPE, synth_record(base, f * cross),
                                 device, args.steps, SYNTH_POOL, SYNTH_DTYPE)
        rows[key]["factor"] = f
    table = ["| geometry | edges/slot | crossover | auto card / cpu |"
             " dense tasks/s | sized tasks/s | faster |",
             "|---|---|---|---|---|---|---|"]
    for key, r in rows.items():
        table.append(
            f"| {key} | {common.fmt(r['edges_per_slot'])} | "
            f"{common.fmt(r['crossover'], 1)} | {r['auto_card']} / "
            f"{r['auto_cpu']} | "
            + " | ".join(", ".join(common.fmt(x["tasks_per_s"], 2)
                                   for x in r["runs"][a])
                         for a in ("dense", "sized"))
            + f" | {r['faster']} |")
    return common.finish(dict(head, geometries=rows, turns=list(TURNS),
                              steps=args.steps,
                              sweep_crossover=swept,
                              synthetic_crossover=cross), args.out, table)


if __name__ == "__main__":
    main()
