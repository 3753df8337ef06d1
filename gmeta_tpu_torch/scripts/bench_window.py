"""How the bench's tasks/s spreads with the length of its timed window, on
the shapes whose card idles most of a step (tissue_ppi, fold_ppi,
firstmm_db: the host sets their step).

The port's own script; the JAX package has none. Per shape it runs
gmeta_tpu_torch/bench.py's `bench_shape` with the record's aggregation at
windows of WINDOWS meta-steps in turns, REPEATS times, in one process on
one pool, and records for each window every reading's tasks/s and
step_s, the profiled step's busy share, and the spread (the largest
reading over the smallest).

    python -m gmeta_tpu_torch.scripts.bench_window [--device cpu] [--out PATH]
"""

from __future__ import annotations

from gmeta_tpu_torch import bench
from gmeta_tpu_torch.scripts import common

SHAPES = ("tissue_ppi", "fold_ppi", "firstmm_db")
WINDOWS = (16, 128)
REPEATS = 3


def main(argv=None) -> dict:
    args = common.parser("bench_window", __doc__).parse_args(argv)
    device, head = common.start(args.device)
    shapes = {}
    for name in SHAPES:
        s = bench.SHAPES[name]
        data = bench.shape_data(name, s, pool=bench.POOL)
        runs = {w: [] for w in WINDOWS}
        for _ in range(REPEATS):
            for w in WINDOWS:
                r = bench.bench_shape(name, s, device=device, steps=w,
                                      data=data)
                busy = r["profile"] and r["profile"]["busy_share"]
                runs[w].append((r["tasks_per_s"], r["step_s"], busy))
        shapes[name] = {"agg": data.agg, "windows": {
            str(w): {"tasks_per_s": [t for t, _, _ in rs],
                     "step_s": [st for _, st, _ in rs],
                     "busy_share": [b for _, _, b in rs],
                     "spread": (max(t for t, _, _ in rs)
                                / min(t for t, _, _ in rs))}
            for w, rs in runs.items()}}
        del data
    table = ["| shape | window | tasks/s | spread |", "|---|---|---|---|"]
    for name, row in shapes.items():
        for w, r in row["windows"].items():
            table.append(f"| {name} | {w} | "
                         + ", ".join(common.fmt(t, 2) for t in r["tasks_per_s"])
                         + f" | {common.fmt(r['spread'])} |")
    return common.finish(dict(head, shapes=shapes, windows=list(WINDOWS),
                              repeats=REPEATS), args.out, table)


if __name__ == "__main__":
    main()
