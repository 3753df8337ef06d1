"""Run one cell of the benchmark and print its result as one JSON line.

    python3 benchmark/run.py --workload arxiv.pool --seed 7 --seconds 20 \
        --trace 0

With `--trace 0` the line carries the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a torch.profiler trace of the
window's first calls (harness.TRACE_SECONDS), with the device's busy time
and the breakdown. Each number that decides `correct` is printed beside its
limit as the last lines on standard error and under the line's last key.
Without CUDA, or with fewer cards than the cell asks for, it exits 2 and
prints no result; so too when JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FORBIDDEN = ("jax", "jaxlib", "flax", "gmeta_tpu")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's own name only begins like the latter)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(out: dict, cell, trace: bool, kind: str) -> dict:
    """The result's line from a harness run: `checks` last."""
    dev = {"platform": "gpu", "kind": kind, "count": cell.chips,
           "memory_peak_bytes": out["peak_bytes"]}
    if trace:
        metrics = out["per_layer"]
        dev.update(busy_s=out["busy_s"], window_s=out["traced_window_s"])
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {k: {"value": v, "unit": units[k]}
                   for k, v in out["end_to_end"].items() if k in units}
    line = {"correct": out["correct"], "attempted": out["tasks"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if trace:
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness
    from benchmark.cell import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"this cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    from gmeta_tpu_torch.utils.device import resolve_device
    device = resolve_device("cuda:0")

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START, log)
    found = forbidden_modules()
    if found:
        log(f"# loaded in this process: {', '.join(found)}")
        return 2

    line = result_line(out, cell, bool(args.trace),
                       torch.cuda.get_device_name(device))
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
