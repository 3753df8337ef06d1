"""Finding a cell's pieces by name.

`BENCHMARK.json`, at the root of the checkout, names each cell's
configuration and traffic mix; everything else is found by name in files of
its own, so that a later change adds a configuration, a mix, a metric or a
cell by adding files and entries, and edits none:

- a configuration: the file its `configs` entry names;
- a configuration's model: `models/<model>.py`, by the configuration's
  `model` key (`gcn` where the key is absent), a module that gives
  `make_theta(cfg, seed, device)`, the plain reference `Reference`,
  `step_flops(cfg)` and `aggregation_bound_ms(cfg, itemsize=4)`. `model`
  is also the name of the program's `Config` field that will select the
  architecture: `harness.program_config` passes every key that is a
  `Config` field on, and leaves this one out until the field exists;
- a traffic mix: `traffic/<mix>.json`;
- a per-layer metric: `metrics/<metric>.py`, a reader with a `UNIT` and a
  `read(ctx)` that returns a number or None (nothing to read here);
- the limits of a cell's comparison: `limits/<cell>.json`.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    cfg: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict
    chips: int
    root: Path
    model: ModuleType


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reported(metric: dict, cell: str, end_to_end: List[str]) -> bool:
    """Whether a cell reports a metric: those named in its `workloads`, or
    without that key every cell that reports the end-to-end metric it
    moves (an end-to-end metric without the key: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in end_to_end


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _load(root / "BENCHMARK.json")
    here = root / HERE.name
    work = next((w for w in bench["workloads"] if w["name"] == name), None)
    if work is None:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == work["config"])
    e2e = [m for m in bench["end_to_end"] if reported(m, name, [])]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"]
                 if reported(m, name, e2e_names)]
    cfg = _load(root / conf["file"])
    return Cell(name=name, cfg=cfg,
                traffic=_load(here / "traffic" / f"{work['traffic']}.json"),
                end_to_end=e2e, per_layer=per_layer,
                limits=_load(here / "limits" / f"{name}.json"),
                chips=int(work["chips"]), root=root,
                model=load_model(cfg, root))


def _load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str, root: Path = ROOT) -> ModuleType:
    """The reader module of a per-layer metric."""
    return _load_module(root / HERE.name / "metrics" / f"{name}.py",
                        f"benchmark_metric_{name.replace('.', '_')}")


def load_model(cfg: dict, root: Path = ROOT) -> ModuleType:
    """The module of a configuration's model (module docstring); a
    KeyError naming the file where there is none."""
    name = cfg.get("model", "gcn")
    path = root / HERE.name / "models" / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"configuration {cfg.get('name')!r} names the model "
                       f"{name!r}, and there is no {path}")
    return _load_module(path, f"benchmark_model_{name.replace('.', '_')}")
