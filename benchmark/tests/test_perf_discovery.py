"""Cells, configurations, traffic mixes and per-layer metrics are found by
name: a later change adds them as files and entries and edits none."""

import json

import pytest

from benchmark.cell import ROOT, load_cell, load_metric, reported
from conftest import TINY_LIMITS


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.cfg["name"] == w["config"]
        assert cell.traffic["mode"] == "compact_pool"
        assert set(cell.limits) == {"loss", "grad1", "update3"}
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer
        for m in cell.per_layer:
            mod = load_metric(m["name"])
            assert mod.UNIT == m["unit"] and callable(mod.read)


def test_reported_follows_workloads_then_moves():
    m = {"name": "x", "moves": "tasks_per_s", "workloads": ["a.pool"]}
    assert reported(m, "a.pool", []) and not reported(m, "b.pool", [])
    free = {"name": "y", "moves": "tasks_per_s"}
    assert reported(free, "b.pool", ["tasks_per_s"])
    assert not reported(free, "b.pool", ["ttft_ms"])
    assert reported({"name": "setup_s"}, "any", [])


def test_a_configuration_mix_metric_and_cell_added_as_files(checkout):
    """A throwaway configuration, mix and metric, added to a copy as new
    files and entries only, run through discovery and a whole run."""
    from benchmark import harness
    from conftest import TINY

    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    cfg = dict(TINY["tiny_node"], name="added", hidden_dim=8)
    (checkout / "benchmark/configs/added.json").write_text(json.dumps(cfg))
    (checkout / "benchmark/traffic/added_mix.json").write_text(
        json.dumps({"mode": "compact_pool", "agg": "dense"}))
    (checkout / "benchmark/metrics/steps_seen.py").write_text(
        "UNIT = 'steps'\n\n\ndef read(ctx):\n    return ctx.trace.steps\n")
    (checkout / "benchmark/limits/added.added_mix.json").write_text(
        json.dumps(TINY_LIMITS))
    bench["configs"].append({"name": "added", "source": "test",
                             "file": "benchmark/configs/added.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "added.added_mix", "config": "added",
                               "traffic": "added_mix", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "steps_seen", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "test", "moves": "tasks_per_s",
                               "workloads": ["added.added_mix"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell("added.added_mix", checkout)
    assert cell.cfg["hidden_dim"] == 8 and cell.traffic["agg"] == "dense"
    assert "steps_seen" in [m["name"] for m in cell.per_layer]
    out = harness.run(cell, 7, 0.2, True, "cpu", 0.0, log=lambda m: None)
    assert out["agg"] == "dense" and set(out["checks"]) == set(TINY_LIMITS)
    assert out["per_layer"]["steps_seen"] == {"value": out["steps"],
                                              "unit": "steps"}
    # the others are untouched by the addition
    assert load_cell("tiny_node.pool", checkout).cfg["hidden_dim"] == 12


def test_an_unknown_cell_is_refused(checkout):
    with pytest.raises(KeyError):
        load_cell("nope.pool", checkout)


# A stand-in for a second architecture: the GCN's pieces, its step's
# operations doubled, its theta and reference counted where they are used.
STAND_IN = """
from benchmark.models import gcn

calls = []


def make_theta(cfg, seed, device):
    calls.append("theta")
    return gcn.make_theta(cfg, seed, device)


class Reference(gcn.Reference):
    def __init__(self, cfg, **kw):
        calls.append("reference")
        super().__init__(cfg, **kw)


def step_flops(cfg):
    return 2 * gcn.step_flops(cfg)


aggregation_bound_ms = gcn.aggregation_bound_ms
"""


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in (root / "benchmark").rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _add_cell(root, cfg_name, model):
    """A configuration that names `model`, and a cell of it, added to the
    copy as new files and entries only; the cell's name."""
    from conftest import TINY

    bench = json.loads((root / "BENCHMARK.json").read_text())
    cfg = dict(TINY["tiny_node"], name=cfg_name, model=model)
    path = f"benchmark/configs/{cfg_name}.json"
    (root / path).write_text(json.dumps(cfg))
    cell = f"{cfg_name}.tiny"
    (root / f"benchmark/limits/{cell}.json").write_text(
        json.dumps(TINY_LIMITS))
    bench["configs"].append({"name": cfg_name, "source": "test",
                             "file": path, "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": cfg_name,
                               "traffic": "tiny", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


def test_a_model_added_as_a_file(checkout):
    """A configuration names its model, and one new file under
    benchmark/models/ gives its theta, reference and counts: discovery,
    a traced run that uses them and is correct, and `mfu` from the new
    count, with no file of the benchmark touched."""
    import types

    from benchmark import harness
    from benchmark.cell import load_model
    from benchmark.trace import Trace
    from conftest import SEEDS

    before = _files(checkout)
    (checkout / "benchmark/models/gcn_x2.py").write_text(STAND_IN)
    name = _add_cell(checkout, "added_model", "gcn_x2")
    after = _files(checkout)
    assert {k: v for k, v in after.items() if k in before} == before
    assert set(after) - set(before) == {
        p.relative_to(checkout) for p in (
            checkout / "benchmark/models/gcn_x2.py",
            checkout / "benchmark/configs/added_model.json",
            checkout / f"benchmark/limits/{name}.json")}

    cell = load_cell(name, checkout)
    assert cell.model.__file__ == str(checkout / "benchmark/models/gcn_x2.py")
    out = harness.run(cell, SEEDS["tiny_node.pool"], 0.2, True, "cpu", 0.0,
                      log=lambda m: None)
    assert cell.model.calls == ["theta", "reference"]
    assert out["correct"], out["checks"]
    assert {"mfu", "agg_roofline"} <= {m["name"] for m in cell.per_layer}
    assert "mfu" in out["per_layer"]

    gcn = load_cell("tiny_node.pool", checkout)
    assert gcn.model.__file__ == str(checkout / "benchmark/models/gcn.py")
    assert load_model(gcn.cfg, checkout).__file__ == gcn.model.__file__
    trace = Trace((0, 2_000_000_000), [(0, 10**9, "csr_gather_kernel")],
                  [], 5)

    def read(metric, c):
        ctx = types.SimpleNamespace(trace=trace, cfg=c.cfg, model=c.model,
                                    traffic=c.traffic, agg="sized")
        return load_metric(metric, checkout).read(ctx)
    assert read("mfu", cell) == 2 * read("mfu", gcn) > 0
    assert read("agg_roofline", cell) == read("agg_roofline", gcn) > 0


def test_a_configuration_naming_a_missing_model_is_refused(checkout):
    from benchmark.cell import load_model

    name = _add_cell(checkout, "no_model", "nope")
    with pytest.raises(KeyError, match="models/nope.py"):
        load_cell(name, checkout)
    with pytest.raises(KeyError, match="models/nope.py"):
        load_model({"name": "no_model", "model": "nope"}, checkout)
