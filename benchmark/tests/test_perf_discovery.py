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
