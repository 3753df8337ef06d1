"""The result's line, the run's refusals, and what the benchmark loads."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.cell import ROOT, load_cell
from conftest import SEEDS

sys.path.insert(0, str(ROOT / "benchmark"))
import run as run_mod  # noqa: E402


@pytest.mark.parametrize("trace", [False, True])
def test_the_line(checkout, trace):
    cell = load_cell("tiny_node.pool", checkout)
    out = harness.run(cell, SEEDS[cell.name], 0.2, trace, "cpu", 0.0,
                      log=lambda m: None)
    line = json.loads(json.dumps(run_mod.result_line(out, cell, trace, "x")))
    assert list(line) == (["correct", "attempted", "failed", "metrics",
                           "device"] + (["breakdown"] if trace else [])
                          + ["checks"])
    assert line["correct"] is True and line["attempted"] == out["tasks"]
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert isinstance(dev["memory_peak_bytes"], int)
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert "busy_s" in dev and dev["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "idle_share" in line["metrics"] and "mfu" in line["metrics"]
    else:
        assert set(line["metrics"]) == {"tasks_per_s", "peak_mem_gb",
                                        "setup_s"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def _python(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_it_exits_and_prints_no_result(tmp_path):
    if __import__("torch").cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(ROOT / "benchmark/run.py"),
                        "--workload", "arxiv.pool", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gmeta_tpu_torch_x", sys)
    assert run_mod.forbidden_modules() == [] or \
        "gmeta_tpu_torch_x" not in run_mod.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gmeta_tpu.sub", sys)
    assert "gmeta_tpu" in run_mod.forbidden_modules()


def test_a_whole_run_loads_no_jax_nor_the_jax_package(tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(ROOT / 'benchmark/tests')!r})
from pathlib import Path
from conftest import make_checkout
from benchmark import harness
from benchmark.cell import load_cell
root = make_checkout(Path({str(tmp_path)!r}))
out = harness.run(load_cell("tiny_link.pool", root), 2, 0.1, True, "cpu",
                  0.0, log=lambda m: None)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    roots = set(eval(r.stdout.strip().splitlines()[-1]))
    assert "gmeta_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "flax", "gmeta_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    r = _python("import sys, json\n"
                "import benchmark.reference.protomaml, benchmark.correct\n"
                "import benchmark.generate, benchmark.counts.model\n"
                "import benchmark.models.gcn\n"
                "from benchmark.cell import ROOT, load_model\n"
                "cfg = json.loads((ROOT / 'benchmark/configs/arxiv.json')"
                ".read_text())\n"
                "assert load_model(cfg).Reference\n"
                "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert r.returncode == 0, r.stderr
    roots = set(eval(r.stdout.strip().splitlines()[-1]))
    assert not roots & {"gmeta_tpu_torch", "gmeta_tpu", "jax"}
