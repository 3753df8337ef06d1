"""The benchmark's own tests: CPU tests of the harness, the counts and the
plain reference, at small sizes. Run from the root of the checkout:

    python3 -m pytest benchmark/tests -q

Tests that need the card carry the `cuda` marker and skip without one.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where CUDA is absent")


# Small configurations with the published ones' structure: two GraphConv
# layers, one projecting first where it shrinks the rows, a node and a
# link head, remat on and off.
TINY = {
    "tiny_node": {
        "name": "tiny_node", "task_setup": "Disjoint",
        "link_pred_mode": False, "n_way": 3, "k_spt": 2, "k_qry": 3, "h": 2,
        "batchsz": 24, "task_num": 4, "hidden_dim": 12, "update_lr": 0.05,
        "meta_lr": 0.01, "update_step": 3, "update_step_test": 3,
        "train_result_report_steps": 200, "first_order": True,
        "track_train_curve": True, "seed": 222, "dtype": "float32",
        "device_task_pool": True, "remat_inner": True, "feat_dim": 16,
        "labels_num": 3, "feature_rows": 600,
        "buckets": {"P_spt": 32, "B_spt": 2, "E_spt": 128, "P_qry": 32,
                    "B_qry": 3, "E_qry": 192},
        "mean_bin_fill": 0.6, "mean_edges_per_task": 200.0},
    "tiny_link": {
        "name": "tiny_link", "task_setup": "Shared", "link_pred_mode": True,
        "n_way": 2, "k_spt": 4, "k_qry": 4, "h": 2, "batchsz": 16,
        "task_num": 2, "hidden_dim": 12, "update_lr": 0.05, "meta_lr": 0.01,
        "update_step": 3, "update_step_test": 3,
        "train_result_report_steps": 200, "first_order": True,
        "track_train_curve": False, "seed": 222, "dtype": "float32",
        "device_task_pool": True, "remat_inner": False, "feat_dim": 1,
        "labels_num": 2, "feature_rows": 600,
        "buckets": {"P_spt": 32, "B_spt": 3, "E_spt": 256, "P_qry": 32,
                    "B_qry": 2, "E_qry": 192},
        "mean_bin_fill": 0.5, "mean_edges_per_task": 300.0},
}

# Seeds and limits for the tiny cells, from their CPU readings
# (benchmark/control.py and a run's checks over seeds 1-12): the program
# reads up to 1.3e-7 / 1.3e-6 (loss, grad1) on every seed and 7e-6 in
# update3 at these seeds; the TF32 control's grad1 2e-4 and more on every
# seed; half the batch 5e-2 and more in update3. On other seeds
# tiny_link's update3 reaches 8e-3: Adam's first step moves a parameter
# by the sign of a gradient that is nought to rounding.
SEEDS = {"tiny_node.pool": 7, "tiny_link.pool": 1}
TINY_LIMITS = {"loss": 1e-6, "grad1": 2e-5, "update3": 1e-3}


def make_checkout(tmp: Path, agg: str = "sized") -> Path:
    """A copy of the benchmark's folder under tmp with a BENCHMARK.json of
    the two tiny configurations, one cell each."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"], bench["workloads"] = [], []
    (tmp / "benchmark" / "traffic" / "tiny.json").write_text(json.dumps(
        {"mode": "compact_pool", "agg": agg}))
    for name, cfg in TINY.items():
        path = f"benchmark/configs/{name}.json"
        (tmp / path).write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": path, "reduced": [], "why": "test"})
        cell = f"{name}.pool"
        bench["workloads"].append({"name": cell, "config": name,
                                   "traffic": "tiny", "chips": 1,
                                   "why": "test"})
        (tmp / "benchmark" / "limits" / f"{cell}.json").write_text(
            json.dumps(TINY_LIMITS))
    for m in bench["per_layer"]:
        m["workloads"] = [w["name"] for w in bench["workloads"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


@pytest.fixture
def checkout(tmp_path):
    return make_checkout(tmp_path)
