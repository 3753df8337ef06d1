"""`correct` comes out false when the timed path is broken underneath a
whole run (the look for a card skipped, on the CPU at a tiny size), and
when the control, the plain reference in TF32, stands in the program's
place; a sound run comes out true."""

import pytest
import torch

from benchmark import control, correct, harness
from benchmark.cell import load_cell
from conftest import SEEDS, TINY_LIMITS

CELLS = ("tiny_node.pool", "tiny_link.pool")


def run(cell):
    return harness.run(cell, SEEDS[cell.name], 0.2, False, "cpu", 0.0,
                       log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(checkout, name):
    out = run(load_cell(name, checkout))
    assert out["correct"], out["checks"]
    assert out["tasks"] > 0 and out["failed"] == 0
    assert list(out["checks"]) == ["loss", "grad1", "update3"]


@pytest.mark.parametrize("name", CELLS)
def test_a_step_that_leaves_the_state_unchanged_fails(checkout, name,
                                                      monkeypatch):
    from gmeta_tpu_torch.meta import maml

    def unchanged(grads, state, params, lr, **kw):
        return tuple(params), state
    monkeypatch.setattr(maml, "adam_update", unchanged)
    out = run(load_cell(name, checkout))
    assert not out["correct"]
    assert out["checks"]["update3"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_fails(checkout, name, monkeypatch):
    from gmeta_tpu_torch.meta import maml

    step = maml.MetaLearner.train_step

    def half(self, batch):
        T = batch.spt.node_gid.shape[0]
        return step(self, maml.take_tasks(batch, slice(0, T // 2)))
    monkeypatch.setattr(maml.MetaLearner, "train_step", half)
    out = run(load_cell(name, checkout))
    assert not out["correct"]
    assert out["checks"]["grad1"]["value"] > 10 * TINY_LIMITS["grad1"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(checkout, name):
    r = control.readings(load_cell(name, checkout), SEEDS[name],
                         torch.device("cpu"))
    assert correct.judge(r["program"], TINY_LIMITS)[0]
    assert not correct.judge(r["control"], TINY_LIMITS)[0]
    assert not correct.judge(r["half_batch"], TINY_LIMITS)[0]
    assert r["control"]["grad1"] > 3 * r["program"]["grad1"]


def test_judge_reads_nan_as_a_failure():
    ok, checks = correct.judge({"loss": float("nan"), "grad1": 0.0,
                                "update3": 0.0}, TINY_LIMITS)
    assert not ok and checks["grad1"] == {"value": 0.0,
                                          "limit": TINY_LIMITS["grad1"]}
