"""The yardstick's arithmetic against hand counts."""

import json

import pytest

from benchmark.cell import ROOT
from benchmark.counts import model, peaks

# one set: 2 bins of 4 live nodes of 8 slots, 6 real edges, 3 centres
SMALL = {"buckets": {"P_spt": 8, "B_spt": 2, "E_spt": 12, "P_qry": 8,
                     "B_qry": 2, "E_qry": 12},
         "mean_bin_fill": 0.5, "mean_edges_per_task": 12.0,
         "n_way": 3, "k_spt": 1, "k_qry": 1, "feat_dim": 5,
         "hidden_dim": 3, "h": 2, "link_pred_mode": False,
         "labels_num": 3, "update_step": 2, "track_train_curve": True,
         "task_num": 2}


def test_published_h100_sxm_peaks():
    assert peaks.FP32_PEAK == 67e12
    assert peaks.BF16_PEAK == 989e12
    assert peaks.HBM_BYTES_S == 3.35e12


def test_set_shapes_split_the_edges_by_slots():
    spt, qry = model.set_shapes(SMALL)
    assert spt == model.SetShape(B=2, P=8, E=12, S=3, live=4, edges=6)
    assert spt.nodes == 8 and qry == spt


def test_pass_flops_by_hand():
    s = model.SetShape(B=2, P=8, E=12, S=3, live=4, edges=6)
    # layer 1 (5 -> 3) projects first: 2*8*5*3 = 240, aggregates at 3:
    # 2*6*3 = 36; layer 2 (3 -> 3): 2*8*3*3 = 144 + 2*6*3 = 36; head
    # 2*3*3*3 = 54
    assert model.forward_flops(s, SMALL) == 240 + 36 + 144 + 36 + 54
    # layer 1: dW 240, transpose 36 (projected first); layer 2: dW and dX
    # 288, transpose 36; head 4*3*3*3 = 108
    assert model.backward_flops(s, SMALL) == 240 + 36 + 288 + 36 + 108
    wide = dict(SMALL, feat_dim=2)   # aggregates first: no transpose
    assert model.backward_flops(s, wide) == 2 * 8 * 2 * 3 + 288 + 36 + 108


def test_step_flops_and_passes():
    p = model.passes(SMALL)
    assert p == {"spt_fwd": 3, "spt_bwd": 3, "qry_fwd": 3, "qry_bwd": 1}
    assert model.passes(dict(SMALL, track_train_curve=False)) == \
        {"spt_fwd": 2, "spt_bwd": 3, "qry_fwd": 1, "qry_bwd": 1}
    f, b = 510, 708
    assert model.step_flops(SMALL) == 2 * (3 * f + 3 * b + 3 * f + b)


def test_link_head_joins_both_endpoints():
    gcn, head = model.layers(dict(SMALL, link_pred_mode=True,
                                  labels_num=2))
    assert gcn == [(5, 3), (3, 3)] and head == (6, 2)


def test_gather_bound_by_hand():
    ms, kind, nbytes = peaks.gather_bound(1000, 256, 400, 500)
    assert nbytes == 4 * (400 * 256 + 500 * 256) + 4 * (500 + 1 + 1000)
    assert kind == "bytes"
    assert ms == pytest.approx(1e3 * nbytes / 3.35e12)
    ms, kind, _ = peaks.gather_bound(10**9, 256, 1, 1)
    assert kind == "operations"
    assert ms == pytest.approx(1e3 * 2 * 10**9 * 256 / 67e12)


def test_aggregation_calls_by_hand():
    calls = model.aggregation_calls(SMALL)
    # per set: layer 1 at width 3 (fwd 3 + bwd 3 for spt), layer 2 the same
    assert calls == [(6, 12, 3, 16), (6, 12, 3, 16),
                     (4, 12, 3, 16), (4, 12, 3, 16)]
    assert model.aggregation_bound_ms(SMALL) == pytest.approx(sum(
        c * peaks.gather_bound(n, h, r, r)[0] for c, n, h, r in calls))


@pytest.mark.parametrize("name", ["arxiv", "tree_of_life"])
def test_configurations_count(name):
    cfg = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
    spt, qry = model.set_shapes(cfg)
    assert spt.edges + qry.edges == pytest.approx(
        cfg["mean_edges_per_task"], abs=1)
    assert spt.edges <= spt.E and qry.edges <= qry.E
    assert 1e11 < model.step_flops(cfg) < 1e13
