"""The Graphormer configuration and its cell: found by name, a tiny copy run
whole through the harness on the CPU and correct, its faults and its
control refused, the counts by hand, the readers, and the two copies of
the plain reference held to the same bits."""

import json
import math
import sys
import types

import pytest
import torch

from benchmark import control, harness
from benchmark.cell import ROOT, load_cell, load_metric, load_model
from benchmark.counts.model import set_shapes
from benchmark.counts.peaks import FP32_PEAK, HBM_BYTES_S
from benchmark.reference import graphormer_protomaml
from benchmark.trace import Trace
from conftest import TINY

TINY_GRAPHORMER = dict(
    TINY["tiny_node"], name="tiny_graphormer", model="graphormer",
    arch="graphormer", task_setup="Shared", n_way=2, k_spt=2, k_qry=3,
    labels_num=2, remat_inner=False, graphormer_layers=2,
    graphormer_hidden=8, graphormer_heads=2, graphormer_ffn=6, feat_dim=5)
SEED = 11
LIMITS = {"loss": 1e-6, "grad1": 2e-5, "update3": 1e-3}
NEW = ("sattn_ms_per_step", "sattn_fwd_roofline", "sattn_bwd_roofline",
       "spd_ms_per_step")


@pytest.fixture
def graphormer_cell(checkout):
    """The tiny Graphormer configuration and a cell of it, added to the
    tiny checkout as new files and entries."""
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    path = "benchmark/configs/tiny_graphormer.json"
    (checkout / path).write_text(json.dumps(TINY_GRAPHORMER))
    name = "tiny_graphormer.pool"
    (checkout / f"benchmark/limits/{name}.json").write_text(
        json.dumps(LIMITS))
    bench["configs"].append({"name": "tiny_graphormer", "source": "test",
                             "file": path, "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": "tiny_graphormer",
                               "traffic": "tiny", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(name)
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    return load_cell(name, checkout)


def test_the_cell_finds_its_model_reference_and_limits():
    cell = load_cell("graphormer_ppi.pool")
    assert cell.cfg["model"] == "graphormer" and cell.chips == 1
    assert cell.model.__file__ == str(ROOT / "benchmark/models/graphormer.py")
    assert cell.model.Reference is graphormer_protomaml.Reference
    assert set(cell.limits) == {"loss", "grad1", "update3"}
    assert {m["name"] for m in cell.per_layer} == set(NEW)
    pcfg = harness.program_config(cell.cfg)
    assert pcfg.arch == "graphormer" and (
        pcfg.graphormer_layers, pcfg.graphormer_hidden,
        pcfg.graphormer_heads, pcfg.graphormer_ffn) == (12, 80, 8, 80)
    theta = cell.model.make_theta(cell.cfg, 3, torch.device("cpu"))
    assert sum(t.numel() for t in theta) == 560_818
    with pytest.raises(ValueError, match="arch 'graphormer'"):
        cell.model.make_theta(dict(cell.cfg, arch="gat"), 3, "cpu")


def run(cell, trace=False):
    return harness.run(cell, SEED, 0.2, trace, "cpu", 0.0,
                       log=lambda m: None)


def test_a_tiny_graphormer_runs_whole_and_correct(graphormer_cell):
    out = run(graphormer_cell)
    assert out["correct"], out["checks"]
    assert out["agg"] == "sized" and out["failed"] == 0
    traced = run(graphormer_cell, trace=True)
    assert traced["correct"], traced["checks"]


def test_half_the_batch_and_an_unchanged_state_fail(graphormer_cell,
                                                    monkeypatch):
    from gmeta_tpu_torch.meta import maml

    step = maml.MetaLearner._train_step

    def half(self, batch, segs=None):
        """The meta-step of the first half of the batch's tasks: every
        way into a meta-step passes here."""
        sl = slice(0, batch.spt.node_gid.shape[0] // 2)
        return step(self, maml.take_tasks(batch, sl),
                    maml._take_tasks_of(segs, sl))
    with monkeypatch.context() as m:
        m.setattr(maml.MetaLearner, "_train_step", half)
        out = run(graphormer_cell)
    assert not out["correct"]
    assert out["checks"]["grad1"]["value"] > 10 * LIMITS["grad1"]

    def unchanged(grads, state, params, lr, **kw):
        return tuple(params), state
    monkeypatch.setattr(maml, "adam_update", unchanged)
    out = run(graphormer_cell)
    assert not out["correct"]
    # each leaf's gap is min(its change / the median leaf's change, 1) of
    # the reference's: the median of those is 1 but where the leaves
    # below the median take it
    assert out["checks"]["update3"]["value"] > 0.99


def test_the_control_fails(graphormer_cell):
    r = control.readings(graphormer_cell, SEED, torch.device("cpu"))
    assert all(r["program"][k] <= v for k, v in LIMITS.items())
    assert any(r["control"][k] > v for k, v in LIMITS.items())


def test_counts_by_hand():
    cfg = TINY_GRAPHORMER
    model = load_model(cfg, ROOT)
    spt, qry = set_shapes(cfg)
    L, H, K, ffn, F = 2, 8, 2, 6, 5
    T, U = cfg["task_num"], cfg["update_step"]
    fwd = {"spt": U + 1, "qry": 1 + U}      # the curve is on
    bwd = {"spt": U + 1, "qry": 1}
    total = 0.0
    for name, s in (("spt", spt), ("qry", qry)):
        N, n = s.B * s.live, s.live
        proj = 2 * N * H * 3 * H + 2 * N * H * H + 2 * 2 * N * H * ffn
        att = s.B * K * 4 * n * n * (H // K)
        f = 2 * N * F * H + L * (proj + att) + 2 * s.S * H * 2
        b = 2 * N * F * H + 2 * L * (proj + att) + 4 * s.S * H * 2
        total += fwd[name] * f + bwd[name] * b
    assert model.step_flops(cfg) == pytest.approx(T * total, rel=1e-12)
    for direction, calls in (("fwd", fwd), ("bwd", bwd)):
        want = 0.0
        for name, s in (("spt", spt), ("qry", qry)):
            G, n = T * s.B, s.live
            nbytes = 4 * G * n * (4 * H + K) + G * n * n
            ops = 4 * G * n * n * H
            if direction == "bwd":
                nbytes += 4 * G * n * 4 * H
                ops *= 2
            want += L * calls[name] * 1e3 * max(nbytes / HBM_BYTES_S,
                                                 ops / FP32_PEAK)
        assert model.attention_bound_ms(cfg, direction) == pytest.approx(
            want, rel=1e-12)
    assert model.aggregation_bound_ms(cfg) == pytest.approx(
        model.attention_bound_ms(cfg, "fwd")
        + model.attention_bound_ms(cfg, "bwd"), rel=1e-12)


def test_the_published_cell_counts():
    """About 12 TFLOP a meta-step, 71% of it the attention."""
    from benchmark.counts.model import passes
    cell = load_cell("graphormer_ppi.pool")
    cfg, model = cell.cfg, cell.model
    flops = model.step_flops(cfg)
    assert 11.5e12 < flops < 12.5e12
    p = passes(cfg)
    attention = sum(
        cfg["task_num"] * cfg["graphormer_layers"]
        * (p[f"{name}_fwd"] + 2 * p[f"{name}_bwd"])
        * model._attention(s.B, s.live, cfg)
        for name, s in zip(("spt", "qry"), set_shapes(cfg)))
    assert 0.70 < attention / flops < 0.72
    for d in ("fwd", "bwd"):
        assert math.isfinite(model.attention_bound_ms(cfg, d))


def test_the_readers_find_nothing_without_the_kernels_and_spans():
    cell = load_cell("graphormer_ppi.pool")
    trace = Trace((0, 10**9), [(0, 10**8, "gat_attn_fwd_kernel")], [], 2)
    ctx = types.SimpleNamespace(trace=trace, cfg=cell.cfg, model=cell.model)
    for name in NEW:
        assert load_metric(name).read(ctx) is None
    trace = Trace((0, 10**9), [(0, 10**8, "sattn_fwd_kernel<10>"),
                               (0, 10**8, "sattn_bwd_key_kernel<10>"),
                               (0, 10**8, "sattn_bwd_query_kernel<10>"),
                               (0, 10**8, "sattn_bwd_delta_kernel"),
                               (0, 10**8, "sattn_bwd_table_kernel")], [], 2)
    ctx.trace = trace
    fwd = load_metric("sattn_fwd_roofline").read(ctx)
    assert fwd == pytest.approx(
        100 * cell.model.attention_bound_ms(cell.cfg, "fwd") * 2 / 1e3 / 0.1)
    bwd = load_metric("sattn_bwd_roofline").read(ctx)
    assert bwd == pytest.approx(
        100 * cell.model.attention_bound_ms(cell.cfg, "bwd") * 2 / 1e3 / 0.4)
    ctx.model = load_cell("arxiv.pool").model     # no attention bound
    assert load_metric("sattn_fwd_roofline").read(ctx) is None


def test_the_two_reference_copies_give_the_same_bits():
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        import graphormer_reference
    finally:
        sys.path.remove(str(ROOT / "tests"))
    from benchmark import generate
    cfg, dev = TINY_GRAPHORMER, torch.device("cpu")
    model = load_model(cfg, ROOT)
    theta = model.make_theta(cfg, 5, dev)
    theta = [t + 0.1 * torch.randn(t.shape, generator=torch.Generator()
                                   .manual_seed(i)) for i, t in
             enumerate(theta)]
    feats = generate.make_features(cfg, 5, dev)
    spt, qry = generate.make_pool(cfg, 4, 5, dev)
    steps = [[({k: v[t] for k, v in spt.items()},
               {k: v[t] for k, v in qry.items()}) for t in range(4)]]
    a = graphormer_protomaml.Reference(cfg).run(theta, steps, feats)
    b = graphormer_reference.Reference(cfg).run(theta, steps, feats)
    assert a["losses"] == b["losses"]
    assert all(torch.equal(x, y) for x, y in zip(a["grad1"], b["grad1"]))
    assert all(torch.equal(x, y) for x, y in zip(a["theta"], b["theta"]))
