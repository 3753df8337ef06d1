"""The GAT configuration and its cell: found by name, a tiny copy run whole
through the harness on the CPU and correct, its faults and its control
refused, the counts by hand, and the two copies of the plain reference
held to the same bits."""

import json
import math
import sys

import pytest
import torch

from benchmark import control, harness
from benchmark.cell import ROOT, load_cell, load_metric, load_model
from benchmark.counts.model import set_shapes
from benchmark.counts.peaks import FP32_PEAK, HBM_BYTES_S
from benchmark.reference import gat_protomaml
from conftest import TINY

TINY_GAT = dict(
    TINY["tiny_node"], name="tiny_gat", model="gat", arch="gat",
    task_setup="Shared", n_way=2, k_spt=2, k_qry=3, labels_num=2,
    remat_inner=False, gat_heads=2, gat_hidden=4, gat_out_heads=3,
    gat_out_dim=3, feat_dim=5)
SEED = 11
# Its readings on the CPU (control.py's, seeds 1-12): the program up to
# 1.4e-7 / 9.0e-6 / 7.1e-6 (loss / grad1 / update3); the TF32 control's
# grad1 5.1e-4 and more on every seed; half the batch's grad1 0.5 and more.
LIMITS = {"loss": 1e-6, "grad1": 2e-5, "update3": 1e-3}


@pytest.fixture
def gat_cell(checkout):
    """The tiny GAT configuration and a cell of it, added to the tiny
    checkout as new files and entries."""
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    path = "benchmark/configs/tiny_gat.json"
    (checkout / path).write_text(json.dumps(TINY_GAT))
    name = "tiny_gat.pool"
    (checkout / f"benchmark/limits/{name}.json").write_text(
        json.dumps(LIMITS))
    bench["configs"].append({"name": "tiny_gat", "source": "test",
                             "file": path, "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": "tiny_gat",
                               "traffic": "tiny", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        m["workloads"].append(name)
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    return load_cell(name, checkout)


def test_the_cell_finds_its_model_reference_and_limits():
    cell = load_cell("gat_ppi.pool")
    assert cell.cfg["model"] == "gat" and cell.chips == 1
    assert cell.model.__file__ == str(ROOT / "benchmark/models/gat.py")
    assert cell.model.Reference is gat_protomaml.Reference
    assert set(cell.limits) == {"loss", "grad1", "update3"}
    names = {m["name"] for m in cell.per_layer}
    assert names == {"attn_ms_per_step", "attn_fwd_roofline",
                     "attn_bwd_roofline"}
    assert harness.program_config(cell.cfg).arch == "gat"
    theta = cell.model.make_theta(cell.cfg, 3, torch.device("cpu"))
    assert sum(t.numel() for t in theta) == 1_851_161


def run(cell):
    return harness.run(cell, SEED, 0.2, False, "cpu", 0.0,
                       log=lambda m: None)


def test_a_tiny_gat_runs_whole_and_correct(gat_cell):
    out = run(gat_cell)
    assert out["correct"], out["checks"]
    assert out["agg"] == "sized" and out["failed"] == 0
    traced = harness.run(gat_cell, SEED, 0.2, True, "cpu", 0.0,
                         log=lambda m: None)
    assert traced["correct"], traced["checks"]


def test_half_the_batch_and_an_unchanged_state_fail(gat_cell, monkeypatch):
    from gmeta_tpu_torch.meta import maml

    step = maml.MetaLearner.train_step

    def half(self, batch):
        T = batch.spt.node_gid.shape[0]
        return step(self, maml.take_tasks(batch, slice(0, T // 2)))
    with monkeypatch.context() as m:
        m.setattr(maml.MetaLearner, "train_step", half)
        out = run(gat_cell)
    assert not out["correct"]
    assert out["checks"]["grad1"]["value"] > 10 * LIMITS["grad1"]

    def unchanged(grads, state, params, lr, **kw):
        return tuple(params), state
    monkeypatch.setattr(maml, "adam_update", unchanged)
    out = run(gat_cell)
    assert not out["correct"]
    assert out["checks"]["update3"]["value"] == pytest.approx(1.0)


def test_the_control_fails(gat_cell):
    r = control.readings(gat_cell, SEED, torch.device("cpu"))
    assert all(r["program"][k] <= v for k, v in LIMITS.items())
    assert any(r["control"][k] > v for k, v in LIMITS.items())


def test_counts_by_hand():
    cfg = TINY_GAT
    gat = load_model(cfg, ROOT)
    spt, qry = set_shapes(cfg)
    # layers (5 -> 2x4), (8 -> 2x4, skip), (8 -> 3x3, mean); head 3 -> 2
    widths = [(5, 2, 4), (8, 2, 4), (8, 3, 3)]
    T, K_in = cfg["task_num"], cfg["update_step"]
    fwd = {"spt": K_in + 1, "qry": 1 + K_in}     # the curve is on
    bwd = {"spt": K_in + 1, "qry": 1}
    total = 0.0
    for name, s in (("spt", spt), ("qry", qry)):
        n, M = s.B * s.live, s.edges + s.B * s.live
        f = sum(2 * n * i * k * w + 4 * n * k * w + 2 * M * k * w
                for i, k, w in widths) + 2 * s.S * 3 * 2
        b = sum(2 * n * i * k * w * (2 if li else 1) + 8 * n * k * w
                + 4 * M * k * w for li, (i, k, w) in enumerate(widths)) \
            + 4 * s.S * 3 * 2
        total += fwd[name] * f + bwd[name] * b
    assert gat.step_flops(cfg) == pytest.approx(T * total, rel=1e-12)

    for direction, calls in (("fwd", fwd), ("bwd", bwd)):
        want = 0.0
        for name, s in (("spt", spt), ("qry", qry)):
            n, E = T * s.B * s.live, T * s.edges
            for _, k, w in widths:
                ld = k * w + 2 * k
                if direction == "fwd":
                    nbytes = 4 * n * ld + 4 * n * k * w + 4 * n * k
                    ops = 2 * (E + n) * k * w
                else:
                    nbytes = 4 * n * ld * 2 + 4 * n * k * w * 2 + 4 * n * k
                    ops = 4 * (E + n) * k * w
                nbytes += 4 * (n + 1 + E)
                want += calls[name] * 1e3 * max(nbytes / HBM_BYTES_S,
                                                ops / FP32_PEAK)
        assert gat.attention_bound_ms(cfg, direction) == pytest.approx(
            want, rel=1e-12)
    assert gat.aggregation_bound_ms(cfg) == pytest.approx(
        gat.attention_bound_ms(cfg, "fwd")
        + gat.attention_bound_ms(cfg, "bwd"), rel=1e-12)


def test_the_published_cell_counts():
    cell = load_cell("gat_ppi.pool")
    flops = cell.model.step_flops(cell.cfg)
    assert 13e12 < flops < 15e12        # about 14 TFLOP a step
    for d in ("fwd", "bwd"):
        assert math.isfinite(cell.model.attention_bound_ms(cell.cfg, d))


def test_the_readers_find_nothing_without_the_kernels_and_spans():
    import types

    from benchmark.trace import Trace
    cell = load_cell("gat_ppi.pool")
    trace = Trace((0, 10**9), [(0, 10**8, "csr_gather_kernel")], [], 2)
    ctx = types.SimpleNamespace(trace=trace, cfg=cell.cfg, model=cell.model)
    for name in ("attn_fwd_roofline", "attn_bwd_roofline"):
        assert load_metric(name).read(ctx) is None
    trace = Trace((0, 10**9), [(0, 10**8, "gat_attn_fwd_kernel<4, 2>"),
                               (0, 10**8, "gat_attn_bwd_kernel<4, 2>"),
                               (0, 10**8, "gat_attn_bwd_dt_kernel")], [], 2)
    ctx.trace = trace
    fwd = load_metric("attn_fwd_roofline").read(ctx)
    assert fwd == pytest.approx(
        100 * cell.model.attention_bound_ms(cell.cfg, "fwd") * 2 / 1e3 / 0.1)
    bwd = load_metric("attn_bwd_roofline").read(ctx)
    assert bwd == pytest.approx(
        100 * cell.model.attention_bound_ms(cell.cfg, "bwd") * 2 / 1e3 / 0.2)
    ctx.model = load_cell("arxiv.pool").model     # no attention bound
    assert load_metric("attn_fwd_roofline").read(ctx) is None


def test_the_two_reference_copies_give_the_same_bits():
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        import gat_reference
    finally:
        sys.path.remove(str(ROOT / "tests"))
    from benchmark import generate
    cfg, dev = TINY_GAT, torch.device("cpu")
    gat = load_model(cfg, ROOT)
    theta = gat.make_theta(cfg, 5, dev)
    theta = [t + 0.1 * torch.randn(t.shape, generator=torch.Generator()
                                   .manual_seed(i)) for i, t in
             enumerate(theta)]
    feats = generate.make_features(cfg, 5, dev)
    spt, qry = generate.make_pool(cfg, 4, 5, dev)
    steps = [[({k: v[t] for k, v in spt.items()},
               {k: v[t] for k, v in qry.items()}) for t in range(4)]]
    a = gat_protomaml.Reference(cfg).run(theta, steps, feats)
    b = gat_reference.Reference(cfg).run(theta, steps, feats)
    assert a["losses"] == b["losses"]
    assert all(torch.equal(x, y) for x, y in zip(a["grad1"], b["grad1"]))
    assert all(torch.equal(x, y) for x, y in zip(a["theta"], b["theta"]))
