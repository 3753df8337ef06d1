"""The readers of the program's spans (benchmark/program_spans.py and the
six metrics on it), on synthetic spans and a synthetic Trace: the phase
sums, the aggregation at any depth, the idle gaps inside, outside and
across spans, and nothing to read where no span was recorded."""

import types

import pytest

from benchmark.cell import load_metric
from benchmark.trace import Trace
from gmeta_tpu_torch.utils import metrics

S = metrics.Span
PHASES = ("prep_ms_per_step", "inner_ms_per_step", "curve_ms_per_step",
          "outer_ms_per_step", "agg_ms_per_step", "idle_program_ms_per_step")

# Two meta-steps in a window of [1000, 3000) ns. Step 0 holds each phase,
# remat's rerun under the gradient's outer, and agg spans at three depths;
# step 1 only an inner. A span before the window is left out.
SPANS = [
    S("step", -1, 0, 1000, 2000, 10.0),      # 0
    S("decode", 0, 0, 1000, 1100, 1.0),      # 1
    S("graph", 0, 0, 1100, 1200, 0.5),       # 2
    S("curve", 0, 0, 1200, 1300, 2.0),       # 3
    S("agg", 3, 0, 1210, 1220, 0.25),        # 4
    S("inner", 0, 0, 1300, 1500, 3.0),       # 5
    S("inner", 5, 0, 1350, 1400, 0.75),      # 6  the forward's rerun
    S("outer", 0, 0, 1500, 1600, 1.0),       # 7
    S("outer", 0, 0, 1600, 2000, 2.5),       # 8
    S("inner", 8, 0, 1650, 1700, 0.5),       # 9  remat's rerun
    S("agg", 9, 0, 1660, 1670, 0.125),       # 10
    S("agg", 8, 0, 1700, 1710, 0.125),       # 11
    S("step", -1, 1, 2500, 2900, 4.0),       # 12
    S("inner", 12, 1, 2500, 2900, 4.0),      # 13
    S("step", -1, 2, 100, 900, 99.0),        # 14 before the window
    S("inner", 14, 2, 100, 900, 99.0),       # 15
]


def _ctx(device, steps=2, window=(1000, 3000)):
    return types.SimpleNamespace(trace=Trace(window, device, [], steps),
                                 cfg={}, traffic={}, agg="sized")


def _read(name, ctx):
    return load_metric(name).read(ctx)


@pytest.fixture
def spans(monkeypatch):
    monkeypatch.setattr(metrics, "spans", lambda: list(SPANS))


def test_phases_are_the_steps_direct_children(spans):
    ctx = _ctx([(1000, 3000, "k")])
    assert _read("prep_ms_per_step", ctx) == pytest.approx(1.5 / 2)
    assert _read("inner_ms_per_step", ctx) == pytest.approx(7.0 / 2)
    assert _read("curve_ms_per_step", ctx) == pytest.approx(2.0 / 2)
    assert _read("outer_ms_per_step", ctx) == pytest.approx(3.5 / 2)
    # the phases of step 0 sum to its step span's device time (10 ms)
    assert sum(_read(n, ctx) for n in PHASES[:4]) * 2 == pytest.approx(
        10.0 + 4.0)


def test_agg_counts_every_agg_span_at_any_depth(spans):
    assert _read("agg_ms_per_step", _ctx([(1000, 3000, "k")])) == \
        pytest.approx(0.5 / 2)


def test_idle_program_counts_gaps_that_begin_inside_a_span(spans):
    # gaps: [1050, 1080) inside decode; [2000, 2200) just after step 0
    # ended, outside any span; [2450, 2600) begins outside and runs into
    # step 1; [2850, 2950) begins inside step 1 and runs past its end;
    # [2990, 3000) the window's tail, outside
    device = [(1000, 1050, "k"), (1080, 2000, "k"), (2200, 2450, "k"),
              (2600, 2850, "k"), (2950, 2990, "k")]
    got = _read("idle_program_ms_per_step", _ctx(device))
    assert got == pytest.approx((30 + 100) / 1e6 / 2)


def test_no_idle_inside_the_program(spans):
    ctx = _ctx([(900, 2000, "k"), (2400, 3100, "k")])
    assert _read("idle_program_ms_per_step", ctx) == 0.0


@pytest.mark.parametrize("source", ["empty", "outside", "older"])
def test_nothing_to_read_without_spans(monkeypatch, source):
    if source == "empty":
        monkeypatch.setattr(metrics, "spans", lambda: [])
    elif source == "outside":     # only spans before the window
        monkeypatch.setattr(metrics, "spans", lambda: SPANS[14:])
    else:                         # a program that records none
        monkeypatch.delattr(metrics, "spans")
    ctx = _ctx([(1000, 2000, "k")])
    for name in PHASES:
        assert _read(name, ctx) is None, name
