"""The meta-step's spans (gmeta_tpu_torch/utils/metrics.py `span`): nothing
is recorded, nor allocated, without an active profiler; under one, a
compact-pool call records each meta-step as a `step` whose children are its
phases in order, remat's recomputation sits under the meta-gradient's
`outer`, the `agg` spans count the calls `count_aggregation` tallies, and
the results are the same bits with and without the profiler. CPU, tiny
sizes; imports neither jax nor the JAX package."""

import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
from gmeta_tpu_torch.meta.maml import MetaLearner, take_tasks
from gmeta_tpu_torch.ops.spmm import count_aggregation
from gmeta_tpu_torch.utils import metrics

torch.set_num_threads(2)

DATA = dict(num_graphs=1, nodes_per_graph=150, avg_degree=5, feat_dim=8,
            num_classes=9, n_way=3, k_spt=3, k_qry=4, batchsz=12, h=2,
            sample_nodes=60, seed=3)
UPDATE_STEP, K, T = 3, 2, 4


@pytest.fixture(scope="module")
def data():
    store, ds = synthetic_disjoint(**DATA)
    pool = ds["train"].stacked_pool()
    idx = np.random.RandomState(2).permutation(len(ds["train"]))[
        :K * T].reshape(K, T)
    return store, pool, idx


def _learner(data, agg="sized", remat=False, track_curve=True):
    store, pool, _ = data
    ml = MetaLearner(build_model_config(Config(hidden_dim=8), store.feat_dim,
                                        3), 3,
                     update_lr=0.05, meta_lr=1e-3, update_step=UPDATE_STEP,
                     update_step_test=2, seed=5, agg=agg, remat=remat,
                     track_curve=track_curve, device="cpu")
    ml.set_features(store.features)
    ml.set_task_pool_compact(pool)
    return ml


def _profiled(fn):
    """fn() under a CPU profiler; (its result, the window's spans)."""
    metrics.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, metrics.spans()


def _children(window, i):
    return [j for j, s in enumerate(window) if s.parent == i]


def test_no_profiler_records_and_allocates_nothing(data):
    metrics.clear_spans()
    assert metrics.span("a") is metrics.span("b")
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(1000):
            with metrics.span("step"), metrics.span("agg"):
                pass
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == metrics.__file__ and d.size_diff]
    assert grown == []
    ml = _learner(data)
    ml.train_steps_from_compact(data[2])
    assert metrics.spans() == []


@pytest.mark.parametrize("remat", [False, True])
def test_compact_call_records_each_step_and_its_phases(data, remat):
    ml = _learner(data, remat=remat)
    _, window = _profiled(lambda: ml.train_steps_from_compact(data[2]))
    steps = [i for i, s in enumerate(window) if s.name == "step"]
    assert len(steps) == K
    assert all(window[i].parent == -1 for i in steps)
    want = (["decode", "graph", "curve"]
            + ["inner", "curve"] * (UPDATE_STEP - 1)
            + ["inner", "outer", "outer"])
    ids = set()
    for i in steps:
        kids = _children(window, i)
        assert [window[j].name for j in kids] == want
        ids.add(window[i].step)
        # every span below a step carries its id
        for j, s in enumerate(window):
            p = s.parent
            while p >= 0 and p != i:
                p = window[p].parent
            if p == i:
                assert s.step == window[i].step
        for j in kids:
            s = window[j]
            assert window[i].start_ns <= s.start_ns <= s.end_ns \
                <= window[i].end_ns
            assert s.device_ms >= 0
    assert len(ids) == K
    # the phases partition the step: the host clock's device time on the
    # CPU leaves out only the step's own few lines between them
    for i in steps:
        phases = sum(window[j].device_ms for j in _children(window, i))
        assert 0.8 * window[i].device_ms <= phases <= window[i].device_ms


def test_remat_recomputes_under_the_meta_gradients_outer(data):
    for remat in (False, True):
        ml = _learner(data, remat=remat)
        _, window = _profiled(lambda: ml.train_steps_from_compact(data[2]))
        grad_outer = [_children(window, i)[-1] for i, s in enumerate(window)
                      if s.name == "step"]
        under = [window[j].name for o in grad_outer
                 for j in _children(window, o)]
        if remat:
            assert under.count("inner") >= K
            assert set(under) <= {"inner", "curve", "outer", "agg"}
        else:
            assert "inner" not in under and "curve" not in under
        # no phase span outside a step
        assert all(s.parent >= 0 for s in window if s.name != "step")


@pytest.mark.parametrize("agg", ["sized", "dense"])
@pytest.mark.parametrize("remat", [False, True])
def test_agg_spans_count_the_tallied_calls(data, agg, remat):
    ml = _learner(data, agg=agg, remat=remat)

    def run():
        with count_aggregation() as work:
            ml.train_steps_from_compact(data[2])
        return work
    work, window = _profiled(run)
    aggs = [s for s in window if s.name == "agg"]
    assert len(aggs) == len(work.edges) > 0
    assert all(s.parent >= 0 and s.step >= 0 for s in aggs)
    # the backward's calls run under the gradients' spans
    parents = {window[s.parent].name for s in aggs}
    assert {"inner", "outer"} <= parents


@pytest.mark.parametrize("agg, remat, track_curve",
                         [("sized", False, True), ("sized", True, True),
                          ("dense", True, True), ("dense", False, False)])
def test_results_are_the_same_bits_under_the_profiler(data, agg, remat,
                                                      track_curve):
    runs = []
    for on in (False, True):
        ml = _learner(data, agg=agg, remat=remat, track_curve=track_curve)
        step = [lambda: ml.train_steps_from_compact(data[2])] * 2
        if on:
            ms, window = _profiled(lambda: [f() for f in step])
            assert sum(s.name == "step" for s in window) == 2 * K
        else:
            ms = [f() for f in step]
        runs.append((ms, ml.snapshot(), ml.opt_state))
    (m0, p0, o0), (m1, p1, o1) = runs
    for a, b in zip(m0, m1):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(p0 + o0.mu + o0.nu, p1 + o1.mu + o1.nu):
        assert torch.equal(a, b)


def test_streamed_train_step_is_its_own_step(data):
    store, pool, idx = data
    ml = _learner(data)
    _, window = _profiled(lambda: ml.train_step(take_tasks(pool, idx[0])))
    steps = [i for i, s in enumerate(window) if s.name == "step"]
    assert len(steps) == 1
    assert [window[j].name for j in _children(window, steps[0])][:2] \
        == ["decode", "graph"]


def test_summary_counts_each_name_and_its_time_once():
    S = metrics.Span
    window = [S("step", -1, 0, 0, 100, 10.0),
              S("outer", 0, 0, 10, 90, 6.0),
              S("outer", 1, 0, 20, 30, 1.0),    # rerun inside the gradient
              S("agg", 2, 0, 21, 22, 0.5),
              S("step", -1, 1, 100, 200, 12.0),
              S("outer", 4, 1, 110, 190, 8.0)]
    out = metrics.span_summary(window)
    assert out["steps"] == 2
    assert out["count"] == {"step": 2, "outer": 3, "agg": 1}
    assert out["ms_per_step"] == {"step": 11.0, "outer": 7.0, "agg": 0.25}


def test_threads_keep_their_own_stacks_under_contention(monkeypatch):
    """Spans opened on many threads at once, with the interpreter switching
    threads as often as it can: every span is kept, each under the span
    its own thread had open, and every step gets an id of its own. (The
    recording is forced on: a profiler follows only the threads it was
    started on and the autograd engine's.)"""
    import sys
    import threading
    monkeypatch.setattr(metrics, "_profiling", lambda: True)
    metrics.clear_spans()
    n_threads, n_steps = 12, 150

    def work(t):
        for _ in range(n_steps):
            with metrics.span("step"), metrics.span(f"t{t}"):
                with metrics.span(f"t{t}"):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    window = metrics.spans()
    assert len(window) == 3 * n_threads * n_steps
    steps = [s for s in window if s.name == "step"]
    assert len({s.step for s in steps}) == n_threads * n_steps
    for s in window:
        if s.name == "step":
            assert s.parent == -1
            continue
        p = window[s.parent]
        assert p.step == s.step
        assert p.name in ("step", s.name)
        assert s.start_ns >= p.start_ns and s.end_ns <= p.end_ns
