"""The program's own spans over the traced window: each phase of the
meta-step with its device time, read by the per-layer metrics
`prep_ms_per_step`, `inner_ms_per_step`, `curve_ms_per_step`,
`outer_ms_per_step`, `agg_ms_per_step` and `idle_program_ms_per_step`.

The program records them while a torch.profiler is active
(gmeta_tpu_torch/utils/metrics.py `span`, `spans`): per meta-step a `step`
whose direct children are its phases (`decode`, `graph`, `curve`, `inner`,
`outer`), and `agg` around every aggregation wherever it runs. A span's
device time is taken between CUDA events on the stream at its open and
close; its host interval is on the clock of the trace's device events. A
program that records no spans gives None, and the metrics that read them
are then left out of the line.
"""

from __future__ import annotations

from benchmark.trace import _union


def window(ctx):
    """(the program's spans, the indices of those that opened inside the
    traced window), or None where no meta-step was recorded there."""
    try:
        from gmeta_tpu_torch.utils import metrics
    except ImportError:
        return None
    read = getattr(metrics, "spans", None)
    if read is None:
        return None
    spans = read()
    tr = ctx.trace
    inside = [i for i, s in enumerate(spans)
              if tr.start <= s.start_ns < tr.end]
    if not any(spans[i].name == "step" for i in inside):
        return None
    return spans, inside


def phase_ms_per_step(ctx, names):
    """Device ms per meta-step of the spans named in `names` that are
    direct children of a `step` (so that what remat reruns inside the
    meta-gradient's `outer` counts once, as `outer`'s)."""
    w = window(ctx)
    if w is None:
        return None
    spans, inside = w
    t = sum(spans[i].device_ms for i in inside
            if spans[i].name in names and spans[i].parent >= 0
            and spans[spans[i].parent].name == "step")
    return t / ctx.trace.steps


def all_ms_per_step(ctx, name):
    """Device ms per meta-step of every span named `name`, at any depth."""
    w = window(ctx)
    if w is None:
        return None
    spans, inside = w
    return sum(spans[i].device_ms for i in inside
               if spans[i].name == name) / ctx.trace.steps


def idle_gaps(trace):
    """Every stretch of the window with no device operation, as
    `Trace.idle_gaps` finds them: (start_ns, end_ns)."""
    gaps, t = [], trace.start
    for s, e in _union(trace.device) + [(trace.end, trace.end)]:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    return gaps


def idle_program_ms_per_step(ctx):
    """Ms per meta-step of the device's idle gaps that began while the
    host was inside one of the program's spans."""
    w = window(ctx)
    if w is None:
        return None
    spans, inside = w
    busy = _union([(spans[i].start_ns, spans[i].end_ns, "")
                   for i in inside if spans[i].end_ns > spans[i].start_ns])
    total, k = 0, 0
    for s, e in idle_gaps(ctx.trace):      # both lists sorted by start
        while k < len(busy) and busy[k][1] <= s:
            k += 1
        if k < len(busy) and busy[k][0] <= s:
            total += e - s
    return total / 1e6 / ctx.trace.steps
