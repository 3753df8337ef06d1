"""Device time per meta-step of Graphormer's attention over each graph,
forward and backward: the program's `sattn` spans
(ops/spatial_attention.py `attend` and its backward), in any phase
(benchmark/program_spans.py). Nothing to read where the program recorded
no `sattn` span (another model, or a program without the span)."""

from benchmark.program_spans import all_ms_per_step, window

UNIT = "ms"


def read(ctx):
    w = window(ctx)
    if w is None:
        return None
    spans, inside = w
    if not any(spans[i].name == "sattn" for i in inside):
        return None
    return all_ms_per_step(ctx, "sattn")
