"""Device time per meta-step of Graphormer's distances and degrees: the
program's `spd` spans (ops/spatial_attention.py `spatial_graph`, inside
`precompute`, once per task set), in any phase
(benchmark/program_spans.py). Nothing to read where the program recorded
no `spd` span (another model, or a program without the span)."""

from benchmark.program_spans import all_ms_per_step, window

UNIT = "ms"


def read(ctx):
    w = window(ctx)
    if w is None:
        return None
    spans, inside = w
    if not any(spans[i].name == "spd" for i in inside):
        return None
    return all_ms_per_step(ctx, "spd")
