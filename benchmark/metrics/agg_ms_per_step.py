"""Device time per meta-step of the aggregation, whatever implements it:
the program's `agg` spans around every sized launch and dense product,
forward and backward, in any phase (benchmark/program_spans.py)."""

from benchmark.program_spans import all_ms_per_step

UNIT = "ms"


def read(ctx):
    return all_ms_per_step(ctx, "agg")
