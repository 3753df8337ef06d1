"""Device time per meta-step of the training curve's query evaluations,
which only feed telemetry: the program's `curve` spans (step 0 and every
inner step but the last, under no_grad), direct children of `step`
(benchmark/program_spans.py)."""

from benchmark.program_spans import phase_ms_per_step

UNIT = "ms"


def read(ctx):
    return phase_ms_per_step(ctx, ("curve",))
