"""Device time per meta-step of the inner loop's support steps: the
program's `inner` spans (support forward, inner gradient, fast-weight
update; under remat the forward's rerun of the support forward too), direct
children of `step` (benchmark/program_spans.py)."""

from benchmark.program_spans import phase_ms_per_step

UNIT = "ms"


def read(ctx):
    return phase_ms_per_step(ctx, ("inner",))
