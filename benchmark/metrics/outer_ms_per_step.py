"""Device time per meta-step of the meta-loss, the meta-gradient and the
update: the program's two `outer` spans a step (the last inner step's
query forward; then the gradient with remat's recomputation, Adam and the
NaN guard), direct children of `step` (benchmark/program_spans.py)."""

from benchmark.program_spans import phase_ms_per_step

UNIT = "ms"


def read(ctx):
    return phase_ms_per_step(ctx, ("outer",))
