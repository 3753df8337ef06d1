"""Device time per meta-step of the step's tasks arriving and its graphs
being built: the program's `decode` spans (the compact pool's gather and
decode) and `graph` spans (CSR build, degree norm, feature gather), direct
children of `step` (benchmark/program_spans.py)."""

from benchmark.program_spans import phase_ms_per_step

UNIT = "ms"


def read(ctx):
    return phase_ms_per_step(ctx, ("decode", "graph"))
