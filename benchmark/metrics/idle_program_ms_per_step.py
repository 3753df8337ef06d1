"""The device's idle time per meta-step that the program's own host work
left: gaps in the union of the traced device operations (as
benchmark/trace.py takes it) that began while the host was inside one of
the program's spans (benchmark/program_spans.py)."""

from benchmark.program_spans import idle_program_ms_per_step

UNIT = "ms"


def read(ctx):
    return idle_program_ms_per_step(ctx)
