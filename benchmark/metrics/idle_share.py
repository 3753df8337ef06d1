"""Share of the traced window in which no operation ran on the device:
1 - the union of the device's operation intervals over the window's wall
time (trace.Trace.busy_s)."""

UNIT = "%"


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
