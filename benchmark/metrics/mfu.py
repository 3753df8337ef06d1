"""The meta-step's share of the card's peak: the operations one meta-step
requires (the cell's model's `step_flops`, for the GCN counts/model.py's:
real nodes and edges, every pass the configuration asks for, no
recomputation), times the meta-steps of the traced window, over its wall
time and the configuration's dtype's dense peak (counts/peaks.py)."""

from benchmark.counts.peaks import PEAK_BY_DTYPE

UNIT = "%"


def read(ctx):
    flops = ctx.model.step_flops(ctx.cfg) * ctx.trace.steps
    return 100.0 * flops / ctx.trace.window_s / PEAK_BY_DTYPE[ctx.cfg["dtype"]]
