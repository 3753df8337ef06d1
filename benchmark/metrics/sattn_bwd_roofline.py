"""Graphormer's attention backward kernels' share of their roofline: the
least time the traced window's attention calls could take backward (the
cell's model's `attention_bound_ms(cfg, "bwd")`,
benchmark/models/graphormer.py) over the device time of the four kernels
that run them (names beginning `sattn_bwd`: the rows' deltas, the keys'
gradients, the queries' gradients with the table's partial sums, the
table's sums). Nothing to read where they did not run."""

UNIT = "%"
KERNEL = "sattn_bwd"


def read(ctx):
    bound = getattr(ctx.model, "attention_bound_ms", None)
    t = ctx.trace.device_s(lambda n: KERNEL in n)
    if bound is None or t <= 0:
        return None
    return 100.0 * bound(ctx.cfg, "bwd") * ctx.trace.steps / 1e3 / t
