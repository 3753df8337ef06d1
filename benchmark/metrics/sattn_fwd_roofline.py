"""Graphormer's attention forward kernel's share of its roofline: the least
time the traced window's attention calls could take forward (the cell's
model's `attention_bound_ms(cfg, "fwd")`, benchmark/models/graphormer.py)
over the device time of the kernel that runs them (`sattn_fwd_kernel`, by
name). Nothing to read where that kernel did not run."""

UNIT = "%"
KERNEL = "sattn_fwd_kernel"


def read(ctx):
    bound = getattr(ctx.model, "attention_bound_ms", None)
    t = ctx.trace.device_s(lambda n: KERNEL in n)
    if bound is None or t <= 0:
        return None
    return 100.0 * bound(ctx.cfg, "fwd") * ctx.trace.steps / 1e3 / t
