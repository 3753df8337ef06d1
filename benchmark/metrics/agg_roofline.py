"""The packed gather's share of its roofline: the least time the traced
window's required aggregations could take on the card (the cell's model's
`aggregation_bound_ms`, for the GCN counts/model.py's: each call's gather
bound over its real edges and rows, float32) over the device time of the
kernel that runs them (`csr_gather_kernel`, by name). Nothing to read where
that kernel did not run (a dense cell)."""

UNIT = "%"
KERNEL = "csr_gather_kernel"


def read(ctx):
    t = ctx.trace.device_s(lambda n: KERNEL in n)
    if t <= 0:
        return None
    bound_s = ctx.model.aggregation_bound_ms(ctx.cfg) * ctx.trace.steps / 1e3
    return 100.0 * bound_s / t
