"""Device time of the elementwise kernels per meta-step of the traced
window: PyTorch's generic ones (`elementwise` in the name: the GraphConv's
norm scales, bias adds and ReLUs where PyTorch runs them as separate
passes, and every other elementwise op of the step) and the port's fused
GraphConv epilogue (`gcn_epilogue`), forward and backward."""

UNIT = "ms"
PATTERNS = ("elementwise", "gcn_epilogue")


def read(ctx):
    t = ctx.trace.device_s(lambda n: any(p in n.lower() for p in PATTERNS))
    return 1e3 * t / ctx.trace.steps if t > 0 else None
