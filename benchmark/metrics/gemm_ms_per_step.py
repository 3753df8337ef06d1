"""Device time of the matrix-product kernels (cuBLAS's and CUTLASS's GEMM
and GEMV kernels, by name) per meta-step of the traced window: the GCN's
projections and head, forward and backward, and in a dense cell the
aggregations' batched products too."""

UNIT = "ms"
PATTERNS = ("gemm", "gemv")


def read(ctx):
    t = ctx.trace.device_s(lambda n: any(p in n.lower() for p in PATTERNS))
    return 1e3 * t / ctx.trace.steps if t > 0 else None
