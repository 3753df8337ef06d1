"""Dense against sized aggregation at one episode-like shape: S = 21 bins of
P = 1024 slots with mixed live sizes (40-1000 rows), H = 256.

Counterpart of scripts/bench_pallas_spmm.py, whose Pallas kernel is the
port's `csr_gather_kernel` here. For float32 and bf16 it checks, on live
rows, the forward (`aggregate_sized`, the kernel, against
`aggregate_dense`, torch.bmm) and the gradient of sum(out^2) with respect
to h (the kernel's transpose against torch.bmm's backward), and the
kernel against its plain version (`sized_plain`); then it times both
paths' forward and forward plus gradient (medians of CUDA-event times,
`cardtime.cuda_ms`), beside their bounds.

    python -m gmeta_tpu_torch.scripts.bench_pallas_spmm [--shape S P H]
        [--iters 20] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import numpy as np
import torch

from gmeta_tpu_torch.ops import sized_spmm as sp
from gmeta_tpu_torch.ops.spmm import aggregate_dense
from gmeta_tpu_torch.scripts.common import finish, fmt, parser, start
from gmeta_tpu_torch.utils import cardtime
from gmeta_tpu_torch.utils.metrics import counted

TOLS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (8e-3, 8e-3)}


def mk(S, P, H, sizes, seed=0):
    """A (S, P, P) with 8 random in-neighbours (set, not added) per live
    row of each bin, and h (S, P, H); the JAX script's draws, bitwise, as
    float32 numpy. Returns (A, h, sizes)."""
    rng = np.random.RandomState(seed)
    A = np.zeros((S, P, P), np.float32)
    for s in range(S):
        n = sizes[s]
        deg = 8
        for i in range(n):
            js = rng.randint(0, n, deg)
            A[s, i, js] = 1.0
    h = rng.randn(S, P, H).astype(np.float32)
    return A, h, np.asarray(sizes, np.int32)


def edges_of(A):
    """(src, dst, mask) flat slot indices of A's non-zeros, dst
    nondecreasing: the edge list whose `densify` is A (A is 0/1)."""
    S, P, _ = A.shape
    s, d, u = np.nonzero(A)
    return s * P + u, s * P + d, np.ones(s.size, np.float32)


def _live_err(got, want, sizes):
    return max(float((got[s, :n].float() - want[s, :n].float()).abs().max())
               if n else 0.0 for s, n in enumerate(sizes.tolist()))


def run_dtype(A, h, sizes, dtype, device, iters) -> dict:
    S, P, H = h.shape
    src, dst, mask = (torch.from_numpy(a).to(device) for a in edges_of(A))
    graph = sp.sized_graph(src, dst, mask, S, P)
    Ad = torch.from_numpy(A).to(device, dtype)
    hd = torch.from_numpy(h).to(device, dtype)
    rtol, atol = TOLS[dtype]
    r = {}

    # forward: the kernel against torch.bmm on live rows, zeros past them,
    # and against its plain version everywhere
    od, op = aggregate_dense(Ad, hd), sp.aggregate_sized(graph, hd)
    r["fwd_err"] = _live_err(op, od, sizes)
    for s, n in enumerate(sizes.tolist()):
        if op[s, n:].any():
            raise AssertionError(f"bin {s}: rows past its {n} live ones")
    plain = sp.sized_plain(*graph.csr("fwd"), hd)
    torch.testing.assert_close(op.float(), plain.float(), rtol=rtol,
                               atol=atol)
    torch.testing.assert_close(op.float(), od.float(), rtol=rtol, atol=atol)
    r["plain_err"] = float((op.float() - plain.float()).abs().max())

    # gradient of sum(out^2) with respect to h
    def grad(agg):
        x = hd.clone().requires_grad_()
        return torch.autograd.grad((agg(x).float() ** 2).sum(), x)[0]

    def dense(x):
        return aggregate_dense(Ad, x)

    def sized(x):
        return sp.aggregate_sized(graph, x)
    gd, gp = grad(dense), grad(sized)
    r["bwd_err"] = _live_err(gp, gd, sizes)
    scale = float(gd.float().abs().max())
    if r["bwd_err"] > rtol * scale + atol:
        raise AssertionError(f"gradient off by {r['bwd_err']} of "
                             f"{scale} ({dtype})")

    def ms(fn):
        return cardtime.device_ms(fn, device, iters)
    r["dense_ms"] = ms(lambda: aggregate_dense(Ad, hd))
    r["sized_ms"] = ms(lambda: sp.aggregate_sized(graph, hd))
    r["plain_ms"] = ms(lambda: sp.sized_plain(*graph.csr("fwd"), hd))
    r["speedup"] = r["dense_ms"] / r["sized_ms"]
    r["grad_dense_ms"] = ms(lambda: grad(dense))
    r["grad_sized_ms"] = ms(lambda: grad(sized))
    r["grad_speedup"] = r["grad_dense_ms"] / r["grad_sized_ms"]
    nnz = int(graph.row_ptr[-1])
    read = int(torch.unique(graph.col[:nnz]).numel())
    r["sized_bound_ms"], r["sized_bound_by"], _ = cardtime.gather_bound(
        nnz, H, read, S * P, hd.element_size())
    r["dense_bound_ms"], r["dense_bound_by"], _ = cardtime.dense_bound(
        S, P, H, dtype)
    r["nnz"] = nnz
    return r


def main(argv=None):
    ap = parser("bench_pallas_spmm", __doc__)
    ap.add_argument("--shape", type=int, nargs=3, default=(21, 1024, 256),
                    metavar=("S", "P", "H"))
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    device, head = start(args.device)
    S, P, H = args.shape
    rng = np.random.RandomState(1)
    sizes = rng.randint(40 * P // 1024, 1000 * P // 1024, S)
    A, h, sizes = mk(S, P, H, sizes)
    result = dict(head, S=S, P=P, H=H, sizes=sizes.tolist(), unit="ms")
    with counted() as c:
        for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            result[tag] = run_dtype(A, h, sizes, dtype, device, args.iters)
    result["launches"] = c.of(sp.LAUNCHES)
    if device.type == "cuda" and not all(result["launches"].values()):
        raise RuntimeError(f"the sized kernel did not launch both ways: "
                           f"{result['launches']}")
    lines = ["| dtype | fwd err | grad err | dense ms | sized ms | plain ms "
             "| speedup | grad dense ms | grad sized ms | grad speedup "
             "| sized bound ms | dense bound ms |", "|---" * 12 + "|"]
    for tag in ("f32", "bf16"):
        r = result[tag]
        lines.append("| " + " | ".join(
            [tag, f"{r['fwd_err']:.3g}", f"{r['bwd_err']:.3g}"]
            + [fmt(r[k]) for k in ("dense_ms", "sized_ms", "plain_ms",
                                   "speedup", "grad_dense_ms",
                                   "grad_sized_ms", "grad_speedup")]
            + [fmt(r["sized_bound_ms"], 4), fmt(r["dense_bound_ms"], 4)])
            + " |")
    return finish(result, args.out, lines)


if __name__ == "__main__":
    main()
