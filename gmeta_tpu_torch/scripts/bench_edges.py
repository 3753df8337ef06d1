"""Full-graph aggregation: edges/s of one GCN aggregation on a power-law
graph at Tree-of-Life-like scale, by path.

Counterpart of scripts/bench_edges.py, on the same `powerlaw_graph` (V =
2^V_log2 nodes, avg_deg x V edges, Zipf-0.8 in-degrees, uniform sources;
default 2^19 and 8), H = 128, float32 and bf16. The paths:

  segment     ops/spmm.aggregate: gather the E x H messages, index_add_
  ell         ops/spmm.aggregate_ell over build_ell slabs (row_cap 16)
  csr_gather  what the edge-partitioned engine runs: `CsrAgg` over the
              graph's `csr_pair`, the port's `csr_slab_kernel`, with
              `csr_combine_kernel` adding up the rows it splits

each forward and forward plus backward (autograd of sum(out^2)), timed
as medians of CUDA-event times (`cardtime.cuda_ms`), with edges/s and
the bound (`cardtime.gather_bound`; forward plus backward: both
directions' bounds). The paths' forward outputs are held against the
first that ran (segment, where it fits) within `cardtime.rounding_bound`
at the dtype's unit roundoff. A path that does not fit in the card's
memory is reported as such and skipped (at 2^23 the E x H messages of
segment and ELL take tens of GB).

    python -m gmeta_tpu_torch.scripts.bench_edges [V_log2] [avg_deg]
        [--hidden 128] [--iters 10] [--device cpu] [--out PATH]
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from gmeta_tpu_torch.ops import sized_spmm as sp
from gmeta_tpu_torch.ops.spmm import aggregate, aggregate_ell, build_ell
from gmeta_tpu_torch.scripts.common import finish, fmt, parser, start
from gmeta_tpu_torch.utils import cardtime
from gmeta_tpu_torch.utils.metrics import counted

UNIT = {torch.float32: 2.0**-24, torch.bfloat16: 2.0**-8}
PATHS = ("segment", "ell", "csr_gather")


def powerlaw_graph(V, avg_deg, seed=0):
    """In-degrees ~ Zipf-0.8, sources uniform, edges sorted by dst; the
    JAX script's draws, bitwise."""
    rng = np.random.RandomState(seed)
    w = (1.0 / np.arange(1, V + 1) ** 0.8)
    w /= w.sum()
    E = V * avg_deg
    dst = rng.choice(V, size=E, p=w)
    src = rng.randint(0, V, size=E)
    order = np.argsort(dst, kind="stable")
    return src[order].astype(np.int32), dst[order].astype(np.int32)


def _bound(pair, h, unit, block=16):
    """`cardtime.rounding_bound` of the forward CSR, `block` columns at a
    time (its plain gather of |h| holds E x block values, not E x H)."""
    return torch.cat([cardtime.rounding_bound(pair.row_ptr, pair.col,
                                              h[:, c:c + block], unit)
                      for c in range(0, h.shape[1], block)], dim=1)


def _grad(f):
    def fb(x):
        x = x.detach().requires_grad_()
        return torch.autograd.grad((f(x).float() ** 2).sum(), x)[0]
    return fb


def main(argv=None):
    ap = parser("bench_edges", __doc__)
    ap.add_argument("V_log2", type=int, nargs="?", default=19)
    ap.add_argument("avg_deg", type=int, nargs="?", default=8)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    device, head = start(args.device)
    V, H = 1 << args.V_log2, args.hidden
    warmup = min(3, args.iters)     # ELL's backward takes seconds a call
    t0 = time.perf_counter()
    src, dst = powerlaw_graph(V, args.avg_deg)
    E = len(src)
    deg = np.bincount(dst, minlength=V)
    nbr, mask, row_id = build_ell(src, dst, V, row_cap=16)
    pair = sp.csr_pair(src, dst, V, V)
    host_s = time.perf_counter() - t0
    print(f"# V={V} E={E} H={H} max_deg={deg.max()} p99_deg="
          f"{np.percentile(deg, 99):.0f}; ELL slabs {nbr.shape[0]} x 16 "
          f"(slot/edge ratio {nbr.size / max(E, 1):.2f}); host {host_s:.1f} s",
          file=sys.stderr, flush=True)
    out = dict(head, V=V, E=E, H=H, avg_deg=args.avg_deg,
               max_deg=int(deg.max()), ell_slot_ratio=nbr.size / max(E, 1),
               split_rows=int(pair.split.rows.numel()),
               host_build_s=host_s, iters=args.iters)
    pair = pair.to(device)
    srcd, dstd = (torch.from_numpy(a).to(device) for a in (src, dst))
    nbrd, rid = (torch.from_numpy(a).to(device) for a in (nbr, row_id))
    del nbr, row_id
    read = {"fwd": int(torch.unique(pair.col).numel()),
            "bwd": int(torch.unique(pair.col_t).numel())}
    launched = counted()

    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        g = torch.Generator().manual_seed(1)
        h = torch.randn(V, H, generator=g).to(device, dtype)
        em = torch.ones(E, dtype=dtype, device=device)
        maskd = torch.from_numpy(mask).to(device, dtype)
        fns = {"segment": lambda x: aggregate(x, srcd, dstd, em, V),
               "ell": lambda x: aggregate_ell(x, nbrd, maskd, rid, V),
               "csr_gather": lambda x: sp.CsrAgg.apply(pair, x)}
        bound = _bound(pair, h, UNIT[dtype])
        ref = ref_name = None
        fwd_ms, _, _ = cardtime.gather_bound(E, H, read["fwd"], V,
                                             h.element_size())
        bwd_ms, _, _ = cardtime.gather_bound(E, H, read["bwd"], V,
                                             h.element_size())
        for name in PATHS:
            f, r = fns[name], {}
            try:
                got = f(h).float()
                if ref is None:
                    ref, ref_name = got, name
                else:
                    r["vs"] = ref_name
                    r["max_abs_err"] = float((got - ref).abs().max())
                    if not ((got - ref).abs() <= bound).all():
                        raise AssertionError(
                            f"{name} {tag} parts from {ref_name} past the "
                            f"rounding bound")
                del got
                r["fwd_ms"] = cardtime.device_ms(lambda: f(h), device,
                                                 args.iters, warmup)
                r["fwd_edges_per_s"] = E / (r["fwd_ms"] * 1e-3)
                r["fb_ms"] = cardtime.device_ms(lambda: _grad(f)(h), device,
                                                args.iters, warmup)
                r["fb_edges_per_s"] = E / (r["fb_ms"] * 1e-3)
            except torch.OutOfMemoryError as e:
                r["oom"] = str(e).splitlines()[0]
                torch.cuda.empty_cache()
            r["fwd_bound_ms"], r["fb_bound_ms"] = fwd_ms, fwd_ms + bwd_ms
            out[f"{name}_{tag}"] = r
        del h, em, maskd, ref, bound
        if device.type == "cuda":
            torch.cuda.empty_cache()
    out["launches"] = {"csr": launched.of(sp.CSR_LAUNCHES),
                       "combine": launched.of(sp.COMBINE_LAUNCHES)}
    if device.type == "cuda":
        if not all(out["launches"]["csr"].values()):
            raise RuntimeError(f"csr_gather did not launch both ways: "
                               f"{out['launches']}")
        if out["split_rows"] and not out["launches"]["combine"]["fwd"]:
            raise RuntimeError("the combine kernel did not launch")
    lines = ["| path | dtype | fwd ms | fwd Gedges/s | fwd+bwd ms | "
             "fwd+bwd Gedges/s | fwd bound ms | fwd+bwd bound ms |",
             "|---" * 8 + "|"]
    for tag in ("f32", "bf16"):
        for name in PATHS:
            r = out[f"{name}_{tag}"]
            cells = [fmt(r.get("fwd_ms")),
                     fmt(r.get("fwd_edges_per_s", 0) / 1e9 or None),
                     fmt(r.get("fb_ms")),
                     fmt(r.get("fb_edges_per_s", 0) / 1e9 or None)]
            if "oom" in r:
                cells = [c if c != "-" else "out of memory" for c in cells]
            lines.append("| " + " | ".join(
                [name, tag] + cells + [fmt(r["fwd_bound_ms"], 4),
                                       fmt(r["fb_bound_ms"], 4)]) + " |")
    return finish(out, args.out, lines)


if __name__ == "__main__":
    main()
