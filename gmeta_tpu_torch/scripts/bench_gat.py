"""GAT's attention kernels (ops/gat_attention.py, csrc/gat_attention.cu)
timed at the `gat_ppi.pool` cell's set shapes, forward and backward, beside
their bound (utils/cardtime.py `attention_bound`) and their plain
versions:

    python -m gmeta_tpu_torch.scripts.bench_gat [--device cpu] [--out FILE]

A set is drawn as the benchmark's generator draws one: T tasks of B bins
of P slots with `live` real slots a bin, every live slot an in-edge and
the rest of the task's real edges at random destinations, sources in the
same bin; then repacked as the CSR path runs it (data/repack.py): each
task's B * live live slots in one bin of M rows, each original bin's rows
a segment (data/repack.py `segments`). Each layer's heads run on random
zst over those T * M rows: ms medians of single launches (CUDA events;
the backward's three kernels as one) of the staged kernels, which the
path takes, and of the walk kernels on the same graph without its
segments; the plain versions beside. No PyTorch call computes this
function, so there is no library column. On the CPU (--device cpu) it
runs the plain versions at a tiny shape.
"""

from __future__ import annotations

import torch

import numpy as np

from gmeta_tpu_torch.data.repack import bin_rows, segments
from gmeta_tpu_torch.ops import gat_attention
from gmeta_tpu_torch.ops.gat_attention import attn_graph, bwd_plain, fwd_plain
from gmeta_tpu_torch.scripts.common import finish, fmt, parser, start
from gmeta_tpu_torch.utils.cardtime import attention_bound, device_ms

# set -> (T, B, P, live slots a bin, real edges a task): gat_ppi.pool's
# record buckets at 16 tasks (benchmark/configs/gat_ppi.json)
SHAPES = {"qry": (16, 16, 1024, 586, 99763),
          "spt": (16, 6, 1024, 586, 36146)}
TINY = {"tiny": (2, 2, 32, 20, 60)}
HEADS = [(4, 256), (6, 121)]     # layers 1-2 and layer 3


def packed_graph(T, B, P, live, edges, device, seed=0, repacked=False):
    """The AttnGraph of T tasks' packed edges (module docstring), over
    their T * B * P slots or, `repacked`, over T bins of M = `bin_rows` of
    B * live rows, slot i of bin b at row b * live + i, with the segments
    of each original bin: what data/repack.py makes of a set whose every
    bin holds `live`."""
    g = torch.Generator(device=device).manual_seed(seed)
    first = torch.arange(B * live, device=device)
    first = (first // live * P + first % live).expand(T, -1)
    rest = edges - B * live
    bins = torch.randint(0, B, (T, rest), generator=g, device=device)
    dst = torch.cat([first, bins * P + torch.randint(
        0, live, (T, rest), generator=g, device=device)], 1)
    src = dst // P * P + torch.randint(0, live, (T, edges), generator=g,
                                       device=device)
    dst, order = torch.sort(dst, dim=1, stable=True)
    src = torch.gather(src, 1, order)
    mask = torch.ones(T, edges, device=device)
    if not repacked:
        return attn_graph(src, dst, mask, B, P)
    src, dst = (x // P * live + x % P for x in (src, dst))
    M = bin_rows([B * live])
    fill = torch.full((T, B), live, device=device, dtype=torch.int32)
    return attn_graph(src, dst, mask, 1, M, segments(
        fill, M, np.full((T, B), live)))


def walk(graph):
    """The same graph without its segments: the walk kernels' route."""
    return graph._replace(seg=None, seg_rows=0)


def main(argv=None):
    ap = parser("bench_gat", __doc__)
    args = ap.parse_args(argv)
    device, head = start(args.device)
    cuda = device.type == "cuda"
    rows_out = []
    for name, (T, B, P, live, edges) in (SHAPES if cuda else TINY).items():
        graph = packed_graph(T, B, P, live, edges, device, repacked=True)
        N = graph.sized.row_ptr.numel() - 1
        for K, F in HEADS if cuda else [(2, 4), (3, 3)]:
            gen = torch.Generator(device=device).manual_seed(K)
            zst = torch.randn(N, K * F + 2 * K, generator=gen, device=device)
            g = torch.randn(N, K * F, generator=gen, device=device)
            o, lse = fwd_plain(graph, zst, K, F)
            row = {"set": name, "T": T, "B": B, "P": P, "live": live,
                   "rows": N, "edges": edges, "K": K, "F": F}
            for d in ("fwd", "bwd"):
                bound, what, nbytes = attention_bound(
                    T * B * live, T * edges, K, F, d)
                row[f"{d}_bound_ms"], row[f"{d}_bound"] = bound, what
            for pre, gr in (("", graph), ("walk_", walk(graph))):
                if not cuda:
                    break
                row[f"{pre}route"] = gat_attention.route(gr)
                row[f"{pre}fwd_ms"] = device_ms(
                    lambda: gat_attention._launch_fwd(gr, zst, K, F),
                    device)
                row[f"{pre}bwd_ms"] = device_ms(
                    lambda: gat_attention._launch_bwd(gr, zst, o, lse, g,
                                                      K, F), device)
                for d in ("fwd", "bwd"):
                    row[f"{pre}{d}_share"] = 100 * row[f"{d}_bound_ms"] / \
                        row[f"{pre}{d}_ms"]
            row["fwd_plain_ms"] = device_ms(
                lambda: fwd_plain(graph, zst, K, F), device, iters=3,
                warmup=1)
            row["bwd_plain_ms"] = device_ms(
                lambda: bwd_plain(graph, zst, o, lse, g, K, F), device,
                iters=3, warmup=1)
            rows_out.append(row)
            del zst, g, o, lse
    table = ["| set, heads | staged ms fwd / bwd (3 kernels) | walk ms fwd / "
             "bwd | bound ms fwd / bwd | share fwd / bwd: staged; walk | "
             "plain ms fwd / bwd |", "|---|---|---|---|---|---|"]
    for r in rows_out:
        table.append(
            f"| {r['set']}, {r['K']} x {r['F']} | {fmt(r.get('fwd_ms'))} / "
            f"{fmt(r.get('bwd_ms'))} | {fmt(r.get('walk_fwd_ms'))} / "
            f"{fmt(r.get('walk_bwd_ms'))} | {fmt(r['fwd_bound_ms'])} / "
            f"{fmt(r['bwd_bound_ms'])} | {fmt(r.get('fwd_share'), 1)} / "
            f"{fmt(r.get('bwd_share'), 1)}; "
            f"{fmt(r.get('walk_fwd_share'), 1)} / "
            f"{fmt(r.get('walk_bwd_share'), 1)} | "
            f"{fmt(r['fwd_plain_ms'])} / {fmt(r['bwd_plain_ms'])} |")
    return finish({**head, "rows": rows_out}, args.out, table)


if __name__ == "__main__":
    main()
