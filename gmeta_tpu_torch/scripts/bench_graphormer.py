"""Graphormer's attention kernels and distances (ops/spatial_attention.py,
csrc/spatial_attention.cu) timed at the `graphormer_ppi.pool` cell's set
shapes, forward and backward, beside their bound
(utils/cardtime.py `spatial_attention_bound`) and their plain versions:

    python -m gmeta_tpu_torch.scripts.bench_graphormer [--device cpu] [--out FILE]

A set is drawn as the benchmark's generator draws one: T tasks of B bins
of P slots with `live` real slots a bin, one graph a bin, every live slot
an in-edge and the rest of the task's real edges at random destinations,
sources in the same bin; then repacked as the CSR path runs it
(data/repack.py): each task's B * live live slots in one bin of M rows,
each original bin's rows a segment (data/repack.py `segments`). The heads
run on random qkv and a random spatial table over those T * M rows: ms
medians of single launches (CUDA events; the backward's four kernels as
one) of the kernels, and of the set's distances and degrees
(`spatial_graph`, the CSRs' sort included); the plain versions
beside. No PyTorch call computes this function, so there is no library
column. On the CPU (--device cpu) it runs the plain versions at a tiny
shape.
"""

from __future__ import annotations

import numpy as np
import torch

from gmeta_tpu_torch.data.repack import bin_rows, segments
from gmeta_tpu_torch.ops import spatial_attention as sa
from gmeta_tpu_torch.scripts.common import finish, fmt, parser, start
from gmeta_tpu_torch.utils.cardtime import device_ms, spatial_attention_bound

# set -> (T, B, P, live slots a bin, real edges a task): graphormer_ppi's
# record buckets at 16 tasks (benchmark/configs/graphormer_ppi.json)
SHAPES = {"qry": (16, 16, 1024, 586, 99763),
          "spt": (16, 6, 1024, 586, 36146)}
TINY = {"tiny": (2, 2, 32, 20, 60)}
HEADS = (8, 10)       # Graphormer-slim: 8 heads of 10


def packed_edges(T, B, P, live, edges, device, seed=0):
    """(edge_src, edge_dst, edge_mask (T, edges), node_mask (T, B, P)) of
    T tasks' packed sets (module docstring), edges sorted by destination."""
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
    node = (torch.arange(P, device=device) < live).float().expand(T, B, P)
    return src, dst, mask, node


def graph_inputs(T, B, P, live, edges, device, seed=0, repacked=False):
    """The arguments of `spatial_graph` for T tasks' packed sets
    (`packed_edges`), over their T * B * P slots or, `repacked`, over T
    bins of M = `bin_rows` of B * live rows, slot i of bin b at row
    b * live + i, with the segments of each original bin: what
    data/repack.py makes of a set whose every bin holds `live`."""
    src, dst, mask, node = packed_edges(T, B, P, live, edges, device, seed)
    if not repacked:
        return src, dst, mask, node, B, P
    src, dst = (x // P * live + x % P for x in (src, dst))
    M = bin_rows([B * live])
    fill = torch.full((T, B), live, device=device, dtype=torch.int32)
    node = (torch.arange(M, device=device) < B * live).float().expand(
        T, 1, M)
    return src, dst, mask, node, 1, M, segments(fill, M,
                                                np.full((T, B), live))


def packed_graph(T, B, P, live, edges, device, seed=0, repacked=False):
    """The SpatialGraph of `graph_inputs`."""
    return sa.spatial_graph(*graph_inputs(T, B, P, live, edges, device,
                                          seed, repacked))


def lengths(graph) -> list:
    """Each segment's rows (a host read of the graph's segments)."""
    seg = graph.seg.cpu().long()
    return (seg[1:] - seg[:-1]).tolist()


def operands(graph, K, D, device, seed=0):
    """Random (qkv (N, 3 K D), table (T, 512, K), g (N, K D)) for the
    graph."""
    gen = torch.Generator(device=device).manual_seed(seed)
    N = graph.live.numel()
    T = (graph.seg.numel() - 1) // graph.per_task
    qkv = torch.randn(N, 3 * K * D, generator=gen, device=device)
    table = torch.randn(T, sa.TABLE_ROWS, K, generator=gen, device=device)
    g = torch.randn(N, K * D, generator=gen, device=device)
    return qkv, table, g


def main(argv=None):
    ap = parser("bench_graphormer", __doc__)
    args = ap.parse_args(argv)
    device, head = start(args.device)
    cuda = device.type == "cuda"
    rows_out = []
    for name, (T, B, P, live, edges) in (SHAPES if cuda else TINY).items():
        inputs = graph_inputs(T, B, P, live, edges, device, repacked=True)
        graph = sa.spatial_graph(*inputs)
        ns = lengths(graph)
        K, D = HEADS if cuda else (2, 4)
        qkv, table, g = operands(graph, K, D, device)
        o, lse = sa.fwd_plain(graph, qkv, table, K, D)
        row = {"set": name, "T": T, "B": B, "P": P, "live": live,
               "rows": graph.live.numel(), "segments": len(ns),
               "edges": edges, "K": K, "D": D}
        for d in ("fwd", "bwd"):
            bound, what, _ = spatial_attention_bound(ns, K, D, d)
            row[f"{d}_bound_ms"], row[f"{d}_bound"] = bound, what
        if cuda:
            row["fwd_ms"] = device_ms(
                lambda: sa._launch_fwd(graph, qkv, table, K, D), device)
            row["bwd_ms"] = device_ms(
                lambda: sa._launch_bwd(graph, qkv, table, o, lse, g, K, D),
                device)
            row["spd_ms"] = device_ms(lambda: sa.spatial_graph(*inputs),
                                      device)
            for d in ("fwd", "bwd"):
                row[f"{d}_share"] = 100 * row[f"{d}_bound_ms"] / \
                    row[f"{d}_ms"]
        row["fwd_plain_ms"] = device_ms(
            lambda: sa.fwd_plain(graph, qkv, table, K, D), device, iters=3,
            warmup=1)
        row["bwd_plain_ms"] = device_ms(
            lambda: sa.bwd_plain(graph, qkv, table, o, lse, g, K, D),
            device, iters=3, warmup=1)
        rows_out.append(row)
        del qkv, table, g, o, lse
    table = ["| set, heads | ms fwd / bwd (4 kernels) | bound ms fwd / bwd "
             "| share fwd / bwd | distances ms | plain ms "
             "fwd / bwd |", "|---|---|---|---|---|---|"]
    for r in rows_out:
        table.append(
            f"| {r['set']}, {r['K']} x {r['D']} | {fmt(r.get('fwd_ms'))} / "
            f"{fmt(r.get('bwd_ms'))} | {fmt(r['fwd_bound_ms'])} / "
            f"{fmt(r['bwd_bound_ms'])} | {fmt(r.get('fwd_share'), 1)} / "
            f"{fmt(r.get('bwd_share'), 1)} | {fmt(r.get('spd_ms'))} | "
            f"{fmt(r['fwd_plain_ms'])} / {fmt(r['bwd_plain_ms'])} |")
    return finish({**head, "rows": rows_out}, args.out, table)


if __name__ == "__main__":
    main()
