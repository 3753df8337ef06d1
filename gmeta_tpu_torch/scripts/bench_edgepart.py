"""Absolute full-graph edges/s of the edge-partitioned engine on one card.

Counterpart of scripts/bench_edgepart.py: the port's EdgePartMetaTrainer
at --mesh_edges 1 on a world of one (NCCL on CUDA, gloo on the CPU),
over the disjoint union (run/edgepart.py `union_graph`) of the first
--graphs graphs of the Tree-of-Life replica (graphs.npz only: features,
centers and labels are drawn here; this measures the compute path). The
JAX script had to stop at a prefix, because the whole 5.33M-node,
60.8M-edge union crashed the TPU worker; here --graphs runs up to all
1,840.

It reports the JAX script's metric, edgepart_fullgraph_edges_per_s =
tasks/s x union edges (one task traverses the whole union, all layers
and inner steps counted once, as run/edgepart.py counts), with the
step seconds, the peak device memory, and the launches of the engine's
kernels (`csr_slab_kernel` through `csr_gather`, and the combine kernel
on split rows). A step that does not fit in the card's memory writes its
peak and the error, then raises.

    python -m gmeta_tpu_torch.scripts.bench_edgepart [--graphs 400]
        [--hidden 16] [--update_step 2] [--task_num 8] [--steps 3]
        [--data replicas/tree_of_life] [--device cpu] [--out PATH]

The replica comes from
    python -m gmeta_tpu_torch.data.replicas tree_of_life --out replicas
"""

from __future__ import annotations

import gc
import math
import os
import sys
import time

import numpy as np
import torch

from gmeta_tpu_torch.data.graph import CSRGraph, GraphStore
from gmeta_tpu_torch.ops import sized_spmm as sp
from gmeta_tpu_torch.parallel import mesh as mesh_mod
from gmeta_tpu_torch.parallel.edgepart_train import (EdgePartMetaTrainer,
                                                     EdgePartTask)
from gmeta_tpu_torch.run.edgepart import union_graph
from gmeta_tpu_torch.scripts.common import ROOT, finish, fmt, parser, start
from gmeta_tpu_torch.utils.cardtime import sync
from gmeta_tpu_torch.utils.metrics import counted

MAKE = "python -m gmeta_tpu_torch.data.replicas tree_of_life --out replicas"


def load_prefix(path: str, n: int):
    """The first n graphs of a graphs.npz (data/io.py's layout), reading
    no other graph's arrays."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} is missing: make the Tree-of-Life replica with `{MAKE}`"
            f" (or name another with --data)")
    with np.load(path) as z:
        n = min(n, int(z["num_graphs"]))
        return [CSRGraph(indptr=z[f"indptr_{i}"], indices=z[f"indices_{i}"])
                for i in range(n)]


def main(argv=None):
    ap = parser("bench_edgepart", __doc__)
    ap.add_argument("--graphs", type=int, default=400)
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--update_step", type=int, default=2)
    ap.add_argument("--task_num", type=int, default=8)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--data", default=str(ROOT / "replicas" / "tree_of_life"))
    args = ap.parse_args(argv)
    device, head = start(args.device)
    cuda = device.type == "cuda"

    t0 = time.perf_counter()
    graphs = load_prefix(os.path.join(args.data, "graphs.npz"), args.graphs)
    rng = np.random.RandomState(0)
    feats = [rng.randn(g.num_nodes, 1).astype(np.float32) for g in graphs]
    store = GraphStore(graphs, feats)
    g = union_graph(store)
    V, E = g.num_nodes, g.num_edges
    load_s = time.perf_counter() - t0
    print(f"# union: {len(graphs)} graphs, {V:,} nodes, {E:,} edges "
          f"({load_s:.1f} s)", file=sys.stderr, flush=True)
    out = dict(head, metric="edgepart_fullgraph_edges_per_s",
               unit="edges/s", graphs=len(graphs), nodes=V, edges=E,
               hidden=args.hidden, update_step=args.update_step,
               task_num=args.task_num, steps=args.steps, load_s=load_s)

    created = mesh_mod.init_distributed("nccl" if cuda else "gloo", device)
    try:
        mesh = mesh_mod.make_mesh(task=1, edge=1, device=device)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        tr = EdgePartMetaTrainer(
            [(1, args.hidden), (args.hidden, args.hidden)], (args.hidden, 2),
            2, g=g, feats=store.features, mesh=mesh, link_pred=True,
            update_lr=0.005, meta_lr=5e-4, update_step=args.update_step,
            update_step_test=args.update_step, seed=0)
        out["build_s"] = time.perf_counter() - t0
        del graphs, feats, store, g          # the CSRs are on the device
        gc.collect()

        def make_task():
            T, S = args.task_num, 32
            c = rng.randint(0, V, size=(T, S, 2)).astype(np.int32)
            q = rng.randint(0, V, size=(T, S, 2)).astype(np.int32)
            y = np.tile(np.tile(np.arange(2), S // 2), (T, 1)).astype(np.int32)
            return EdgePartTask(c, y, q, y)

        launched = counted()
        try:
            t0 = time.perf_counter()
            m = tr.train_step(make_task())            # warm
            out["first_step_s"] = time.perf_counter() - t0
            sync(device)
            t0 = time.perf_counter()
            for _ in range(args.steps):
                m = tr.train_step(make_task())
            loss = m["meta_loss"].item()
            dt = time.perf_counter() - t0
        except torch.OutOfMemoryError as e:
            out["oom"] = str(e).splitlines()[0]
            out["peak_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
            finish(out, args.out, [])
            raise
    finally:
        if created:
            import torch.distributed as dist
            dist.destroy_process_group()
    if not math.isfinite(loss):
        raise AssertionError(f"meta_loss {loss}")
    tasks_per_s = args.steps * args.task_num / dt
    out.update(value=tasks_per_s * E, tasks_per_s=tasks_per_s,
               step_s=dt / args.steps, meta_loss=loss,
               peak_gb=(torch.cuda.max_memory_allocated(device) / 1e9
                        if cuda else None),
               launches={"csr": launched.of(sp.CSR_LAUNCHES),
                         "combine": launched.of(sp.COMBINE_LAUNCHES)})
    if cuda and not all(out["launches"]["csr"].values()):
        raise RuntimeError(f"csr_gather did not launch both ways: "
                           f"{out['launches']}")
    lines = ["| graphs | nodes | edges | hidden | step s | tasks/s | edges/s |"
             " peak GB |", "|---" * 8 + "|",
             f"| {out['graphs']} | {V:,} | {E:,} | {args.hidden} | "
             f"{out['step_s']:.3f} | {tasks_per_s:.3f} | {out['value']:.4g} | "
             f"{fmt(out['peak_gb'], 2)} |"]
    return finish(out, args.out, lines)


if __name__ == "__main__":
    main()
