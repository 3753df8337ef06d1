"""Throughput benchmark of the port: steady-state meta-training on all five
recipes' shapes, one JSON line.

Counterpart of bench.py (the JAX package's benchmark), with its keys:

    python -m gmeta_tpu_torch.bench [--device cpu] [--out FILE]

Each shape replays the bucket geometry of that recipe's run of record
(`parity/<recipe>.json`: P/B/E per set, bin fill, aggregation) on a
synthesized packed pool resident on the device in compact form, as the
Trainer runs it, so no host pipeline runs in the timed window; a recipe
without a record falls back to the synthetic-graph path (extraction and
packing at whatever buckets result). The records ran on a TPU: only their
shapes are used here, never their times. Every shape runs in bf16 with
theta from seed 0, as the JAX bench does, first with the record's
aggregation and then with agg="sized" where the record chose dense, so
the packed kernel runs in every shape.

Per shape the JSON carries:
- tasks_per_s over one call of `steps` meta-steps (MEASURE_STEPS), ending
  in a sync, and vs_baseline against that recipe's BASELINE.md row;
- edges_per_s: real (unpadded) edges ingested per second;
- flops_per_step: one warm meta-step's FLOPs, counted outside the timed
  window with every inner step forward and backward: the library products
  (mm, bmm, addmm) by `torch.utils.flop_counter.FlopCounterMode`, which
  counts dense's aggregations as torch.bmm at 2 S P^2 H, and the sized
  kernel's calls, which it does not see, at that same figure, the TPU
  kernel's own cost estimate (ops/spmm.py `count_aggregation`), so dense
  and sized are held to the same work: both are counted on the packed
  slot layout (a batch of tensors, which the learner runs as given),
  while the timed sized runs are repacked over live rows only
  (data/repack.py), so there mfu credits pad rows' work the step no
  longer does, as the JAX bench credits it; useful_flops counts every
  aggregation at 2 nnz H (its live edges) instead, and pad_waste is the
  dense slots over the real edges per task;
- mfu: flops_per_step x steps / seconds over the card's peak (bf16 on
  the tensor cores, utils/cardtime.py); null on the CPU and on a card
  that cardtime's rates do not describe;
- compile_s: the first call, one meta-step (the kernels' build where they
  are not built yet, cuBLAS's handles, the allocator's warm-up), ending
  in a sync; nothing is compiled ahead of time in the port;
- profile: the card's busy share of one more meta-step and its device
  time by kernel (utils/cardtime.py `profile`; null on the CPU);
- step_s, peak_gb (device memory in the timed window, null on the CPU),
  the first and last meta-losses, and production_tasks_per_s: the port's
  parity runner on the card for the recipe (`parity_torch/<recipe>.json`).

Before each call theta and Adam are set back to the seed's, so the warm
call, the counted step and the timed window all start where the JAX
bench's compiled calls do, and theta after the run is the timed window's.

Also benches extraction: the device extractor (data/device_extract.py)
against the port's C++ engine (data/native.py) on the arxiv-shaped graph.

Without a card and with no `--device cpu` this raises. A shape or the
extraction that fails is recorded as an "error" in the line, and the exit
code is then 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import NamedTuple

import numpy as np
import torch

from gmeta_tpu_torch.utils.device import resolve_device

MEASURE_STEPS = 16
POOL = 48

# Per-recipe baselines: tasks/s from BASELINE.md (task_num / step time).
SHAPES = {
    "arxiv": dict(kind="disjoint", baseline=6.5, nodes=170_000, deg=28,
                  feat=128, hidden=256, classes=15, n_way=3, k_spt=3,
                  k_qry=24, update_step=10, task_num=32, sample_nodes=1000),
    "tissue_ppi": dict(kind="shared", baseline=7.3, graphs=4, nodes=4_000,
                       deg=30, feat=50, hidden=128, classes=2, k_spt=3,
                       k_qry=10, update_step=10, task_num=4,
                       sample_nodes=1000),
    "fold_ppi": dict(kind="disjoint", baseline=4.3, nodes=30_000, deg=24,
                     feat=512, hidden=128, classes=15, n_way=3, k_spt=3,
                     k_qry=24, update_step=5, task_num=16,
                     sample_nodes=1000),
    "firstmm_db": dict(kind="link", baseline=12.3, graphs=4, nodes=1_350,
                       deg=6, feat=5, hidden=128, k_spt=16, k_qry=32,
                       update_step=10, task_num=8, sample_nodes=1000),
    "tree_of_life": dict(kind="link", baseline=11.1, graphs=4, nodes=2_900,
                         deg=14, feat=1, hidden=256, k_spt=16, k_qry=16,
                         update_step=10, task_num=8, sample_nodes=1000),
}

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Replica feature width + head classes per recipe, pinned by the
# reference's printed parameter counts (BASELINE.md: 99,587 / 23,298 /
# 82,563 / 17,794 / 67,330).
REPLICA_META = {
    "arxiv": dict(feat=128, n_out=3),
    "tissue_ppi": dict(feat=50, n_out=2),
    "fold_ppi": dict(feat=512, n_out=3),
    "firstmm_db": dict(feat=5, n_out=2),
    "tree_of_life": dict(feat=1, n_out=2),
}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _load_json(*parts):
    p = os.path.join(ROOT, *parts)
    if os.path.exists(p):
        with open(p) as f:
            return json.load(f)
    return None


def _load_parity(name):
    """The run of record (`parity/<name>.json`, a TPU's run), or None."""
    return _load_json("parity", f"{name}.json")


def _synth_set(rng, P, B, E, S, n_out, fill, n_feat, real_edges, link):
    """One packed SubgraphSet at exactly the recorded bucket shape, with
    per-bin live fill matching the run of record and `real_edges` live
    intra-bin edges, drawn as the JAX bench draws it. Content is random:
    step cost at these shapes depends on the shapes, the fill and the
    gather widths, not on which neighbours the edges name. Raises where
    the feature table has no more than 4P rows: the clustered gids would
    then index past it (a device assert on CUDA)."""
    from gmeta_tpu_torch.data.pack import SubgraphSet
    if n_feat <= 4 * P:
        raise ValueError(f"a feature table of {n_feat} rows cannot hold "
                         f"the clustered gids of P = {P} (needs > {4 * P})")
    live = np.full(B, min(max(int(round(fill * P)), 1), P), np.int32)
    mask = (np.arange(P)[None, :] < live[:, None]).astype(np.float32)
    # clustered per-bin gids: a real subgraph's nodes are a local
    # neighbourhood, so the feature gather hits a narrow window of the table
    base = rng.randint(0, n_feat - 4 * P, size=(B, 1))
    node_gid = ((base + rng.randint(0, 4 * P, size=(B, P)))
                * (mask > 0)).astype(np.int32)
    e = min(int(real_edges), E)
    bins = rng.randint(0, B, size=e)
    src_l = (rng.random_sample(e) * live[bins]).astype(np.int64)
    dst_l = (rng.random_sample(e) * live[bins]).astype(np.int64)
    flat_dst = bins * P + dst_l
    order = np.argsort(flat_dst, kind="stable")   # nondecreasing dst
    edge_src = np.zeros(E, np.int32)
    edge_dst = np.full(E, B * P - 1, np.int32)
    edge_mask = np.zeros(E, np.float32)
    edge_src[:e] = (bins * P + src_l)[order]
    edge_dst[:e] = flat_dst[order]
    edge_mask[:e] = 1.0
    centers = np.zeros((S, 2), np.int32)
    for k in range(S):
        b = k % B
        c0 = int(rng.random_sample() * live[b])
        c1 = int(rng.random_sample() * live[b]) if link else c0
        centers[k] = (b * P + c0, b * P + c1)
    labels = np.tile(np.arange(n_out), S // n_out + 1)[:S].astype(np.int32)
    return SubgraphSet(node_gid=node_gid, node_mask=mask,
                       edge_src=edge_src, edge_dst=edge_dst,
                       edge_mask=edge_mask, centers=centers, labels=labels,
                       bin_fill=live)


def _pool_from_parity(name, s, rec, pool=POOL):
    """(features_table, stacked pool of `pool` tasks, mean_edges_per_task,
    agg) replaying the run of record's geometry: buckets, bin fill and
    aggregation from `rec`, episode structure from the shape."""
    from gmeta_tpu_torch.data.pack import TaskBatch, stack_tasks

    meta = REPLICA_META[name]
    b = rec["buckets"]
    geo = record_geometry(rec)
    fill, mean_edges = geo.mean_bin_fill, geo.mean_edges_per_task
    agg = rec.get("agg", "dense")
    link = s["kind"] == "link"
    n_way = s.get("n_way", 2 if link else meta["n_out"])
    S_spt = n_way * s["k_spt"]
    S_qry = n_way * s["k_qry"]
    E_tot = b["E_spt"] + b["E_qry"]
    rng = np.random.RandomState(11)
    n_feat = 200_000
    feats = rng.randn(n_feat, meta["feat"]).astype(np.float32)
    tasks = []
    for _ in range(pool):
        spt = _synth_set(rng, b["P_spt"], b["B_spt"], b["E_spt"], S_spt,
                         meta["n_out"], fill, n_feat,
                         mean_edges * b["E_spt"] / E_tot, link)
        qry = _synth_set(rng, b["P_qry"], b["B_qry"], b["E_qry"], S_qry,
                         meta["n_out"], fill, n_feat,
                         mean_edges * b["E_qry"] / E_tot, link)
        tasks.append(TaskBatch(spt=spt, qry=qry))
    return feats, stack_tasks(tasks), mean_edges, agg


def _build_dataset(name, s, pool=POOL):
    """The fallback without a record: the port's synthetic dataset of the
    shape's kind, `pool` train tasks. Returns (store, train, n_out)."""
    from gmeta_tpu_torch.data.synthetic import (synthetic_disjoint,
                                                synthetic_link_pred,
                                                synthetic_shared)
    if s["kind"] == "disjoint":
        store, ds = synthetic_disjoint(
            num_graphs=1, nodes_per_graph=s["nodes"], avg_degree=s["deg"],
            feat_dim=s["feat"], num_classes=s["classes"], n_way=s["n_way"],
            k_spt=s["k_spt"], k_qry=s["k_qry"], batchsz=pool, h=2,
            sample_nodes=s["sample_nodes"], seed=7)
        n_out = s["n_way"]
    elif s["kind"] == "shared":
        store, ds = synthetic_shared(
            num_graphs=s["graphs"], nodes_per_graph=s["nodes"],
            avg_degree=s["deg"], feat_dim=s["feat"],
            num_classes=s["classes"], k_spt=s["k_spt"], k_qry=s["k_qry"],
            batchsz=pool, h=2, sample_nodes=s["sample_nodes"], seed=7)
        n_out = s["classes"]
    else:
        store, ds = synthetic_link_pred(
            num_graphs=s["graphs"], nodes_per_graph=s["nodes"],
            avg_degree=s["deg"], feat_dim=s["feat"], k_spt=s["k_spt"],
            k_qry=s["k_qry"], batchsz=pool,
            sample_nodes=s["sample_nodes"], seed=7)
        n_out = 2
    return store, ds["train"], n_out


class ShapeData(NamedTuple):
    """A shape's host data, made once and shared by its runs."""
    feats: np.ndarray
    tasks: object            # stacked TaskBatch of `pool` tasks
    mean_edges: float
    agg: str                 # the record's (or agg_for's) choice
    buckets: dict
    n_out: int
    geometry: str            # "parity_buckets" or "synthetic"
    pool: int
    data_s: float


def shape_spec(s, feat: int, n_out: int):
    """The layer spec a shape's runs train (h 2, the shape's hidden width
    and kind) over `feat` input features and `n_out` classes."""
    from gmeta_tpu_torch.config import Config, build_model_config
    cfg = Config(h=2, hidden_dim=s["hidden"],
                 link_pred_mode=(s["kind"] == "link"),
                 task_setup="Shared" if s["kind"] != "disjoint" else "Disjoint")
    return build_model_config(cfg, feat, n_out)


def record_geometry(rec) -> "SplitGeometry":
    """What data/pipeline.py `agg_for` reads of a run of record: its
    buckets, bin fill and real edges per task."""
    from gmeta_tpu_torch.data.pipeline import SplitGeometry
    b = rec["buckets"]
    mean_edges = (rec["edges_per_s"] / rec["tasks_per_s"]
                  if rec.get("tasks_per_s") else 0.0)
    return SplitGeometry(
        b["P_spt"], b["B_spt"], b["E_spt"], b["P_qry"], b["B_qry"],
        b["E_qry"], mean_edges, float(rec.get("mean_bin_fill", 0.7)))


def shape_data(name, s, rec=None, pool=POOL, device=None) -> ShapeData:
    """The pool of a shape: from `rec` (default: `parity/<name>.json`)
    where there is a record, with the record's aggregation, else from the
    synthetic dataset, with what agg="auto" picks for it on `device`
    (data/pipeline.py `agg_for` at the shape's widths, bf16)."""
    t0 = time.time()
    rec = _load_parity(name) if rec is None else rec
    if rec is not None:
        feats, tasks, mean_edges, agg = _pool_from_parity(name, s, rec, pool)
        buckets, n_out = dict(rec["buckets"]), REPLICA_META[name]["n_out"]
        geometry = "parity_buckets"
    else:
        from gmeta_tpu_torch.data.pipeline import agg_for
        store, train, n_out = _build_dataset(name, s, pool)
        feats, tasks = store.features, train.stacked_pool()
        mean_edges = train.mean_edges_per_task
        agg = agg_for(train, resolve_device(device),
                      shape_spec(s, store.feat_dim, n_out), "bfloat16")
        buckets = dict(P_spt=train.P_spt, B_spt=train.B_spt,
                       E_spt=train.E_spt, P_qry=train.P_qry,
                       B_qry=train.B_qry, E_qry=train.E_qry)
        geometry = "synthetic"
    data = ShapeData(feats, tasks, mean_edges, agg, buckets, n_out,
                     geometry, pool, time.time() - t0)
    log(f"# {name}: data {data.data_s:.1f}s [{geometry}] buckets"
        f" spt(P={buckets['P_spt']},B={buckets['B_spt']},"
        f"E={buckets['E_spt']}) qry(P={buckets['P_qry']},"
        f"B={buckets['B_qry']},E={buckets['E_qry']}) agg={agg}")
    return data


def count_flops(step, agg: str):
    """(flops, useful_flops, aggregation flops) of one call of `step`, a
    meta-step: the FLOPs FlopCounterMode counts, which hold dense's
    aggregations (torch.bmm), plus the sized kernel's calls, which it does
    not see, each (forward or transpose) at 2 S P^2 H. useful_flops counts
    every aggregation at 2 nnz H instead."""
    from torch.utils.flop_counter import FlopCounterMode

    from gmeta_tpu_torch.ops.spmm import count_aggregation

    with FlopCounterMode(display=False) as counter, \
            count_aggregation() as work:
        step()
    flops = counter.get_total_flops() + (work.flops if agg == "sized" else 0)
    return flops, flops - work.flops + work.useful, work.flops


def run_shape(name, s, *, agg=None, device=None, steps=MEASURE_STEPS,
              pool=POOL, rec=None, data=None, dtype=torch.bfloat16,
              init=None, profile_top=12):
    """bench_shape's run; returns (result, the MetaLearner). `data` is the
    shape's `shape_data` (made here from `rec` and `pool` when None);
    `init` a flat theta (numpy, the JAX layout) in place of seed 0's;
    `dtype` the compute dtype (the bench's is bf16); `profile_top` how
    many kernels the profile lists."""
    from gmeta_tpu_torch.meta.maml import MetaLearner, batch_to, take_tasks
    from gmeta_tpu_torch.utils import cardtime

    device = resolve_device(device)
    if data is None:
        data = shape_data(name, s, rec, pool)
    agg = agg or data.agg
    spec = shape_spec(s, data.feats.shape[1], data.n_out)
    # without remat, on the compact pool the Trainer runs
    ml = MetaLearner(spec, data.n_out, update_lr=0.01, meta_lr=1e-3,
                     update_step=s["update_step"],
                     update_step_test=s["update_step"], remat=False,
                     compute_dtype=dtype, seed=0, track_curve=False,
                     agg=agg, device=device)
    if init is not None:
        ml.set_params(init)
    ml.set_features(data.feats)
    ml.set_task_pool_compact(data.tasks)
    run = ml.train_steps_from_compact
    rng = np.random.RandomState(0)
    idx_mat = np.stack([rng.choice(data.pool, s["task_num"], replace=False)
                        for _ in range(steps)]).astype(np.int32)
    theta0 = ml.snapshot()
    cuda = device.type == "cuda"

    t0 = time.time()
    run(idx_mat[:1])
    cardtime.sync(device)
    compile_s = time.time() - t0

    ml.set_params(theta0)
    # a batch already on the device is not repacked: the slot layout's work
    first = batch_to(take_tasks(data.tasks, idx_mat[0]), device)
    flops, useful, agg_flops = count_flops(lambda: ml.train_step(first), agg)
    del first

    ml.set_params(theta0)
    cardtime.sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    ms = run(idx_mat)
    cardtime.sync(device)
    dt = time.time() - t0

    busy = None
    if cuda:            # one more step, profiled; theta stays the window's
        theta = ml.snapshot()
        busy = cardtime.profile(lambda: run(idx_mat[:1])["meta_loss"],
                                top=profile_top)
        ml.set_params(theta)
    losses = ms["meta_loss"].float().cpu().numpy()
    if not np.isfinite(losses).all() or int(ms["nan_skip"].sum()):
        raise FloatingPointError(f"{name} {agg}: meta-losses {losses}")
    tasks_per_s = steps * s["task_num"] / dt
    b = data.buckets
    slots = b["B_spt"] * b["P_spt"] ** 2 + b["B_qry"] * b["P_qry"] ** 2
    peak = cardtime.BF16_PEAK if dtype == torch.bfloat16 \
        else cardtime.FP32_PEAK
    out = {
        "tasks_per_s": tasks_per_s,
        "agg": agg,
        "geometry": data.geometry,
        "vs_baseline": tasks_per_s / s["baseline"],
        "edges_per_s": tasks_per_s * data.mean_edges,
        "mfu": (flops * steps / dt / peak
                if cardtime.rates_apply(device) else None),
        "pad_waste": slots / max(data.mean_edges, 1.0),
        "compile_s": compile_s,
        "step_s": dt / steps,
        "buckets": b,
        "flops_per_step": flops,
        "useful_flops": useful,
        "agg_flops_per_step": agg_flops,
        "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                    if cuda else None),
        "steps": steps,
        "task_num": s["task_num"],
        "dtype": str(dtype).replace("torch.", ""),
        "pool_mode": "compact",
        "meta_loss_first": float(losses[0]),
        "meta_loss_last": float(losses[-1]),
        "profile": busy,
    }
    prod = _load_json("parity_torch", f"{name}.json")
    if prod is not None and prod.get("tasks_per_s"):
        # the port's parity runner on the card, host pipeline included
        out["production_tasks_per_s"] = prod["tasks_per_s"]
        out["production_card"] = prod.get("card")
    return out, ml


def bench_shape(name, s, *, agg=None, device=None, steps=MEASURE_STEPS,
                pool=POOL, **kw) -> dict:
    """One shape's result (see the module docstring). `agg` None replays
    the record's choice; `kw` as `run_shape`."""
    return run_shape(name, s, agg=agg, device=device, steps=steps,
                     pool=pool, **kw)[0]


def bench_extraction(device=None, nodes=170_000) -> dict:
    """The device extractor against the port's C++ engine (two threads) on
    the arxiv-shaped graph: C = 64 centres, 4 rounds, extractions/s of
    each. Raises where the engine cannot be built."""
    from gmeta_tpu_torch.data import native
    from gmeta_tpu_torch.data.device_extract import DeviceExtractor
    from gmeta_tpu_torch.data.graph import synthetic_store

    device = resolve_device(device)
    store, _ = synthetic_store(1, nodes, 28, 8, 3, seed=3)
    g = store.graphs[0]
    rng = np.random.RandomState(0)
    C, ROUNDS = 64, 4
    centers = rng.randint(0, g.num_nodes, size=(ROUNDS, C)).astype(np.int64)

    dev = DeviceExtractor(g, h=2, sample_nodes=1000, set_cap=1 << 16,
                          hop_budget=1 << 18, edge_budget=1 << 17,
                          edge_out=1 << 15, seed=0, device=device)
    out = dev.extract_arrays(centers[0])          # first call + warm
    out.n_nodes.cpu()
    overflow = 0
    t0 = time.time()
    for r in range(ROUNDS):
        out = dev.extract_arrays(centers[r])
        overflow += int(out.overflow.sum())       # sync
    dev_rate = ROUNDS * C / (time.time() - t0)

    if not native.available():
        raise RuntimeError("the C++ extraction engine cannot be built here")
    nat = native.NativeSubgraphExtractor([g], h=2, sample_nodes=1000,
                                         seed=0, n_threads=2)
    t0 = time.time()
    nat.extract_many([f"0_{c}" for c in centers.ravel()])
    return {"device_extract_per_s": dev_rate,
            "native_extract_per_s": ROUNDS * C / (time.time() - t0),
            "device_overflow": overflow, "nodes": g.num_nodes,
            "edges": g.num_edges, "centers": ROUNDS * C}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        "python -m gmeta_tpu_torch.bench",
        description="Meta-training throughput at the five recipes' shapes, "
                    "one JSON line.")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no CUDA and no name raises")
    ap.add_argument("--out", default=None, help="also write the line here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    head = {"device": str(device), "torch": torch.__version__}
    if device.type == "cuda":
        from gmeta_tpu_torch.utils.cardtime import card_line
        head.update(kind=torch.cuda.get_device_name(device),
                    card=card_line())
        log(f"# {head['kind']}; nvidia-smi: {head['card']}")

    ok, shapes = True, {}
    for name, s in SHAPES.items():
        try:
            data = shape_data(name, s, pool=POOL, device=device)
            kw = dict(device=device, steps=MEASURE_STEPS, data=data)
            res = bench_shape(name, s, **kw)
            if res["agg"] != "sized":
                res["sized"] = bench_shape(name, s, agg="sized", **kw)
            del data
        except Exception as e:  # noqa: BLE001 - recorded; the exit code says
            traceback.print_exc()
            res, ok = {"error": f"{type(e).__name__}: {e}"[:300]}, False
        if device.type == "cuda":
            torch.cuda.empty_cache()
        shapes[name] = res
        log(f"# {name}: {res}")

    try:
        extraction = bench_extraction(device)
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        extraction, ok = {"error": f"{type(e).__name__}: {e}"[:300]}, False
    log(f"# extraction: {extraction}")

    arxiv = shapes.get("arxiv", {})
    line = {
        "metric": "meta_train_tasks_per_s",
        "value": arxiv.get("tasks_per_s", 0.0),
        "unit": "tasks/s",
        "vs_baseline": arxiv.get("vs_baseline", 0.0),
        "shapes": shapes,
        "extraction": extraction,
        **head, "steps": MEASURE_STEPS, "pool": POOL,
    }
    text = json.dumps(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
