#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gmeta_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. device   — CUDA must be available; prints the card's name and power
                limit (nvidia-smi).
  2. build    — compiles csrc/sized_spmm.cu from this checkout (nvcc,
                sm_90a).
  3. checks   — each kernel against its plain PyTorch version on the card,
                on packed edge lists (duplicates, pad edges): P in
                {512, 1024}, live sizes {0, 1, 127, 129, P},
                H in {1, 5, 50, 128, 256}, float32 and bf16; the forward,
                the backward through SizedAgg, and a double backward.
  4. data     — the arxiv-scale synthetic graph (170k nodes, degree 28,
                128 features, 15 classes, 1000-node subgraph cap) and its
                episodes (192 train tasks, 48 val and 48 test), built with
                the port's numpy host layer.
  5. timing   — both kernels at this run's arxiv query batch (72 bins per
                task x the meta-step's tasks, P = 1024, the batch's real
                edges), H = 128 and 256, float32, after checking that the
                CSRs hold densify's edges and degrees: kernel, plain
                version, torch.sparse.mm of the same CSR (cuSPARSE) and
                torch.bmm over the dense blocks (what agg="dense" runs),
                the last two yardsticks only; medians of CUDA-event times
                over 20 launches, beside the least time the card could take
                for this data: reading the x rows the edges name and the
                int32 indices once and writing the output once, or the
                2 x nnz x H operations of the edges, whichever is longer.
  6. cuda=cpu — at a small size, one train_step on cuda (kernels) equals
                the same step on cpu (plain versions) from the same params.
  7. slice    — Trainer.fit at the arxiv preset's widths with agg="sized",
                float32, cut to 6 meta-steps of 32 tasks (batchsz 10000 ->
                192), 48 val/test tasks (eval_batchsz 100 -> 48), 1 epoch
                (10 -> 1). Kernel launch counts are set to 0 just before it
                and read just after; both kernels must have run. Then warm
                sized and dense meta-steps in turns, with the seconds and
                peak device memory of each, and a profiled sized step.
  8. modes    — the same fit in the three execution modes, from the same
                initial theta, in turns (streaming, compact, host-windowed,
                host-windowed, compact, streaming), 2-step windows: the
                compact pool resident on the card, and the host-windowed
                pool (compact_pool_hbm_gb=0, host_pool_window=2, pinned
                buffers), shown to be entered. Launch counts are set to 0
                before each fit and read after it; every fit must launch
                both kernels and reach the same global_step. The pool fits
                must agree with each other (bitwise, or within rtol 1e-6)
                and with the streaming fit (rtol 1e-5). Then a compact fit
                that checkpoints every window is killed after its first
                window and resumed mid-epoch by a fresh Trainer; its theta
                must equal the straight compact fit's (rtol 1e-5).
  9. cli      — the CLI from disk: prepare, extract, remat.
                (a) phase 4's graph written with the port's
                prepare_node_disjoint under build/chip_smoke_data/ (3 labels
                each for val and test); (b) build_datasets three times,
                timed: extractor numpy, native cold (writes the disk cache),
                native from the cache; the two native builds must give
                bitwise-equal episodes and packed batches; each engine's
                extractions/s, the host's CPU count and the cache's bytes;
                (c) the device extractor on the card over the first train
                batch's centers at several centers per pass, each
                uncapped center bit-equal to the native engine; (d) main()
                with --preset arxiv --agg sized --extractor native
                --batchsz 192 --eval_batchsz 48 --epoch 1, remat_inner on
                and off in turns: both kernels launch in every fit (counts
                set to 0 before each), theta equal (bitwise or rtol 1e-6),
                peak device memory and warm tasks/s of each; (e) isolated
                second-order meta-steps at arxiv width (task_vmap_chunk 8),
                remat on and off in turns, seconds and peak memory. The
                prepared directory stays for phase 10 and is removed after.
  10. mesh    — multi-rank training from phase 9's directory. (a) main()
                with --mesh_tasks 1 and 9(d)'s flags, a world of one on
                NCCL in this process: both packed kernels launch, theta
                equals 9(d)'s plain fit (bitwise or rtol 1e-6), warm tasks/s
                beside 9(d)'s. (b) main() with --mesh_edges 1 at the arxiv
                preset's widths and depth, tasks cut (batchsz 96, eval 32):
                the edge-partitioned engine on a world of one (NCCL), its
                step seconds, warm tasks/s, peak memory, csr_gather launches
                per direction, communication plan and one profiled
                meta-step (device time by kernel); then the rectangular
                entry point `csr_gather` timed on that engine's CSR pair
                (the whole graph, both directions, H = 128 and 256, float32)
                like phase 5, against torch.sparse.mm of the same CSR and
                its bound. (c) ranks sharing this card over gloo, each a
                process of its own (parallel/launch.py, this script with
                --rank): --mesh_tasks 4 on the packed path (theta equal to
                (a)), and --mesh_tasks 2 --mesh_edges 2 on the edge engine
                with the depth cut (task_num 4, update_step 2,
                update_step_test 2) against an in-process world of one of
                the same flags; rtol 1e-5, atol 1e-5, the head bias
                bounded; every rank launches its kernels and holds the same
                theta; the seconds each rank spent in the halo all-to-all
                and the all-reduces. Gloo between ranks of one card is no
                measure of scaling across cards.

Phase 2 builds the CUDA kernel (nvcc) and the host extraction engine (g++)
at once. Prints the kernels' JSON line (the packed kernel's launches summed
over phases 7-10 and every rank, the rectangular entry point's over phase
10), the slice's JSON line (with the modes' warm tasks/s, data_s and peak
device memory under "modes", phase 9's numbers under "cli" and phase 10's
under "mesh"), the card's name and power limit, and last
{"ok": true, "device": {...}}. Imports nothing of JAX or the JAX package,
and neither do its rank processes.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

FP32_PEAK = 67e12      # H100 SXM float32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12  # H100 SXM device memory
TOLS = {"float32": (1e-5, 1e-4), "bfloat16": (8e-3, 8e-3)}  # (rtol, atol)
# float32: sums of up to P products in another order than cuBLAS's;
# bf16: both round a float32 sum to bf16, one ulp = 2^-7 relative.


def log(msg):
    print(msg, flush=True)


def phase(name):
    log(f"== {name}")
    return time.time()


def card_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Median milliseconds of fn() on the card, one event pair per call."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timed_row(kernel, plain, library, nnz, H, read_rows, n_out):
    """Median ms of a gather kernel, its plain version and one library call
    computing the same, beside the least time the card could take for
    this data: the edges' 2 x nnz x H operations, or the table rows they
    name and the int32 CSR read once and the whole (n_out, H) float32
    output written once, whichever is longer."""
    ms = cuda_ms(kernel)
    t_ops = 2.0 * nnz * H / FP32_PEAK
    nbytes = 4.0 * (read_rows * H + n_out * H) + 4.0 * (n_out + 1 + nnz)
    t_bytes = nbytes / HBM_BYTES_S
    return dict(ms=ms, plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
                bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_gb=nbytes / 1e9, x_rows_read=read_rows,
                gb_per_s=nbytes / (ms * 1e-3) / 1e9)


def packed_graph(P, sizes, device, seed, density=0.03):
    """A packed set as data/pack.py emits it: edges inside each bin's live
    corner, about one in five duplicated, dst nondecreasing, then pad edges
    (src 0, dst S*P-1, mask 0). Returns its graph and dense adjacency."""
    import numpy as np
    import torch
    from gmeta_tpu_torch.ops.sized_spmm import sized_graph
    from gmeta_tpu_torch.ops.spmm import densify
    rng = np.random.RandomState(seed)
    S, n_pad = len(sizes), 64
    src, dst = [np.zeros(0, np.int64)], [np.zeros(0, np.int64)]
    for b, n in enumerate(sizes):
        d, s = np.nonzero(rng.rand(n, n) < density)
        reps = 1 + (rng.rand(d.size) < 0.2)
        dst.append(b * P + np.repeat(d, reps))
        src.append(b * P + np.repeat(s, reps))
    src = np.concatenate(src + [np.zeros(n_pad, np.int64)])
    dst = np.concatenate(dst + [np.full(n_pad, S * P - 1)])
    mask = np.concatenate([np.ones(src.size - n_pad), np.zeros(n_pad)])
    src, dst, mask = (torch.from_numpy(a).to(device) for a in
                      (src, dst, mask.astype(np.float32)))
    return (sized_graph(src, dst, mask, S, P),
            densify(src, dst, mask, S, P))


def check_kernels(device):
    """Phase 3. Returns {direction: {dtype: max abs err}}."""
    import torch
    from gmeta_tpu_torch.ops import sized_spmm as sp
    err = {d: {"float32": 0.0, "bfloat16": 0.0} for d in ("fwd", "bwd")}

    def close(direction, dtype, got, want):
        rtol, atol = TOLS[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol)
        e = (got.float() - want.float()).abs().max().item()
        err[direction][dtype] = max(err[direction][dtype], e)

    def plain(direction, x):
        return sp.sized_plain(*graph.csr(direction), x)

    g = torch.Generator().manual_seed(0)
    for P in (512, 1024):
        sizes = [0, 1, 127, 129, P]
        graph, A = packed_graph(P, sizes, device, seed=P)
        for H in (1, 5, 50, 128, 256):
            x32 = torch.randn(len(sizes), P, H, generator=g).to(device)
            for dtype in ("float32", "bfloat16"):
                h = x32.to(getattr(torch, dtype))
                for direction, At in (("fwd", A), ("bwd", A.transpose(1, 2))):
                    got = sp.launch(direction, graph, h)
                    close(direction, dtype, got, plain(direction, h))
                    for s, n in enumerate(sizes):
                        assert not got[s, n:].any(), (direction, s)
                    if dtype == "float32":     # the function itself
                        torch.testing.assert_close(
                            got, torch.bmm(At, h), rtol=TOLS[dtype][0],
                            atol=TOLS[dtype][1])
                # backward through SizedAgg: d/dh <r, A h> = A^T r (bwd)
                x = h.clone().requires_grad_()
                r = torch.randn(h.shape, generator=g).to(device, h.dtype)
                gx, = torch.autograd.grad((sp.aggregate_sized(graph, x) * r)
                                          .sum(), x)
                close("bwd", dtype, gx, plain("bwd", r))
                gx, = torch.autograd.grad((sp.aggregate_sized_t(graph, x)
                                           * r).sum(), x)
                close("fwd", dtype, gx, plain("fwd", r))
        # double backward (grad-of-grad through three inner steps)
        h = torch.randn(len(sizes), P, 16, generator=g).to(device)

        def meta_grad(agg):
            w0 = torch.tensor(1.0, device=device, requires_grad=True)
            w = w0
            for _ in range(3):
                inner = agg(h * w).pow(2).mean()
                gw, = torch.autograd.grad(inner, w, create_graph=True)
                w = w - 0.1 * gw
            return torch.autograd.grad(agg(h * w).sum(), w0)[0]
        got = meta_grad(lambda x: sp.aggregate_sized(graph, x))
        want = meta_grad(lambda x: plain("fwd", x))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
        log(f"  P={P}: nnz {int(graph.row_ptr[-1])}; double backward "
            f"{got.item():.6g} vs plain {want.item():.6g}")
    torch.cuda.synchronize()
    for d in err:
        log(f"  {d}: max abs err float32 {err[d]['float32']:.3g} "
            f"(tol rtol/atol {TOLS['float32']}), bf16 "
            f"{err[d]['bfloat16']:.3g} (tol {TOLS['bfloat16']})")
    return err


def arxiv_data(seed=7):
    """Phase 4: the arxiv-scale synthetic graph and its episodes (the sizes
    of bench.py's arxiv shape)."""
    from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
    return synthetic_disjoint(
        num_graphs=1, nodes_per_graph=170_000, avg_degree=28, feat_dim=128,
        num_classes=15, n_way=3, k_spt=3, k_qry=24, batchsz=192, h=2,
        sample_nodes=1000, seed=seed)


def time_kernels(batch, device):
    """Phase 5: both kernels at the main path's query batch and data."""
    import torch
    from gmeta_tpu_torch.meta.maml import batch_to
    from gmeta_tpu_torch.models.gcn import precompute
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.ops.spmm import degrees_from_dense, densify

    qry = batch_to(batch, device).qry
    T, B, P = qry.node_gid.shape
    S, N = T * B, T * B * P
    torch.cuda.synchronize()
    t0 = time.time()
    graph = precompute(qry, agg="sized").sized
    torch.cuda.synchronize()
    build_ms = (time.time() - t0) * 1e3
    # a check only: the CSRs hold densify's edges, and their degrees
    A = densify(qry.edge_src, qry.edge_dst, qry.edge_mask, B, P).view(S, P, P)
    nnz = int(graph.row_ptr[-1])
    assert nnz == int(graph.row_ptr_t[-1]) == int(qry.edge_mask.sum()) \
        == int(A.sum(dtype=torch.float64)), nnz
    assert torch.equal(graph.degrees().view(S, P).float(),
                       degrees_from_dense(A))
    assert torch.equal((graph.row_ptr_t[1:] - graph.row_ptr_t[:-1])
                       .view(S, P).float(), A.sum(dim=-2))
    live_rows = float(qry.bin_fill.double().sum())
    live_sq = float((qry.bin_fill.double() ** 2).sum())
    log(f"  S={S} bins, P={P}, mean fill {live_rows / N:.4f}, nnz {nnz} "
        f"({100 * nnz / live_sq:.3f}% of the live blocks); CSRs built in "
        f"{build_ms:.1f} ms ({8 * (N + 1 + qry.edge_mask.numel()) / 1e6:.1f}"
        f" MB) where densify's A is {A.numel() * 4 / 1e9:.2f} GB")
    g = torch.Generator(device=device).manual_seed(0)
    rows = {}
    for direction in ("fwd", "bwd"):
        row_ptr, col = graph.csr(direction)
        read_rows = torch.unique(col[:nnz]).numel()   # x rows edges name
        At = A if direction == "fwd" else A.transpose(1, 2)
        sparse = torch.sparse_csr_tensor(
            row_ptr, col[:nnz], torch.ones(nnz, device=device), size=(N, N),
            check_invariants=False)
        for H in (128, 256):
            x = torch.randn(S, P, H, device=device, generator=g)
            got = sp.launch(direction, graph, x)
            want = sp.sized_plain(row_ptr, col, x)
            e = (got - want).abs().max().item()
            rtol, atol = TOLS["float32"]
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            torch.testing.assert_close(      # the yardstick's function
                torch.sparse.mm(sparse, x.view(N, H)).view(S, P, H), want,
                rtol=rtol, atol=atol)
            del got, want
            row = rows[(direction, H)] = dict(timed_row(
                lambda: sp.launch(direction, graph, x),
                lambda: sp.sized_plain(row_ptr, col, x),
                lambda: torch.sparse.mm(sparse, x.view(N, H)),
                nnz, H, read_rows, N), max_abs_err=e,
                dense_bmm_ms=cuda_ms(lambda: torch.bmm(At, x)))
            log(f"  {direction} H={H}: kernel {row['ms']:.3f} ms "
                f"({row['gb_per_s']:.0f} GB/s of the bound's "
                f"{row['bound_gb']:.3f} GB; "
                f"{100 * row['bound_ms'] / row['ms']:.1f}% of the bound), "
                f"plain {row['plain_ms']:.3f} ms, torch.sparse.mm "
                f"{row['library_ms']:.3f} ms, torch.bmm "
                f"{row['dense_bmm_ms']:.3f} ms, bound {row['bound_ms']:.3f} "
                f"ms ({row['bound_by']}), max abs err {e:.3g}")
            del x
        del sparse
    del A
    torch.cuda.empty_cache()
    return rows, f"S={S} P={P} nnz={nnz}"


def cuda_equals_cpu(device):
    """Phase 6: one small train_step on cuda (kernels) vs cpu (plain)."""
    import numpy as np
    import torch
    from gmeta_tpu_torch.config import Config, build_model_config
    from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
    from gmeta_tpu_torch.meta.maml import MetaLearner
    from gmeta_tpu_torch.ops import sized_spmm as sp

    store, ds = synthetic_disjoint(
        num_graphs=1, nodes_per_graph=600, avg_degree=8, feat_dim=16,
        num_classes=9, n_way=3, k_spt=3, k_qry=6, batchsz=8, h=2,
        sample_nodes=200, seed=3)
    spec = build_model_config(Config(hidden_dim=32), store.feat_dim, 3)
    batch = next(ds["train"].batches(4, shuffle=False))
    out = {}
    for dev in (device, torch.device("cpu")):
        before = dict(sp.launches)
        ml = MetaLearner(spec, 3, update_lr=0.05, meta_lr=1e-3,
                         update_step=3, update_step_test=3, seed=1,
                         agg="sized", device=dev)
        ml.set_features(store.features)
        m = ml.train_step(batch)
        out[dev.type] = (m["meta_loss"].item(), m["accs"].cpu().numpy(),
                         [p.detach().cpu().numpy() for p in ml.params],
                         {k: sp.launches[k] - before[k] for k in before})
    (lc, ac, pc, nc), (lh, ah, ph, nh) = out["cuda"], out["cpu"]
    assert all(v > 0 for v in nc.values()) and not any(nh.values()), (nc, nh)
    np.testing.assert_allclose(lc, lh, rtol=1e-5)
    np.testing.assert_allclose(ac, ah, atol=1e-6)
    # the head bias's meta-gradient is analytically zero (prototype losses
    # are shift-invariant), so Adam moves it by up to meta_lr in a direction
    # set by rounding; every other parameter must agree
    for a, b in zip(pc[:-1], ph[:-1]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    assert np.abs(pc[-1] - ph[-1]).max() <= 2e-3 * 1.001
    log(f"  meta_loss cuda {lc:.7f} cpu {lh:.7f}; kernel launches {nc}")


def step_seconds(learner, batch):
    """Wall seconds of one meta-step, ending in a device sync."""
    import torch
    torch.cuda.synchronize()
    t0 = time.time()
    learner.train_step(batch)["meta_loss"].item()
    return time.time() - t0


def dense_learner(trainer, store):
    """The trainer's learner with agg='dense' (torch.bmm over full blocks)
    and the same parameters, for an end-to-end comparison."""
    from gmeta_tpu_torch.meta.maml import MetaLearner
    cfg = trainer.cfg
    ml = MetaLearner(trainer.spec, cfg.n_way, update_lr=cfg.update_lr,
                     meta_lr=cfg.meta_lr, update_step=cfg.update_step,
                     update_step_test=cfg.update_step_test, agg="dense",
                     task_chunk=trainer.task_chunk, device=trainer.device)
    ml.set_params(trainer.learner.snapshot())
    ml.set_features(store.features)
    return ml


def profile_step(step, top=12):
    """Device time by kernel over one meta-step (`step()` returns its loss
    on the device) under torch.profiler, and the device's busy share of the
    step's wall time (profiler on, so the host side is slower than
    unprofiled). Returns None, and says so, where the profiler records no
    device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step().item()
        wall_us = (time.time() - t0) * 1e6
    kernels = {}
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        kernels[e.key] = kernels.get(e.key, 0.0) + float(us)
    busy = sum(kernels.values())
    if busy <= 0:
        log("  profiler: no device time recorded; breakdown not measured")
        return None
    log(f"  profiled meta-step: wall {wall_us / 1e3:.1f} ms, device busy "
        f"{busy / 1e3:.1f} ms ({100 * busy / wall_us:.1f}%)")
    rows = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    for k, us in rows:
        log(f"    {us / 1e3:9.2f} ms {100 * us / busy:5.1f}%  {k[:90]}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "top": [[k[:90], us / 1e3] for k, us in rows]}


def fresh_card():
    """Collect earlier fits' trainers (the spies make cycles), release the
    card's cached memory and restart its peak count."""
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def kept_metrics():
    """A MetricLogger that keeps its records and writes no file."""
    from gmeta_tpu_torch.utils.metrics import MetricLogger

    class Kept(MetricLogger):
        def __init__(self):
            super().__init__("")
            self.records = []

        def log(self, kind, **payload):
            rec = super().log(kind, **payload)
            self.records.append(rec)
            return rec

    return Kept()


class Killed(Exception):
    """Raised inside a fit to stand in for a killed process."""


# the execution modes, by the Config fields that select them
MODES = {"streaming": {},
         "compact": dict(device_task_pool=True),
         "host_window": dict(device_task_pool=True, compact_pool_hbm_gb=0.0,
                             host_pool_window=2)}


def run_mode(cfg, store, ds, mode, kill_after_windows=0):
    """One Trainer.fit in `mode` on the card, with the kernel launches it
    made. The fit's warm tasks/s is read from its own train records after
    the first (the first step or window holds the warm-up): their tasks
    over their seconds, each record's seconds being its tasks over its
    tasks_per_s, which the trainer measures as wall time ending in a sync
    (streaming, compact) or between stream-ordered events (host-windowed).
    kill_after_windows > 0 raises from the compact pool's K-step call
    after that many windows. Returns a dict of its numbers."""
    import torch
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.run.train import Trainer
    metrics = kept_metrics()
    trainer = Trainer(dataclasses.replace(cfg, **MODES[mode]), store, ds,
                      labels_num=cfg.n_way, metrics=metrics)
    hit = []
    orig_host = trainer._fit_host_pool
    trainer._fit_host_pool = lambda *a: hit.append(1) or orig_host(*a)
    if kill_after_windows:
        orig = trainer.learner.train_steps_from_compact
        calls = []

        def killing(idx_mat):
            if len(calls) == kill_after_windows:
                raise Killed()
            calls.append(1)
            return orig(idx_mat)
        trainer.learner.train_steps_from_compact = killing
    start = (trainer.start_epoch, trainer.start_batch, trainer.global_step)
    fresh_card()
    for k in sp.launches:
        sp.launches[k] = 0
    t0 = time.time()
    result = None
    try:
        result = trainer.fit()
    except Killed:
        assert kill_after_windows
    torch.cuda.synchronize()
    out = {"mode": mode, "fit_s": time.time() - t0,
           "launches": dict(sp.launches), "start": start,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "entered_host_window": bool(hit), "result": result,
           "theta": [p.detach().cpu().numpy() for p in trainer.learner.params],
           "global_step": trainer.global_step}
    assert out["launches"]["fwd"] > 0 and out["launches"]["bwd"] > 0, out
    assert out["entered_host_window"] == (mode == "host_window"), mode
    kind = "train_step" if mode == "streaming" else "train_window"
    recs = [r for r in metrics.records if r["kind"] == kind]
    for r in recs:
        assert math.isfinite(r["meta_loss"]) and r["nan_skip"] == 0, r
    out["record_tasks_per_s"] = [r["tasks_per_s"] for r in recs]
    if len(recs) >= 2:
        tasks = [(b["step"] - a["step"]) * cfg.task_num
                 for a, b in zip(recs, recs[1:])]
        seconds = [n / r["tasks_per_s"] for n, r in zip(tasks, recs[1:])]
        out["tasks_per_s"] = sum(tasks) / sum(seconds)
    out["data_s"] = [r["data_s"] for r in recs if "data_s" in r]
    pool = [r for r in metrics.records if r["kind"] == "task_pool"]
    if pool:
        out["pool"] = {k: pool[0][k] for k in ("mode", "compact_bytes",
                                               "build_s")}
        if mode == "compact" and trainer.learner._cpool is not None:
            out["pool"]["device_bytes"] = \
                trainer.learner.compact_pool_device_bytes()
    return out


def max_rel(a, b, skip_last=False):
    """(max abs difference, max relative difference) over two thetas;
    skip_last leaves out the head bias for the relative one."""
    import numpy as np
    abs_d = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    pairs = list(zip(a, b))[:-1] if skip_last else list(zip(a, b))
    rel = max(float((np.abs(x - y) / np.maximum(np.abs(y), 1e-30)).max())
              for x, y in pairs)
    return abs_d, rel


def assert_theta_close(a, b, rtol, steps, meta_lr, what):
    """Every parameter within rtol (atol rtol * 1e-2); the head bias, whose
    meta-gradient is analytically zero so Adam moves it by up to meta_lr
    per step in a direction set by rounding, within 2 * steps * meta_lr."""
    import numpy as np
    for i, (x, y) in enumerate(zip(a, b)):
        if i == len(a) - 1:
            assert np.abs(x - y).max() <= 2 * steps * meta_lr * 1.001, what
        else:
            np.testing.assert_allclose(x, y, rtol=rtol, atol=rtol * 1e-2,
                                       err_msg=f"{what}: param {i}")


def fit_modes(cfg, store, ds):
    """Phase 8: the three execution modes in turns, then a compact kill and
    mid-epoch resume. Returns (summary for the JSON line, launches summed
    over every fit)."""
    import numpy as np
    order = ["streaming", "compact", "host_window",
             "host_window", "compact", "streaming"]
    runs = {m: [] for m in MODES}
    launches = {"fwd": 0, "bwd": 0}
    for mode in order:
        r = run_mode(cfg, store, ds, mode)
        runs[mode].append(r)
        for k in launches:
            launches[k] += r["launches"][k]
        log(f"  {mode}: fit {r['fit_s']:.1f} s, warm "
            f"{r.get('tasks_per_s', float('nan')):.2f} tasks/s, peak "
            f"{r['peak_gb']:.2f} GB, launches {r['launches']}"
            + (f", data_s {[round(x, 3) for x in r['data_s']]}"
               if r["data_s"] else "")
            + (f", pool {r['pool']}" if "pool" in r else ""))
    steps = runs["streaming"][0]["global_step"]
    assert steps == len(ds["train"]) // cfg.task_num
    for r in (r for rs in runs.values() for r in rs):
        assert r["global_step"] == steps and r["result"] is not None, r
    compact, host, stream = (runs[m][0]["theta"] for m in
                             ("compact", "host_window", "streaming"))
    diffs = {
        "compact_vs_host_window": max_rel(host, compact),
        "compact_vs_streaming": max_rel(compact, stream, skip_last=True),
        "host_window_vs_streaming": max_rel(host, stream, skip_last=True),
        "repeat": {m: max_rel(runs[m][1]["theta"], runs[m][0]["theta"])[0]
                   for m in MODES}}
    log(f"  theta differences (max abs, max rel): {diffs}")
    if diffs["compact_vs_host_window"][0] != 0.0:
        assert_theta_close(host, compact, 1e-6, steps, cfg.meta_lr,
                           "host_window vs compact")
    for pool_theta, m in ((compact, "compact"), (host, "host_window")):
        assert_theta_close(pool_theta, stream, 1e-5, steps, cfg.meta_lr,
                           f"{m} vs streaming")

    ck = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    window = 2
    ck_cfg = dataclasses.replace(cfg, checkpoint_dir=str(ck),
                                 checkpoint_every_steps=window)
    killed = run_mode(ck_cfg, store, ds, "compact", kill_after_windows=1)
    assert killed["result"] is None and killed["global_step"] == window
    resumed = run_mode(ck_cfg, store, ds, "compact")
    assert resumed["start"] == (0, window, window), resumed["start"]
    assert resumed["global_step"] == steps
    assert_theta_close(resumed["theta"], compact, 1e-5, steps, cfg.meta_lr,
                       "resumed vs straight compact")
    resume_diff = max_rel(resumed["theta"], compact)
    log(f"  kill after window 1 and resume at epoch 0 batch {window}: "
        f"theta vs the straight compact fit (max abs, max rel) "
        f"{resume_diff}; resumed fit launches {resumed['launches']}")
    for r in (killed, resumed):
        for k in launches:
            launches[k] += r["launches"][k]
    shutil.rmtree(ck, ignore_errors=True)

    summary = {"order": order, "steps": steps, "theta_diff": diffs,
               "resume": {"theta_diff": resume_diff,
                          "start": resumed["start"],
                          "fit_s": resumed["fit_s"]}}
    for m, rs in runs.items():
        summary[m] = {k: [r.get(k) for r in rs] for k in
                      ("tasks_per_s", "record_tasks_per_s", "peak_gb",
                       "fit_s", "data_s", "launches")}
        if "pool" in rs[0]:
            summary[m]["pool"] = [r["pool"] for r in rs]
        summary[m]["tasks_per_s_mean"] = statistics.mean(
            r["tasks_per_s"] for r in rs)
    return summary, launches


# ---- phase 9: the CLI from disk: prepare, extract, remat -------------------

DATA_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_data"


def prepare_arxiv_dir(store, ds, seed=7):
    """9a: phase 4's graph, features and labels written by the port's
    prepare_node_disjoint. Returns (directory, seconds)."""
    import numpy as np
    from gmeta_tpu_torch.data.prepare import prepare_node_disjoint
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    labels = ds["train"].labels
    V = store.graphs[0].num_nodes
    y = np.array([labels[f"0_{n}"] for n in range(V)], np.int64)
    t0 = time.time()
    prepare_node_disjoint(str(DATA_DIR), store.graphs, [store.features],
                          [y], num_label_set=3, seed=seed)
    return DATA_DIR, time.time() - t0


def assert_same_datasets(a, b):
    """Bitwise-equal episodes (names, relabelled classes, subgraphs) and
    packed pools of every split."""
    import numpy as np
    for split in ("train", "val", "test"):
        x, y = a[split], b[split]
        assert x.sampler.support_x_batch == y.sampler.support_x_batch
        assert x.sampler.query_x_batch == y.sampler.query_x_batch
        for s, t in zip(x.tasks, y.tasks):
            for f in ("spt_labels", "qry_labels"):
                np.testing.assert_array_equal(getattr(s, f), getattr(t, f))
            for u, v in zip(s.spt_subs + s.qry_subs, t.spt_subs + t.qry_subs):
                for f in ("parents", "centers", "edge_src", "edge_dst"):
                    assert np.array_equal(getattr(u, f), getattr(v, f)), f
        px, py = x.stacked_pool(), y.stacked_pool()
        for u, v in zip(px.spt + px.qry, py.spt + py.qry):
            assert (u is None and v is None) or np.array_equal(u, v)


def build_three_ways(cfg):
    """9b: build_datasets with the numpy extractor, the native one cold
    (writing the cache) and the native one from the cache, then each
    engine's own rate over the names it extracted. Returns (the native
    datasets, summary)."""
    import numpy as np
    from gmeta_tpu_torch.data import extract_cache, native
    from gmeta_tpu_torch.data.extract import SubgraphExtractor
    from gmeta_tpu_torch.run.train import build_datasets
    cache = extract_cache.cache_path(str(DATA_DIR), cfg.h, cfg.sample_nodes,
                                     cfg.cap_strategy)
    assert not os.path.exists(cache)
    out, built = {}, {}
    for what, extractor in (("numpy", "numpy"), ("native_cold", "native"),
                            ("native_cached", "native")):
        gc.collect()
        t0 = time.time()
        store, ds, _ = build_datasets(dataclasses.replace(
            cfg, extractor=extractor))
        seconds = time.time() - t0
        ex = ds["train"].extractor
        assert isinstance(ex, native.NativeSubgraphExtractor) == (
            extractor == "native")
        built[what] = (store, ds)
        out[what] = {"build_s": seconds, "subgraphs": len(ex.cache),
                     "extractions_per_s_build": len(ex.cache) / seconds}
        log(f"  build_datasets {what}: {seconds:.2f} s, {len(ex.cache)} "
            f"subgraphs")
    assert os.path.exists(cache)
    out["cache_bytes"] = os.path.getsize(cache)
    store, ds = built["native_cold"]
    assert_same_datasets(ds, built["native_cached"][1])
    # the engines alone, on the names this split set needed
    names = sorted(ds["train"].extractor.cache)
    t0 = time.time()
    fresh = native.NativeSubgraphExtractor(
        store.graphs, h=cfg.h, sample_nodes=cfg.sample_nodes, seed=cfg.seed)
    fresh.extract_many(names)
    native_s = time.time() - t0
    sub = names[:1000]
    oracle = SubgraphExtractor(store.graphs, h=cfg.h,
                               sample_nodes=cfg.sample_nodes, seed=cfg.seed)
    t0 = time.time()
    for n in sub:
        oracle.extract(n)
    numpy_s = time.time() - t0
    capped = sum(ds["train"].extractor.cache[n].num_nodes
                 >= cfg.sample_nodes for n in names)
    same_uncapped = all(
        np.array_equal(oracle.cache[n].parents, fresh.cache[n].parents)
        and np.array_equal(oracle.cache[n].edge_src, fresh.cache[n].edge_src)
        for n in sub if fresh.cache[n].num_nodes < cfg.sample_nodes)
    assert same_uncapped
    out.update(
        names=len(names), capped=capped, host_cpus=os.cpu_count(),
        native_threads=fresh.engine.n_threads,
        native_extractions_per_s=len(names) / native_s,
        numpy_extractions_per_s=len(sub) / numpy_s)
    log(f"  engines alone: native {out['native_extractions_per_s']:.0f} "
        f"extractions/s ({len(names)} names, {fresh.engine.n_threads} "
        f"threads on {os.cpu_count()} host CPUs), numpy "
        f"{out['numpy_extractions_per_s']:.1f}/s ({len(sub)} names); "
        f"{capped} of {len(names)} subgraphs capped; cache "
        f"{out['cache_bytes']} bytes")
    return store, ds, out


def device_extract_check(store, ds, cfg, device):
    """9c: the device extractor over the first train batch's centers,
    every uncapped center bit-equal to the native engine, at several
    centers per pass."""
    import numpy as np
    import torch
    from gmeta_tpu_torch.data.device_extract import DeviceExtractor
    tr = ds["train"]
    names = sorted({n for i in range(cfg.task_num)
                    for group in (tr.sampler.support_x_batch[i],
                                  tr.sampler.query_x_batch[i])
                    for sub in group for n in sub})
    centers = np.array([int(n.split("_")[1]) for n in names])
    native_cache = tr.extractor.cache
    runs = {}
    for chunk in (64, 256, 1024):
        dx = DeviceExtractor(store.graphs[0], h=cfg.h,
                             sample_nodes=cfg.sample_nodes, device=device,
                             seed=cfg.seed, chunk=chunk)
        dx.extract_arrays(centers[:chunk])            # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        arrays = dx.extract_arrays(centers)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        runs[chunk] = {"s": seconds, "extractions_per_s":
                       len(centers) / seconds,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"  device extractor, {chunk} centers per pass: {seconds:.3f} s "
            f"for {len(centers)} centers "
            f"({runs[chunk]['extractions_per_s']:.0f}/s), peak "
            f"{runs[chunk]['peak_gb']:.2f} GB")
    a = {f: x.cpu().numpy() for f, x in zip(arrays._fields, arrays)}
    assert not a["overflow"].any()
    uncapped = np.flatnonzero(a["n_full"] <= cfg.sample_nodes)
    for k in uncapped:
        ref = native_cache[names[k]]
        n, e = int(a["n_nodes"][k]), int(a["n_edges"][k])
        assert np.array_equal(a["parents"][k, :n], ref.parents), names[k]
        assert np.array_equal(a["centers_local"][k], ref.centers)
        assert np.array_equal(a["edge_src"][k, :e], ref.edge_src)
        assert np.array_equal(a["edge_dst"][k, :e], ref.edge_dst)
    log(f"  {len(uncapped)} of {len(centers)} centers uncapped, each "
        f"bit-equal to the native engine")
    del arrays, dx
    torch.cuda.empty_cache()
    return {"centers": len(centers), "uncapped": len(uncapped),
            "by_chunk": runs}


def spy_main(argv):
    """train.main(argv) and the trainer it built (Trainer, or
    EdgePartTrainer under --mesh_edges)."""
    from gmeta_tpu_torch.run import edgepart, train as train_mod
    seen = []
    originals = (train_mod.Trainer, edgepart.EdgePartTrainer)

    def spy(cls):
        class Seen(cls):
            def fit(self):
                seen.append(self)
                return super().fit()
        return Seen
    train_mod.Trainer = spy(originals[0])
    edgepart.EdgePartTrainer = spy(originals[1])
    try:
        result = train_mod.main(argv)
    finally:
        train_mod.Trainer, edgepart.EdgePartTrainer = originals
    trainer, = seen
    return result, trainer


def zero_counts():
    """Every kernel launch count (both entry points) and the collectives'
    seconds and calls, set to 0."""
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.parallel import collectives
    for counts in (sp.launches, sp.csr_launches, collectives.seconds,
                   collectives.calls):
        for k in counts:
            counts[k] = 0


def cli_fit(remat, metrics_path, device, extra=()):
    """9d: one main() run from the prepared directory on the card, with the
    Trainer it built. Returns its numbers. `extra` adds flags (phase 10a:
    --mesh_tasks 1)."""
    import torch
    from gmeta_tpu_torch.ops import sized_spmm as sp
    argv = ["--preset", "arxiv", "--data_dir", str(DATA_DIR), "--agg",
            "sized", "--extractor", "native", "--batchsz", "192",
            "--eval_batchsz", "48", "--epoch", "1", "--dtype", "float32",
            "--train_result_report_steps", "1", "--remat_inner",
            str(remat), "--metrics_path", str(metrics_path), *extra]
    if metrics_path.exists():
        metrics_path.unlink()
    fresh_card()
    zero_counts()
    t0 = time.time()
    result, trainer = spy_main(argv)
    torch.cuda.synchronize()
    out = {"remat": remat, "main_s": time.time() - t0,
           "launches": dict(sp.launches),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "result": dataclasses.asdict(result)}
    assert trainer.device.type == device.type and trainer.agg == "sized"
    assert trainer.cfg.remat_inner == remat
    assert not any(sp.csr_launches.values()), sp.csr_launches
    out["theta"] = [p.detach().cpu().numpy() for p in trainer.learner.params]
    recs = [json.loads(line) for line in open(metrics_path)]
    steps = [r for r in recs if r["kind"] == "train_step"]
    assert len(steps) == 6 and result.global_step == 6, steps
    for r in steps:
        assert math.isfinite(r["meta_loss"]) and r["nan_skip"] == 0, r
    out["tasks_per_s"] = [r["tasks_per_s"] for r in steps]
    out["warm_tasks_per_s"] = 5 * trainer.cfg.task_num / sum(
        trainer.cfg.task_num / r["tasks_per_s"] for r in steps[1:])
    assert out["launches"]["fwd"] > 0 and out["launches"]["bwd"] > 0, out
    log(f"  main remat_inner={remat}{' ' + ' '.join(extra) if extra else ''}"
        f": {out['main_s']:.1f} s, warm {out['warm_tasks_per_s']:.2f} "
        f"tasks/s, peak {out['peak_gb']:.2f} GB, launches {out['launches']}")
    del trainer
    return out


def second_order_steps(store, ds, cfg, device, chunk=8):
    """9e: isolated meta-steps at arxiv width with first_order=False and
    task_vmap_chunk `chunk`, remat on and off in turns."""
    import torch
    from gmeta_tpu_torch.config import build_model_config
    from gmeta_tpu_torch.meta.maml import MetaLearner
    from gmeta_tpu_torch.ops import sized_spmm as sp
    spec = build_model_config(cfg, store.feat_dim, cfg.n_way)
    batch = next(ds["train"].batches(cfg.task_num, shuffle=False))
    runs = {True: [], False: []}
    launches = {"fwd": 0, "bwd": 0}
    thetas = {}
    for remat in (True, False, False, True):
        ml = MetaLearner(spec, cfg.n_way, update_lr=cfg.update_lr,
                         meta_lr=cfg.meta_lr, update_step=cfg.update_step,
                         update_step_test=cfg.update_step_test,
                         first_order=False, remat=remat, seed=cfg.seed,
                         agg="sized", task_chunk=chunk, device=device)
        ml.set_features(store.features)
        fresh_card()
        before = dict(sp.launches)
        seconds = step_seconds(ml, batch)
        for k in launches:
            launches[k] += sp.launches[k] - before[k]
        runs[remat].append({"s": seconds, "peak_gb":
                            torch.cuda.max_memory_allocated() / 1e9})
        thetas.setdefault(remat, [p.detach().cpu().numpy()
                                  for p in ml.params])
        del ml
    diff = max_rel(thetas[True], thetas[False], skip_last=True)
    assert_theta_close(thetas[True], thetas[False], 1e-6, 1, cfg.meta_lr,
                       "second-order remat vs plain")
    log(f"  second-order meta-step, {cfg.task_num} tasks in chunks of "
        f"{chunk}: remat {[round(r['s'], 3) for r in runs[True]]} s, peak "
        f"{[round(r['peak_gb'], 2) for r in runs[True]]} GB; plain "
        f"{[round(r['s'], 3) for r in runs[False]]} s, peak "
        f"{[round(r['peak_gb'], 2) for r in runs[False]]} GB; theta diff "
        f"{diff}")
    return {"chunk": chunk, "remat": runs[True], "plain": runs[False],
            "theta_diff": diff}, launches


def cli_phase(store4, ds4, device):
    """Phase 9. Returns (summary, launches summed over its fits and steps,
    the first plain fit). The prepared directory stays for phase 10."""
    import numpy as np
    from gmeta_tpu_torch.config import PRESETS
    t0 = time.time()
    data_dir, prep_s = prepare_arxiv_dir(store4, ds4)
    size = sum(f.stat().st_size for f in data_dir.rglob("*") if f.is_file())
    log(f"  9a prepare_node_disjoint: {prep_s:.1f} s, {size} bytes under "
        f"{data_dir.name}/")
    cfg = dataclasses.replace(PRESETS["arxiv"], data_dir=str(data_dir),
                              agg="sized", batchsz=192, eval_batchsz=48,
                              epoch=1, dtype="float32")
    store, ds, builds = build_three_ways(cfg)
    extract = device_extract_check(store, ds, cfg, device)
    fits = {True: [], False: []}
    launches = {"fwd": 0, "bwd": 0}
    for i, remat in enumerate((True, False, False, True)):
        r = cli_fit(remat, data_dir / f"metrics_{i}.jsonl", device)
        fits[remat].append(r)
        for k in launches:
            launches[k] += r["launches"][k]
    a, b = fits[True][0]["theta"], fits[False][0]["theta"]
    steps = 6
    if any(not np.array_equal(x, y) for x, y in zip(a, b)):
        assert_theta_close(a, b, 1e-6, steps, cfg.meta_lr,
                           "remat vs plain fit")
    fit_diff = max_rel(a, b)
    for rs in fits.values():
        assert max_rel(rs[0]["theta"], rs[1]["theta"])[0] == 0.0
    log(f"  theta remat vs plain (max abs, max rel): {fit_diff}")
    second, second_launches = second_order_steps(store, ds, cfg, device)
    for k in launches:
        launches[k] += second_launches[k]
    summary = {"prepare_s": prep_s, "data_bytes": size, "builds": builds,
               "device_extract": extract, "fit_theta_diff": fit_diff,
               "second_order": second, "phase_s": time.time() - t0}
    for remat, rs in fits.items():
        summary[f"fit_remat_{remat}"] = {
            k: [r[k] for r in rs] for k in
            ("main_s", "warm_tasks_per_s", "tasks_per_s", "peak_gb",
             "launches")}
    return summary, launches, fits[False][0]


# ---- phase 10: the mesh: task-DP and the edge-partitioned engine ----------

EDGE_FLAGS = ["--preset", "arxiv", "--data_dir", str(DATA_DIR),
              "--epoch", "1", "--train_result_report_steps", "1"]
# (b): the arxiv preset's widths and depth, the tasks cut
EDGE_FULL = EDGE_FLAGS + ["--batchsz", "96", "--eval_batchsz", "32"]
# (c): the same widths, the depth cut
EDGE_CUT = EDGE_FLAGS + ["--batchsz", "8", "--eval_batchsz", "4",
                         "--task_num", "4", "--update_step", "2",
                         "--update_step_test", "2"]
SHARED_CARD = ["--dist_backend", "gloo", "--device", "cuda:0"]


def edge_fit(argv, metrics_path, device):
    """One main() of the edge-partitioned engine in this process (a world
    of one, NCCL on the card), with its launch counts set to 0 before it.
    Returns (its numbers, the trainer)."""
    import torch
    from gmeta_tpu_torch.ops import sized_spmm as sp
    if metrics_path.exists():
        metrics_path.unlink()
    fresh_card()
    zero_counts()
    t0 = time.time()
    result, trainer = spy_main(argv + ["--mesh_edges", "1", "--metrics_path",
                                       str(metrics_path)])
    torch.cuda.synchronize()
    out = {"main_s": time.time() - t0, "csr_launches": dict(sp.csr_launches),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "result": dataclasses.asdict(result), "comm": trainer.comm,
           "theta": [p.detach().cpu().numpy() for p in trainer.engine.params]}
    assert trainer.engine.device.type == device.type
    assert not any(sp.launches.values()), sp.launches
    assert all(v > 0 for v in out["csr_launches"].values()), out
    recs = [json.loads(line) for line in open(metrics_path)]
    steps = [r for r in recs if r["kind"] == "train_step"]
    task_num = trainer.cfg.task_num
    assert len(steps) == result.global_step > 0, steps
    for r in steps:
        assert math.isfinite(r["meta_loss"]) and r["nan_skip"] == 0, r
    out["step_s"] = [task_num / r["tasks_per_s"] for r in steps]
    if len(steps) > 1:
        out["warm_tasks_per_s"] = (len(steps) - 1) * task_num / sum(
            out["step_s"][1:])
    for f in ("test_acc_final", "best_test_acc", "val_max_acc"):
        assert 0.0 <= getattr(result, f) <= 1.0, result
    return out, trainer


def time_rect(pair, device):
    """The rectangular entry point at the full-graph shape: the edge
    engine's CSR pair (both directions), H = 128 and 256, float32: kernel,
    plain version and torch.sparse.mm of the same CSR, medians of CUDA-event
    times, beside the least time the card could take for this data (the
    table rows the edges name and the int32 indices read once, the output
    written once; or 2 x nnz x H operations)."""
    import torch
    from gmeta_tpu_torch.ops import sized_spmm as sp
    rows = {}
    g = torch.Generator(device=device).manual_seed(1)
    n_dst, n_src = pair.row_ptr.numel() - 1, pair.row_ptr_t.numel() - 1
    nnz = pair.col.numel()
    for count, (row_ptr, col), n_out, n_in in (
            ("fwd", (pair.row_ptr, pair.col), n_dst, n_src),
            ("bwd", (pair.row_ptr_t, pair.col_t), n_src, n_dst)):
        read_rows = torch.unique(col).numel()
        sparse = torch.sparse_csr_tensor(
            row_ptr, col, torch.ones(nnz, device=device),
            size=(n_out, n_in), check_invariants=False)
        for H in (128, 256):
            x = torch.randn(n_in, H, device=device, generator=g)
            got = sp.csr_gather(row_ptr, col, x, count)
            want = sp.csr_plain(row_ptr, col, x)
            rtol, atol = TOLS["float32"]
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            torch.testing.assert_close(torch.sparse.mm(sparse, x), want,
                                       rtol=rtol, atol=atol)
            e = (got - want).abs().max().item()
            del got, want
            row = rows[(count, H)] = dict(timed_row(
                lambda: sp.csr_gather(row_ptr, col, x, count),
                lambda: sp.csr_plain(row_ptr, col, x),
                lambda: torch.sparse.mm(sparse, x),
                nnz, H, read_rows, n_out), max_abs_err=e)
            # the rows the kernel gathers, each edge's once
            row["edge_gb_per_s"] = 4.0 * nnz * H / (row["ms"] * 1e-3) / 1e9
            log(f"  csr_gather {count} H={H}: kernel {row['ms']:.3f} ms "
                f"({100 * row['bound_ms'] / row['ms']:.1f}% of the bound; "
                f"rows gathered at {row['edge_gb_per_s']:.0f} GB/s), plain "
                f"{row['plain_ms']:.3f} ms, torch.sparse.mm "
                f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}), max abs err {e:.3g}")
            del x
        del sparse
    torch.cuda.empty_cache()
    return rows, f"V={n_dst} nnz={nnz}"


def rank_main(out_path, argv):
    """One rank of phase 10(c), started by spawn_ranks: main(argv) with the
    counts set to 0 before it. Writes this rank's theta, kernel launch
    counts, collective seconds and, for the edge engine, its communication
    plan to out_path (npz)."""
    import numpy as np
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.parallel import collectives
    zero_counts()
    t0 = time.time()
    result, trainer = spy_main(argv)
    engine = getattr(trainer, "engine", None)
    params = engine.params if engine is not None else trainer.learner.params
    meta = {"rank": int(os.environ["RANK"]), "main_s": time.time() - t0,
            "launches": dict(sp.launches),
            "csr_launches": dict(sp.csr_launches),
            "seconds": dict(collectives.seconds),
            "calls": dict(collectives.calls),
            "global_step": result.global_step,
            "comm": getattr(trainer, "comm", None)}
    np.savez(out_path, meta=json.dumps(meta),
             **{f"theta{i}": p.detach().cpu().numpy()
                for i, p in enumerate(params)})


def spawn_fit(argv, nprocs, tag):
    """Phase 10(c): main(argv) as `nprocs` ranks sharing this card over
    gloo, each in its own process. Returns each rank's (meta, theta) and
    the wall seconds."""
    import numpy as np
    from gmeta_tpu_torch.parallel.launch import spawn_ranks
    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "chip_smoke_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="2")
    fresh_card()
    t0 = time.time()
    spawn_ranks([sys.executable, str(root / "chip_smoke.py"), "--rank",
                 str(out_dir / f"{tag}_rank"), *argv], nprocs, timeout=420,
                env=env, cwd=str(root))
    wall = time.time() - t0
    ranks = []
    for r in range(nprocs):
        z = np.load(out_dir / f"{tag}_rank_{r}.npz")
        n = sum(1 for k in z.files if k.startswith("theta"))
        ranks.append((json.loads(str(z["meta"])),
                      [z[f"theta{i}"] for i in range(n)]))
    shutil.rmtree(out_dir, ignore_errors=True)
    for meta, theta in ranks:            # one theta on every rank
        for a, b in zip(theta, ranks[0][1]):
            assert np.array_equal(a, b), meta["rank"]
    return ranks, wall


CKPT10 = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt10"


def every_step(ckpt_dir):
    """Flags that checkpoint theta after every meta-step into ckpt_dir."""
    return ["--checkpoint_dir", str(ckpt_dir), "--checkpoint_every_steps",
            "1"]


def compare_steps(got_dir, want_dir, meta_lr, what, grad_atol=1e-5):
    """Two checkpointed fits (rank 0's files for a mesh), step by step. The
    first step's gradient (Adam's first moment after it, 0.1 x the
    gradient) must equal the reference's at rtol 1e-5, atol `grad_atol` of
    its largest entry: the same reduction, summed in another order. theta
    cannot be held that tight: Adam scales every entry's update to about
    meta_lr, so an entry whose gradient is near Adam's eps (1e-8), or
    thousands of times below the largest entry, turns a summation-order
    error into an update error of a fraction of meta_lr, which the next
    steps carry on. theta after each step is held within
    2 x step x meta_lr, Adam's own bound on how far two runs can move an
    entry apart (the bound the head bias is held to everywhere). Returns
    the step-1 gradient's largest difference over its largest entry, and
    per step theta's (max abs, max rel without the head bias)."""
    import numpy as np
    from gmeta_tpu_torch.utils import checkpoint as ckpt

    def by_step(d):
        out = {}
        for f in sorted(Path(d).glob("ckpt_*.pkl")):
            state = ckpt.restore(str(f))
            out[int(f.stem.split("_")[1])] = (
                [np.asarray(x) for x in state["params"]],
                [np.asarray(x) for x in state["opt_state"]["mu"]])
        return out
    got, want = by_step(got_dir), by_step(want_dir)
    assert sorted(got) == sorted(want) and 1 in got, (sorted(got),
                                                       sorted(want))
    scale = max(float(np.abs(m).max()) for m in want[1][1])
    for i, (x, y) in enumerate(zip(got[1][1], want[1][1])):
        np.testing.assert_allclose(
            x, y, rtol=1e-5, atol=grad_atol * scale,
            err_msg=f"{what}: the first step's gradient of param {i}")
    for step in sorted(got):
        for x, y in zip(got[step][0], want[step][0]):
            assert np.abs(x - y).max() <= 2 * step * meta_lr * 1.001, (
                what, step)
    return {"grad_step1": max(float(np.abs(x - y).max())
                              for x, y in zip(got[1][1], want[1][1])) / scale,
            "theta_by_step": [max_rel(got[k][0], want[k][0], skip_last=True)
                              for k in sorted(got)]}


def mesh_phase(device, plain9):
    """Phase 10. Returns (summary, packed launches, rectangular launches,
    the rectangular entry point's timing)."""
    import torch
    from gmeta_tpu_torch.parallel.edgepart_train import EdgePartTask
    t0 = time.time()
    packed = {"fwd": 0, "bwd": 0}
    rect = {"fwd": 0, "bwd": 0}

    shutil.rmtree(CKPT10, ignore_errors=True)

    # (a) task-DP on a world of one (NCCL, in this process) = phase 9's fit;
    # theta after every step is kept for (c)
    a = cli_fit(False, DATA_DIR / "metrics_10a.jsonl", device,
                extra=["--mesh_tasks", "1"] + every_step(CKPT10 / "a"))
    for k in packed:
        packed[k] += a["launches"][k]
    a_diff = max_rel(a["theta"], plain9["theta"])
    if a_diff[0] != 0.0:
        assert_theta_close(a["theta"], plain9["theta"], 1e-6, 6, 1e-3,
                           "10a vs phase 9")
    log(f"  (a) --mesh_tasks 1: warm {a['warm_tasks_per_s']:.2f} tasks/s "
        f"against phase 9's {plain9['warm_tasks_per_s']:.2f}; theta vs "
        f"phase 9 (max abs, max rel) {a_diff}")

    # (b) the edge-partitioned engine at full width on a world of one
    b, trainer = edge_fit(EDGE_FULL, DATA_DIR / "metrics_10b.jsonl", device)
    for k in rect:
        rect[k] += b["csr_launches"][k]
    log(f"  (b) --mesh_edges 1, arxiv widths: {b['main_s']:.1f} s, steps "
        f"{[round(x, 3) for x in b['step_s']]} s, warm "
        f"{b.get('warm_tasks_per_s', float('nan')):.2f} tasks/s, peak "
        f"{b['peak_gb']:.2f} GB, csr_gather launches {b['csr_launches']}, "
        f"comm {b['comm']}")
    train = trainer.tasks["train"]
    first = EdgePartTask(*(a[:trainer.cfg.task_num] for a in train))
    b["profile"] = profile_step(
        lambda: trainer.engine.train_step(first)["meta_loss"])
    timing, shape = time_rect(trainer.engine._shard.local, device)
    del trainer
    fresh_card()

    # (c) several ranks on this one card over gloo, each its own process
    packed_argv = ["--preset", "arxiv", "--data_dir", str(DATA_DIR),
                   "--agg", "sized", "--extractor", "native", "--batchsz",
                   "192", "--eval_batchsz", "48", "--epoch", "1", "--dtype",
                   "float32", "--update_step_test", "2", "--metrics_path",
                   str(DATA_DIR / "metrics_10c.jsonl"), "--mesh_tasks", "4",
                   *SHARED_CARD, *every_step(CKPT10 / "c")]
    ranks, wall = spawn_fit(packed_argv, 4, "tasks")
    for meta, _ in ranks:
        assert meta["global_step"] == 6, meta
        assert all(v > 0 for v in meta["launches"].values()), meta
        for k in packed:
            packed[k] += meta["launches"][k]
    c_steps = compare_steps(CKPT10 / "c", CKPT10 / "a", 1e-3,
                            "10c task-DP vs 10a")
    log(f"  (c) --mesh_tasks 4, 4 gloo ranks: {wall:.1f} s; vs (a): {c_steps}"
        f"; launches by rank "
        f"{[m['launches'] for m, _ in ranks]}; all-reduce s by rank "
        f"{[round(m['seconds']['all_reduce'], 3) for m, _ in ranks]}")
    c_tasks = {"wall_s": wall, "vs_a": c_steps,
               "ranks": [m for m, _ in ranks]}

    one, _ = edge_fit(EDGE_CUT + every_step(CKPT10 / "e1"),
                      DATA_DIR / "metrics_10c1.jsonl", device)
    for k in rect:
        rect[k] += one["csr_launches"][k]
    ranks, wall = spawn_fit(EDGE_CUT + [
        "--mesh_tasks", "2", "--mesh_edges", "2", "--metrics_path",
        str(DATA_DIR / "metrics_10c2.jsonl"), *SHARED_CARD,
        *every_step(CKPT10 / "e4")], 4, "edges")
    for meta, _ in ranks:
        assert meta["global_step"] == one["result"]["global_step"], meta
        assert all(v > 0 for v in meta["csr_launches"].values()), meta
        assert not any(meta["launches"].values()), meta
        for k in rect:
            rect[k] += meta["csr_launches"][k]
    # splitting the graph changes more than the order of a sum: each row
    # aggregates its local and remote edges apart, and the inner steps
    # carry that on, so the JAX engine's own (2, 2) and (1, 1) steps part
    # by more than a task split does; a wrong gradient rule (a factor of
    # D, a shard's share lost) moves the gradient by a fraction of its
    # largest entry, far beyond 1e-3 of it
    e_steps = compare_steps(CKPT10 / "e4", CKPT10 / "e1", 1e-3,
                            "10c (2, 2) vs world 1", grad_atol=1e-3)
    shutil.rmtree(CKPT10, ignore_errors=True)
    comm = ranks[0][0]["comm"]
    log(f"  (c) --mesh_tasks 2 --mesh_edges 2, 4 gloo ranks: {wall:.1f} s "
        f"(world 1: {one['main_s']:.1f} s); vs world 1: {e_steps}; comm "
        f"{comm}; halo all-to-all s by rank "
        f"{[round(m['seconds']['all_to_all'], 3) for m, _ in ranks]} over "
        f"{ranks[0][0]['calls']['all_to_all']} exchanges each, all-reduce s "
        f"{[round(m['seconds']['all_reduce'], 3) for m, _ in ranks]} over "
        f"{ranks[0][0]['calls']['all_reduce']}"
        f"; csr_gather launches by rank "
        f"{[m['csr_launches'] for m, _ in ranks]}")
    summary = {
        "a": {k: a[k] for k in ("main_s", "warm_tasks_per_s", "tasks_per_s",
                                "peak_gb", "launches")},
        "a_theta_diff": a_diff,
        "phase9_warm_tasks_per_s": plain9["warm_tasks_per_s"],
        "b": {k: b[k] for k in b if k != "theta"},
        "c_tasks": c_tasks,
        "c_edges": {"wall_s": wall, "vs_world1": e_steps,
                    "world1_s": one["main_s"],
                    "ranks": [m for m, _ in ranks]},
        "phase_s": time.time() - t0}
    torch.cuda.empty_cache()
    return summary, packed, rect, (timing, shape)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: "
                         "this script needs an NVIDIA GPU")
    try:
        from gmeta_tpu_torch.config import PRESETS
        from gmeta_tpu_torch.ops import cuda_build
        from gmeta_tpu_torch.ops import sized_spmm as sp
        from gmeta_tpu_torch.run.train import Trainer
        from gmeta_tpu_torch.utils.device import resolve_device
    except ImportError as e:
        raise SystemExit(f"chip_smoke: the gmeta_tpu_torch package is not "
                         f"beside this script ({e})")
    t = phase("1 device")
    device = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"  {name}; nvidia-smi: {card}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    resolve_device(device)          # TF32 off, as on the port's paths

    t = phase("2 build")

    def timed(fn, name):
        t0 = time.time()
        return fn(name), time.time() - t0
    with ThreadPoolExecutor(2) as pool:      # nvcc and g++ at once
        cu = pool.submit(timed, cuda_build.build, "sized_spmm")
        cpp = pool.submit(timed, cuda_build.build_host, "extract")
        (path, cu_s), (host_path, cpp_s) = cu.result(), cpp.result()
    build_s = time.time() - t
    log(f"  sized_spmm.cu -> {path.name} in {cu_s:.1f} s; extract.cpp -> "
        f"{host_path.name} in {cpp_s:.1f} s; both {build_s:.1f} s")
    log("  " + path.with_suffix(".ptxas.txt").read_text()
        .strip().replace("\n", "\n  "))

    t = phase("3 kernel checks")
    errs = check_kernels(device)
    log(f"  {time.time() - t:.1f} s")

    t = phase("4 data: arxiv-scale synthetic graph")
    store, ds = arxiv_data()
    tr_ds = ds["train"]
    buckets = dict(P_spt=tr_ds.P_spt, B_spt=tr_ds.B_spt, E_spt=tr_ds.E_spt,
                   P_qry=tr_ds.P_qry, B_qry=tr_ds.B_qry, E_qry=tr_ds.E_qry)
    log(f"  {time.time() - t:.1f} s; buckets {buckets}; mean bin fill "
        f"{tr_ds.mean_bin_fill:.4f}; mean edges/task "
        f"{tr_ds.mean_edges_per_task:.1f}")

    cfg = dataclasses.replace(PRESETS["arxiv"], agg="sized", batchsz=192,
                              eval_batchsz=48, epoch=1, dtype="float32",
                              train_result_report_steps=1)
    n_eval = len(ds["test"])
    task_num = cfg.task_num

    t = phase("5 kernel timing at the arxiv query shape")
    batch = next(tr_ds.batches(task_num, shuffle=False))
    timing, qry_shape = time_kernels(batch, device)
    log(f"  {time.time() - t:.1f} s")

    t = phase("6 one train_step: cuda == cpu")
    cuda_equals_cpu(device)
    log(f"  {time.time() - t:.1f} s")

    t = phase("7 the slice: Trainer.fit at arxiv width, agg=sized")
    metrics = kept_metrics()
    trainer = Trainer(cfg, store, ds, labels_num=cfg.n_way, metrics=metrics)
    assert trainer.device.type == "cuda" and trainer.agg == "sized"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in sp.launches:
        sp.launches[k] = 0
    t_fit = time.time()
    result = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.time() - t_fit
    main_path = dict(sp.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  FitResult {result}")
    log(f"  fit {fit_s:.1f} s; kernel launches {main_path}; peak device "
        f"memory {peak_gb:.2f} GB")
    steps = [r for r in metrics.records if r["kind"] == "train_step"]
    n_steps = len(tr_ds) // task_num
    assert len(steps) == n_steps and result.global_step == n_steps, steps
    for r in steps:
        assert math.isfinite(r["meta_loss"]) and r["nan_skip"] == 0, r
        assert all(0.0 <= a <= 1.0 for a in r["acc_curve"]), r
    for f in ("test_acc_ref", "test_acc_final", "best_test_acc",
              "early_stopped_ref", "val_max_acc"):
        assert 0.0 <= getattr(result, f) <= 1.0, result
    assert main_path["fwd"] > 0 and main_path["bwd"] > 0, main_path

    # one more meta-step on its own: kernel launches per meta-step
    for k in sp.launches:
        sp.launches[k] = 0
    assert math.isfinite(trainer.learner.train_step(batch)["meta_loss"]
                         .item())
    per_step = dict(sp.launches)
    # warm meta-steps, sized kernels vs dense torch.bmm, in turns, each
    # with its peak device memory
    dense = dense_learner(trainer, store)
    turns = {"sized": [], "dense": []}
    peaks = {"sized": [], "dense": []}
    for which in ("sized", "dense", "dense", "sized"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        turns[which].append(step_seconds(
            trainer.learner if which == "sized" else dense, batch))
        peaks[which].append(torch.cuda.max_memory_allocated() / 1e9)
    step_s = statistics.mean(turns["sized"])
    dense_s = statistics.mean(turns["dense"])
    log(f"  warm meta-step seconds in turns: {turns}; peak device memory "
        f"GB: {peaks}")
    breakdown = profile_step(
        lambda: trainer.learner.train_step(batch)["meta_loss"])
    del dense
    t1 = time.time()
    curves = trainer.evaluate("test")
    eval_s = time.time() - t1
    assert curves.shape == (n_eval, cfg.update_step_test + 1)
    log(f"  warm meta-step {step_s:.3f} s ({task_num / step_s:.2f} tasks/s, "
        f"{task_num * tr_ds.mean_edges_per_task / step_s:.0f} edges/s), "
        f"dense {dense_s:.3f} s; "
        f"launches {per_step}; fit steps compute_s "
        f"{[round(r['compute_s'], 3) for r in steps]}; evaluate(test) of "
        f"{n_eval} tasks {eval_s:.3f} s")
    del trainer
    torch.cuda.empty_cache()

    t = phase("8 the execution modes: streaming, compact pool, host-windowed"
              " pool; kill and resume")
    modes, mode_launches = fit_modes(
        dataclasses.replace(cfg, train_result_report_steps=2), store, ds)
    log(f"  {time.time() - t:.1f} s; kernel launches of phase 8 "
        f"{mode_launches}")

    t = phase("9 the CLI from disk: prepare, extract, remat")
    cli, cli_launches, plain9 = cli_phase(store, ds, device)
    log(f"  {time.time() - t:.1f} s; kernel launches of phase 9 "
        f"{cli_launches}")
    del store, ds, tr_ds, batch
    gc.collect()

    t = phase("10 the mesh: task-DP and the edge-partitioned engine")
    mesh, mesh_launches, rect_launches, (rect, rect_shape) = mesh_phase(
        device, plain9)
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    log(f"  {time.time() - t:.1f} s; kernel launches of phase 10: packed "
        f"{mesh_launches}, csr_gather {rect_launches}")

    kernels = []
    for direction, line in (("fwd", 39), ("bwd", 80)):
        head = timing[(direction, 256)]
        kernels.append({
            "name": f"sized_spmm_{direction}",
            "route": "cuda",
            "source": "gmeta_tpu_torch/csrc/sized_spmm.cu",
            "replaces": f"gmeta_tpu/ops/pallas_spmm.py:{line}",
            "launches": (main_path[direction] + mode_launches[direction]
                         + cli_launches[direction]
                         + mesh_launches[direction]),
            "launches_by_phase": {"7": main_path[direction],
                                  "8": mode_launches[direction],
                                  "9": cli_launches[direction],
                                  "10": mesh_launches[direction]},
            "max_abs_err": max(errs[direction]["float32"],
                               head["max_abs_err"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "dense_bmm_ms": head["dense_bmm_ms"],
            "shape": f"{qry_shape} H=256 float32",
            "max_abs_err_bf16": errs[direction]["bfloat16"],
            "launches_per_meta_step": per_step[direction],
            "by_H": {str(H): timing[(direction, H)] for H in (128, 256)},
        })
    for direction in ("fwd", "bwd"):
        head = rect[(direction, 256)]
        kernels.append({
            "name": f"csr_gather_{direction}",
            "route": "cuda",
            "source": "gmeta_tpu_torch/csrc/sized_spmm.cu",
            # the edge engine's segment-sum, an XLA op in the JAX package
            "replaces": "gmeta_tpu/parallel/edgepart_train.py:129",
            "launches": rect_launches[direction],
            "max_abs_err": head["max_abs_err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "shape": f"{rect_shape} H=256 float32",
            "by_H": {str(H): rect[(direction, H)] for H in (128, 256)},
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"slice": {
        "fit_s": fit_s, "warm_step_s": step_s,
        "tasks_per_s": task_num / step_s, "eval_test_s": eval_s,
        "peak_gb": peak_gb, "buckets": buckets, "build_s": build_s,
        "step_compute_s": [r["compute_s"] for r in steps],
        "dense_step_s": dense_s, "step_s_turns": turns,
        "step_peak_gb": peaks, "profile": breakdown,
        "result": dataclasses.asdict(result), "modes": modes, "cli": cli,
        "mesh": mesh, "card": card}}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:      # one rank of phase 10(c)
        rank_main(f"{sys.argv[2]}_{os.environ['RANK']}.npz", sys.argv[3:])
    else:
        main()
