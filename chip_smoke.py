#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gmeta_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:
  1. device   — CUDA must be available; prints the card's name and power
                limit (nvidia-smi).
  2. build    — compiles csrc/sized_spmm.cu (the packed body, the
                full-graph body and the combine kernel),
                csrc/gcn_epilogue.cu, csrc/gat_attention.cu and
                csrc/spatial_attention.cu from this checkout (nvcc,
                sm_90a).
  3. checks   — each kernel against its plain PyTorch version on the card,
                on packed edge lists (duplicates, pad edges): P in
                {512, 1024}, live sizes {0, 1, 127, 129, P},
                H in {1, 5, 50, 128, 256}, float32 and bf16; the forward,
                the backward through SizedAgg, and a double backward.
                (b) both GraphConv epilogue kernels against their plain
                versions, bit for bit, float32 and bf16, at ragged
                shapes with kinks and a NaN.
  4. data     — the arxiv-scale synthetic graph (170k nodes, degree 28,
                128 features, 15 classes, 1000-node subgraph cap) and its
                episodes (192 train tasks, 48 val and 48 test), built with
                the port's numpy host layer.
  5. timing   — both kernels at this run's arxiv query batch as the
                CSR path runs it: the meta-step's tasks, each task's live
                slots of its bins of P = 1024 repacked into one bin of M
                rows (data/repack.py, M from the host's bin fills), the
                batch's real edges, H = 128 and 256, float32, after
                checking that the CSRs hold densify's edges of the slot
                layout and each live slot's degrees at its row: kernel,
                plain version, torch.sparse.mm of the same CSR (cuSPARSE)
                and torch.bmm over the slot layout's dense blocks (what
                agg="dense" runs), the last two yardsticks only; medians
                of CUDA-event times over 20 launches, beside the least
                time the card could take for this data: reading the x
                rows the edges name and the int32 indices once and
                writing the T x M output rows once, or the 2 x nnz x H
                operations of the edges, whichever is longer.
                (b) the epilogue kernels at the batch's repacked query and
                support rows (T x 1 x M x 256), float32 and bf16: bit
                for bit their plain versions, and the wrapper the model
                calls bit for bit autograd of the chain (out, g_x, g_b);
                at the query rows their times beside their bound (the
                function's bytes over 3.35 TB/s) and the chain's.
  6. cuda=cpu — at a small size, one train_step on cuda (kernels) equals
                the same step on cpu (plain versions) from the same params.
  7. slice    — Trainer.fit at the arxiv preset's widths with agg="sized",
                float32, cut to 6 meta-steps of 32 tasks (batchsz 10000 ->
                192), 48 val/test tasks (eval_batchsz 100 -> 48), 1 epoch
                (10 -> 1). Kernel launch counts are set to 0 just before it
                and read just after; both kernels and both epilogue
                kernels must have run (the epilogue's launches are then
                counted phase by phase, each from 0). Then warm
                sized and dense meta-steps in turns, with the seconds and
                peak device memory of each, and a profiled sized step.
                A Trainer built on the card with agg="auto" over this
                cell must resolve it by the card's rule (data/pipeline.py
                `agg_for` on CUDA, its echo line naming the card's
                crossover); what auto picks on the card and on the CPU
                is printed.
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
                per direction (no combine: no row of this graph is split),
                communication plan and one profiled meta-step (device time
                by kernel); then the rectangular entry point `csr_gather`
                timed on that engine's CSR pair and on a power-law pair of
                the same V and nnz (both directions, H = 128 and 256,
                float32; `time_rect`), against its plain version, the
                row-wise body it ran before, torch.sparse.mm and its bound,
                and the combine kernel alone (H = 128 and 256, float32
                and bf16 rows, single launches and back to back); then
                main() with
                --mesh_edges 1 on a power-law graph of that size (depth cut
                as in (c)), whose split rows launch the combine kernel.
                (c) ranks sharing this card over gloo, each a process of
                its own (parallel/launch.py, this script with --rank):
                --mesh_tasks 4 on the packed path (theta equal to (a)), its
                gradient at equal params at every step 2-6 (resumed from
                (a)'s checkpoints, one step each, --one-step-rank), and
                --mesh_tasks 2 --mesh_edges 2 on the edge engine
                with the depth cut (task_num 4, update_step 2,
                update_step_test 2) against an in-process world of one of
                the same flags; rtol 1e-5, atol 1e-5, the head bias
                bounded; every rank launches its kernels and holds the same
                theta; the seconds each rank spent in the halo all-to-all
                and the all-reduces. Gloo between ranks of one card is no
                measure of scaling across cards.
  11. parity  — the other presets, from the JAX runs of record.
                For fold_ppi (Disjoint, 144 graphs, float32), firstmm_db
                (link prediction, Shared, float32) and tissue_ppi (Shared,
                task_mode, bf16, as its record ran): the replica made by
                data/replicas.py under build/chip_smoke_replicas/ (removed
                after), its graphs.npz held against the byte size in the
                DATASET marker of parity/<recipe>.ckpt; then
                run/parity.py's evaluation from that completed checkpoint
                (a copy), the dual final test on the full test set, with
                the record's aggregation (dense: torch.bmm) and then with
                agg="sized" (launch counts set to 0 just before it and
                read just after; both directions must launch). Each of
                the four test accuracies within 0.003 (float32) / 0.01
                (bf16) of the JAX package's CPU evaluation of the same
                checkpoint (parity_torch/<recipe>.eval_cpu_jax.json),
                within 0.01 / 0.02 of the TPU record, the sized pass
                within 0.003 / 0.01 of the dense one, and every per-task
                curve within one query of the JAX CPU evaluation's and,
                for the sized pass, of the dense pass's (run/parity.py
                EVAL_BOUNDS). Then entry()'s function on the card against
                the same function on the CPU from the same params (rtol
                1e-5), and dryrun_multichip(4) called with no device, as
                a user calls it: its ranks share this card over gloo (the
                edge engine's gathers must launch in them).
  12. measure — the measurement scripts (gmeta_tpu_torch/scripts/), each
                main() in this process at a cut size: bench_kernels at the
                five runs of record's buckets with one task each (float32
                and bf16), bench_pallas_spmm, bench_transfer (2 reps),
                bench_edges at 2^19 nodes, and bench_edgepart on a
                Tree-of-Life-shaped replica of 64 graphs made under
                build/chip_smoke_measure/ (the ToL recipe's per-graph
                parameters, so ToL's rows but not its size; removed after).
                Each script holds every path against its plain version
                and raises on a miss, and must print its result as JSON.
                Launch counts are set to 0 just before and read just
                after: the packed kernel, the full-graph body (both
                directions each) and the combine kernel must launch.
  13. calibrate — the replica calibrators (gmeta_tpu_torch/scripts/
                calibrate_*.py). (a) calibrate_replicas' five proxies at
                their full sizes, the A_hat^2 X hops through the
                full-graph body (and the combine kernel for rows of more
                than 128 edges), each hop held against csr_plain on the
                same input within cardtime.rounding_bound; then the same
                proxies through csr_plain on the card. Both proxy values
                of each recipe within 0.002 of the plain run's and of the
                JAX script's on the CPU (calibrate_replicas.JAX_CPU).
                (b) calibrate_link firstmm_db, one row (noise 0.30, beta
                3.5, --probe --agg sized) through the parity runner from
                the JAX initial theta, under build/chip_smoke_cal/
                (removed after): finite accuracies and the JAX script's
                sweep JSON keys. Launch counts are set to 0 just before
                and read just after each part: (a) must launch the
                full-graph body, (b) the packed kernel both ways.
  14. bench   — the throughput benchmark (gmeta_tpu_torch/bench.py) and
                the shared-adjacency call. (a) `bench_shape` on the five
                shapes at full width and the runs of record's geometry
                (parity/<recipe>.json buckets, fill, pool mode; bf16; 16
                meta-steps after one warm step and one FLOP-counted step);
                first, per shape, what agg="auto" resolves to at the
                record's geometry on the card and on the CPU (`agg_for`
                at the shape's widths, bf16), and `densify` of the whole
                pool (host form and compact-decoded form, float32 and
                bf16) under torch.cuda.set_sync_debug_mode("error"),
                bitwise equal to `densify_serial`, the form that
                scattered every pad edge into one cell; then
                the record's aggregation (dense in all five) and
                agg="sized" in turns; launch counts set to 0 just before
                each sized run and read just after: the packed kernel must
                launch both ways in every shape, in bf16, and where layer
                1 aggregates first (every shape but fold_ppi, which
                projects 512 -> 128 first) forward in float32 too (layer
                1's input stays float32, as JAX's promotion keeps it);
                fold_ppi launches only bf16. Finite tasks/s, 0 < mfu
                <= 1, equal FLOPs on both paths, and the first meta-step's
                loss under sized within TOLS["bfloat16"] of the record
                aggregation's. Then `bench_extraction` (the device
                extractor against the C++ engine, 170k nodes, degree 28).
                (b) `aggregate_sized_shared` on the arxiv pool's first
                query set (37 bins of 1024), H = 256: driven once at T = 3
                with counts set to 0 before and read after (one launch
                each way, the tasks on the kernel's grid); then at T = 3
                and 32, float32 and bf16, held against sized_plain and
                bitwise against T launches, forward and gradient, and
                timed in float32 against the T launches, sized_plain and
                torch.sparse.mm (on h laid out as rows of T * H), beside
                its bound at width T * H.
  15. gat     — GAT's attention kernels (ops/gat_attention.py,
                csrc/gat_attention.cu) at the gat_ppi.pool cell's set
                shapes as the CSR path runs them: (a) 16 tasks x 16 bins
                (query) and x 6 bins (support) of 1024 slots, 586 live,
                repacked into one bin of M rows a task (9,376 and 3,520;
                bench_gat.packed_graph, each original bin's rows a
                segment), the cell's real edges, heads of 4 x 256 and
                6 x 121: the wrapper `attend` and the autograd Function
                on the card, staged, against `fwd_plain` and `bwd_plain`
                (one forward and three backward launches a call, all
                staged; o and the gradient's z, s and t parts within rtol
                1e-4, atol 2e-5 of each tensor's largest magnitude), and
                the staged forward's o and lse bit for bit the walk
                kernel's; (b) one meta-step of the cell's configuration
                (the tissue_ppi preset with arch 'gat', 16 tasks,
                float32) on a batch of its geometry, after a warm step,
                launch counts set to 0 just before and read just after:
                3 layers x (2 U + 2) forwards and x (U + 2) backwards of
                3 kernels, every one staged; its seconds and peak memory;
                (c) bench_gat: each direction's staged and walk kernels
                timed at both repacked sets and widths beside
                `attention_bound` and the plain versions.
  16. graphormer — Graphormer's distances and attention kernels
                (ops/spatial_attention.py, csrc/spatial_attention.cu) at
                the graphormer_ppi.pool cell's set shapes as the CSR path
                runs them: (a) 16 tasks x 16 bins (query) and x 6 bins
                (support) of 586 live slots, one graph a bin, repacked
                (bench_graphormer.graph_inputs), 8 heads of 10: the
                distance kernel's bytes those of `distances_plain` (one
                launch a set), then `attend` and the autograd Function on
                the card against `fwd_plain` and `bwd_plain` (one forward
                and four backward launches a call; o and the gradients of
                q, k, v and the spatial table within rtol 1e-4, atol 2e-5
                of each tensor's largest magnitude); (b) one meta-step of
                the cell's configuration (the tissue_ppi preset with arch
                'graphormer', Graphormer-slim's widths, 16 tasks,
                float32) on a batch of its geometry (GAT_SETS), after a
                warm step, launch counts set to 0 just before and read
                just after: 12 layers x (2 U + 2) forwards and x (U + 2)
                backwards of 4 kernels, and 2 distance launches; its
                seconds and peak memory; (c) bench_graphormer: each
                direction timed at both repacked sets beside
                `spatial_attention_bound` and the plain versions, and the
                distances.

Phase 2 builds the CUDA kernels (nvcc) and the host extraction engine (g++)
at once. Prints phase 11's parity JSON line, phase 14's bench JSON line,
the kernels' JSON line (the packed kernel's launches summed over phases
7-14 and every rank, the rectangular entry point's and its combine
kernel's over phases 10-13, the shared call's from 14(b), the GAT
attention's from 15, Graphormer's from 16),
the slice's JSON line (with the modes' warm tasks/s, data_s and peak
device memory under "modes", phase 9's numbers under "cli", phase 10's
under "mesh", phase 12's under "measure", phase 13's under
"calibrate", phase 15's under "gat" and phase 16's under "graphormer"),
the card's name and power
limit, and last
{"ok": true, "device": {...}}. Imports nothing of JAX or the JAX package,
and neither do its rank processes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import os
import shutil
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

try:
    from gmeta_tpu_torch.utils.cardtime import (HBM_BYTES_S, card_line,
                                                combine_bound, cuda_ms,
                                                cuda_ms_b2b, epilogue_bound,
                                                gather_bound, rounding_bound)
    from gmeta_tpu_torch.utils.metrics import counted
except ImportError as e:
    raise SystemExit(f"chip_smoke: the gmeta_tpu_torch package is not "
                     f"beside this script ({e})")
TOLS = {"float32": (1e-5, 1e-4), "bfloat16": (8e-3, 8e-3)}  # (rtol, atol)
# float32: sums of up to P products in another order than cuBLAS's;
# bf16: both round a float32 sum to bf16, one ulp = 2^-7 relative.


def log(msg):
    print(msg, flush=True)


def phase(name):
    log(f"== {name}")
    return time.time()


def timed_row(kernel, plain, library, nnz, H, read_rows, n_out):
    """Median ms of a gather kernel, its plain version and one library call
    computing the same, beside `gather_bound`."""
    ms = cuda_ms(kernel)
    bound_ms, bound_by, nbytes = gather_bound(nnz, H, read_rows, n_out)
    return dict(ms=ms, plain_ms=cuda_ms(plain), library_ms=cuda_ms(library),
                bound_ms=bound_ms, bound_by=bound_by,
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


def _bits(t):
    import torch
    if t.dtype == torch.bool:
        return t
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _epilogue_inputs(shape, dtype, device, seed=0):
    """x, n (degree norms) and a per-task bias (T, 1, 1, H), on the card."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    T, B, P, H = shape
    x = torch.randn(shape, device=device, generator=g).to(dtype)
    n = torch.rsqrt(torch.randint(1, 30, (T, B, P, 1), device=device,
                                  generator=g).float()).to(dtype)
    b = (0.5 * torch.randn((T, 1, 1, H), device=device, generator=g)
         ).to(dtype)
    return x, n, b


def check_epilogue(device):
    """Phase 3(b): both epilogue kernels against their plain versions on
    the card, bit for bit: out, y, the mask, g_x and g_pre, float32 and
    bf16, with and without the next layer's scale, at ragged shapes (H 1,
    5, 50, 130 take the scalar path), with pre-activations at the kink
    (x = 0, b = 0) and a NaN. Returns the number of elements compared."""
    import torch
    from gmeta_tpu_torch.ops import epilogue as ep
    seen = 0
    for shape in ((3, 2, 5, 1), (2, 3, 7, 5), (2, 1, 9, 50), (4, 2, 3, 130),
                  (2, 3, 64, 256)):
        for dtype in (torch.float32, torch.bfloat16):
            x, n, b = _epilogue_inputs(shape, dtype, device, seed=shape[-1])
            x[:, :, 0] = 0
            b[..., : shape[-1] // 2] = 0
            x.view(-1)[-1] = float("nan")
            g = torch.randn(shape, device=device).to(dtype)
            for scale_out in (True, False):
                got = ep._launch_fwd(x, n, b, scale_out, True, True)
                want = ep.fwd_plain(x, n, b, scale_out, True, True)
                for a, w in zip(got, want):
                    assert torch.equal(_bits(a), _bits(w)), (shape, dtype)
                got = ep._launch_bwd(g, n, want[2], scale_out, True)
                want = ep.bwd_plain(g, n, want[2], scale_out)
                for a, w in zip(got, want):
                    assert torch.equal(_bits(a), _bits(w)), (shape, dtype)
                seen += 5 * x.numel()
    torch.cuda.synchronize()
    log(f"  gcn_epilogue: fwd and bwd bitwise their plain versions over "
        f"{seen} elements")
    return seen


def check_epilogue_at_scale(x, n, b, g):
    """Phase 5(b)'s check at a main-path shape, where the grid reaches its
    cap and each block strides over many rows: both kernels bit for bit
    their plain versions (out, the mask, g_x, g_pre), and the wrapper the
    model calls (`graphconv_epilogue`, through `Epilogue` with its saved
    mask and the bias's `sum_to_size`) bit for bit autograd of the chain
    of separate ops: out, g_x and g_b, with and without the next layer's
    scale, b per task (T, 1, 1, H) as the inner loop's fast weights give
    it and a stride-0 expand of (H,) as theta's. Returns the elements
    compared."""
    import torch
    from gmeta_tpu_torch.ops import epilogue as ep
    seen = 0
    for scale_out in (True, False):
        got = ep._launch_fwd(x, n, b, scale_out, False, True)
        want = ep.fwd_plain(x, n, b, scale_out, False, True)
        for a, w in ((got[0], want[0]), (got[2], want[2])):
            assert torch.equal(_bits(a), _bits(w)), (x.shape, x.dtype)
        got = ep._launch_bwd(g, n, want[2], scale_out, True)
        want = ep.bwd_plain(g, n, want[2], scale_out)
        for a, w in zip(got, want):
            assert torch.equal(_bits(a), _bits(w)), (x.shape, x.dtype)
        del got, want
        seen += 5 * x.numel()
    theta_b = b[0, 0, 0].clone()
    for scale_out, per_task in ((True, True), (False, True), (True, False)):
        res = []
        for fused in (True, False):
            xg = x.clone().requires_grad_(True)
            bg = (b if per_task else theta_b).clone().requires_grad_(True)
            b_use = bg if per_task else bg.expand(b.shape)
            if fused:
                out, _ = ep.graphconv_epilogue(xg, n, b_use, scale_out)
            else:
                out = torch.relu(xg * n + b_use)
                out = out * n if scale_out else out
            res.append((out.detach(), *torch.autograd.grad(out, (xg, bg),
                                                           g)))
            del xg, bg, b_use, out
        for a, w in zip(*res):
            assert torch.equal(_bits(a), _bits(w)), (x.shape, x.dtype,
                                                     scale_out, per_task)
        seen += 2 * x.numel() + res[0][2].numel()
        del res
    torch.cuda.synchronize()
    return seen


def time_epilogue(device, shapes):
    """Phase 5(b): the epilogue kernels at `shapes`, phase 5's query and
    support sets as the CSR path runs them (T tasks x one bin of M rows,
    hidden 256: `epilogue_shapes`), float32 and bf16:
    first `check_epilogue_at_scale`, then at the query shape their times
    beside their bound (`epilogue_bound`, the function's own bytes; the
    backward's with the bias's sum) and the PyTorch chain they replace:
    forward x * n + b, relu, * n (4 kernels); backward g * n,
    threshold_backward, * n (3 kernels), each with the bias gradient's
    sum. Medians of CUDA event times over 20 calls."""
    import torch
    from gmeta_tpu_torch.ops import epilogue as ep
    rows_out = {}
    for shape in shapes:
        T, B, P, H = shape
        rows = T * B * P
        for dtype in (torch.float32, torch.bfloat16):
            x, n, b = _epilogue_inputs(shape, dtype, device)
            x[:, :, 0] = 0                   # pre-activations at the kink
            b[..., : H // 4] = 0
            g = torch.randn(shape, device=device).to(dtype)
            seen = check_epilogue_at_scale(x, n, b, g)
            log(f"  gcn_epilogue {dtype} {shape}: fwd, bwd and the wrapper's "
                f"gradients bitwise the chain over {seen} elements")
            if shape != shapes[0]:
                del x, n, b, g
                torch.cuda.empty_cache()
                continue
            out, _, mask = ep._launch_fwd(x, n, b, True, False, True)
            y = torch.relu(x * n + b)

            def chain_fwd():
                return torch.relu(x * n + b) * n

            def chain_bwd():
                gp = torch.ops.aten.threshold_backward(g * n, y, 0)
                return gp * n, gp.sum_to_size(b.shape)

            def fused_bwd():
                g_x, g_pre = ep._launch_bwd(g, n, mask, True, True)
                return g_x, g_pre.sum_to_size(b.shape)
            its = x.element_size()
            r = {
                "fwd_ms": cuda_ms(lambda: ep._launch_fwd(x, n, b, True,
                                                         False, True)),
                "fwd_no_mask_ms": cuda_ms(lambda: ep._launch_fwd(
                    x, n, b, True, False, False)),
                "bwd_kernel_ms": cuda_ms(lambda: ep._launch_bwd(
                    g, n, mask, True, True)),
                "bwd_ms": cuda_ms(fused_bwd),
                "chain_fwd_ms": cuda_ms(chain_fwd),
                "chain_bwd_ms": cuda_ms(chain_bwd),
                "bias_sum_ms": cuda_ms(lambda: g.sum_to_size(b.shape)),
                "checked_elements": seen,
            }
            for d in ("fwd", "bwd"):
                bound_ms, by, nbytes = epilogue_bound(rows, H, d, its,
                                                      bias_elems=T * H)
                r[f"{d}_bound_ms"], r[f"{d}_bound_by"] = bound_ms, by
                r[f"{d}_roofline"] = 100 * bound_ms / r[f"{d}_ms"]
            # the kernel alone against the bytes it moves: the function's
            # and g_pre written for the bias's sum
            r["bwd_kernel_gb_per_s"] = (rows * (H * (3 * its + 1) + its)
                                        / (r["bwd_kernel_ms"] * 1e-3) / 1e9)
            rows_out[str(dtype).removeprefix("torch.")] = r
            log(f"  gcn_epilogue {dtype} {shape}: fwd {r['fwd_ms']:.3f} ms "
                f"(no mask {r['fwd_no_mask_ms']:.3f}; bound "
                f"{r['fwd_bound_ms']:.3f}, {r['fwd_roofline']:.1f}%) against "
                f"the chain's {r['chain_fwd_ms']:.3f}; bwd with the bias "
                f"sum {r['bwd_ms']:.3f} ms (bound {r['bwd_bound_ms']:.3f}, "
                f"{r['bwd_roofline']:.1f}%; the kernel alone "
                f"{r['bwd_kernel_ms']:.3f}, "
                f"{r['bwd_kernel_gb_per_s']:.0f} GB/s of its own bytes) "
                f"against the chain's {r['chain_bwd_ms']:.3f} (the sum "
                f"alone {r['bias_sum_ms']:.3f})")
            del x, n, b, g, out, mask, y
            torch.cuda.empty_cache()
    return rows_out


def epilogue_shapes(batch, H=256):
    """The (T, 1, M, H) rows of a host batch's query and support sets
    repacked (data/repack.py), query first."""
    from gmeta_tpu_torch.data.repack import bin_rows, live_counts
    return tuple((sg.bin_fill.shape[0], 1, bin_rows(live_counts(sg.bin_fill)),
                  H) for sg in (batch.qry, batch.spt))


def arxiv_data(seed=7):
    """Phase 4: the arxiv-scale synthetic graph and its episodes (the sizes
    of bench.py's arxiv shape)."""
    from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
    return synthetic_disjoint(
        num_graphs=1, nodes_per_graph=170_000, avg_degree=28, feat_dim=128,
        num_classes=15, n_way=3, k_spt=3, k_qry=24, batchsz=192, h=2,
        sample_nodes=1000, seed=seed)


def time_kernels(batch, device):
    """Phase 5: both kernels at the main path's query batch and data,
    repacked as the CSR path runs it (`MetaLearner._decode`: each task's
    live slots in one bin of M rows, M from the host's bin fills)."""
    import torch
    from gmeta_tpu_torch.data.repack import bin_rows, live_counts, repack
    from gmeta_tpu_torch.meta.maml import batch_to
    from gmeta_tpu_torch.models.gcn import precompute
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.ops.spmm import degrees_from_dense, densify

    slot = batch_to(batch, device).qry
    T, B, P = slot.node_gid.shape
    live = live_counts(batch.qry.bin_fill)
    M = bin_rows(live)
    qry = repack(slot, M, live)
    S, N = T, T * M
    torch.cuda.synchronize()
    t0 = time.time()
    graph = precompute(qry, agg="sized").sized
    torch.cuda.synchronize()
    build_ms = (time.time() - t0) * 1e3
    # a check only: the CSRs hold densify's edges of the slot layout, and
    # each live slot's degrees at its repacked row, in order
    A = densify(slot.edge_src, slot.edge_dst, slot.edge_mask, B, P).view(
        T * B, P, P)
    nnz = int(graph.row_ptr[-1])
    assert nnz == int(graph.row_ptr_t[-1]) == int(qry.edge_mask.sum()) \
        == int(A.sum(dtype=torch.float64)), nnz
    on_slot = slot.node_mask.view(T, B * P) > 0
    on_row = torch.arange(M, device=device) < torch.as_tensor(
        live, device=device)[:, None]
    for got, want in (
            (graph.degrees(), degrees_from_dense(A)),
            (graph.row_ptr_t[1:] - graph.row_ptr_t[:-1], A.sum(dim=-2))):
        got = got.view(T, M).float()
        assert torch.equal(got[on_row], want.view(T, B * P)[on_slot])
        assert not got[~on_row].any()
    log(f"  {T} tasks of {B} bins x {P} slots repacked into {M} rows "
        f"(row share {M / (B * P):.4f}, live share "
        f"{float(live.sum()) / N:.4f}), nnz {nnz}; CSRs built in "
        f"{build_ms:.1f} ms ({8 * (N + 1 + qry.edge_mask.numel()) / 1e6:.1f}"
        f" MB) where densify's A of the slot layout is "
        f"{A.numel() * 4 / 1e9:.2f} GB")
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
            x = torch.randn(S, M, H, device=device, generator=g)
            x_slot = torch.randn(T * B, P, H, device=device, generator=g)
            got = sp.launch(direction, graph, x)
            want = sp.sized_plain(row_ptr, col, x)
            e = (got - want).abs().max().item()
            rtol, atol = TOLS["float32"]
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            torch.testing.assert_close(      # the yardstick's function
                torch.sparse.mm(sparse, x.view(N, H)).view(S, M, H), want,
                rtol=rtol, atol=atol)
            del got, want
            row = rows[(direction, H)] = dict(timed_row(
                lambda: sp.launch(direction, graph, x),
                lambda: sp.sized_plain(row_ptr, col, x),
                lambda: torch.sparse.mm(sparse, x.view(N, H)),
                nnz, H, read_rows, N), max_abs_err=e,
                dense_bmm_ms=cuda_ms(lambda: torch.bmm(At, x_slot)))
            log(f"  {direction} H={H}: kernel {row['ms']:.3f} ms "
                f"({row['gb_per_s']:.0f} GB/s of the bound's "
                f"{row['bound_gb']:.3f} GB; "
                f"{100 * row['bound_ms'] / row['ms']:.1f}% of the bound), "
                f"plain {row['plain_ms']:.3f} ms, torch.sparse.mm "
                f"{row['library_ms']:.3f} ms, torch.bmm "
                f"{row['dense_bmm_ms']:.3f} ms, bound {row['bound_ms']:.3f} "
                f"ms ({row['bound_by']}), max abs err {e:.3g}")
            del x, x_slot
        del sparse
    del A
    torch.cuda.empty_cache()
    return rows, f"T={T} M={M} (from B={B} P={P}) nnz={nnz}"


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
        launched = counted()
        ml = MetaLearner(spec, 3, update_lr=0.05, meta_lr=1e-3,
                         update_step=3, update_step_test=3, seed=1,
                         agg="sized", device=dev)
        ml.set_features(store.features)
        m = ml.train_step(batch)
        out[dev.type] = (m["meta_loss"].item(), m["accs"].cpu().numpy(),
                         [p.detach().cpu().numpy() for p in ml.params],
                         launched.of(sp.LAUNCHES))
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
    """`cardtime.profile` of one meta-step (`step()` returns its loss on
    the device), logged: device time by kernel and the device's busy share
    of the step's wall time (profiler on). Returns None, and says so, where
    the profiler records no device time."""
    from gmeta_tpu_torch.utils.cardtime import profile
    res = profile(step, top)
    if res is None:
        log("  profiler: no device time recorded; breakdown not measured")
        return None
    log(f"  profiled meta-step: wall {res['wall_ms']:.1f} ms, device busy "
        f"{res['busy_ms']:.1f} ms ({100 * res['busy_share']:.1f}%)")
    for k, ms in res["top"]:
        log(f"    {ms:9.2f} ms {100 * ms / res['busy_ms']:5.1f}%  {k}")
    return {k: res[k] for k in ("wall_ms", "busy_ms", "top")}


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
            self.echoed = []

        def log(self, kind, **payload):
            rec = super().log(kind, **payload)
            self.records.append(rec)
            return rec

        def echo_line(self, msg):
            super().echo_line(msg)
            self.echoed.append(msg)

    return Kept()


def auto_choices(split, spec, dtype):
    """What agg="auto" resolves to for a split (a MetaDataset or a
    SplitGeometry) at a model's widths and dtype: on the card and on the
    CPU (data/pipeline.py `agg_for`), with the split's real edges per slot
    and the card's crossover there."""
    import torch
    from gmeta_tpu_torch.data.pipeline import (agg_for, aggregation_width,
                                               card_crossover,
                                               edges_per_slot)
    P = max(split.P_spt, split.P_qry)
    return {"card": agg_for(split, torch.device("cuda"), spec, dtype),
            "cpu": agg_for(split, torch.device("cpu"), spec, dtype),
            "edges_per_slot": edges_per_slot(split),
            "crossover": card_crossover(P, aggregation_width(spec), dtype)}


def auto_trainer(cfg, store, ds):
    """Phase 7: a Trainer on the card with agg="auto" over phase 4's cell
    resolves it by the card's rule: its agg is `agg_for`'s on CUDA and its
    echo line names the card's crossover. Returns `auto_choices`."""
    from gmeta_tpu_torch.run.train import Trainer
    metrics = kept_metrics()
    trainer = Trainer(dataclasses.replace(cfg, agg="auto"), store, ds,
                      labels_num=cfg.n_way, metrics=metrics)
    got = auto_choices(ds["train"], trainer.spec, cfg.dtype)
    line = [m for m in metrics.echoed if m.startswith("agg kernel:")]
    assert trainer.device.type == "cuda" and trainer.agg == got["card"], \
        (trainer.agg, got)
    assert len(line) == 1 and "the card's crossover" in line[0], line
    log(f"  auto on phase 4's cell: card {got['card']}, CPU {got['cpu']} "
        f"({got['edges_per_slot']:.4f} real edges per slot, crossover "
        f"{got['crossover']:.2f}); Trainer: {line[0]}")
    return got


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
    launched = counted()
    t0 = time.time()
    result = None
    try:
        result = trainer.fit()
    except Killed:
        assert kill_after_windows
    torch.cuda.synchronize()
    out = {"mode": mode, "fit_s": time.time() - t0,
           "launches": launched.of(sp.LAUNCHES), "start": start,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "entered_host_window": bool(hit), "result": result,
           "theta": [p.detach().cpu().numpy() for p in trainer.learner.params],
           "global_step": trainer.global_step}
    out["theta_sha256"] = theta_digest(out["theta"])
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
    from gmeta_tpu_torch.ops import sized_spmm as sp
    order = ["streaming", "compact", "host_window",
             "host_window", "compact", "streaming"]
    runs = {m: [] for m in MODES}
    launched = counted()
    for mode in order:
        r = run_mode(cfg, store, ds, mode)
        runs[mode].append(r)
        log(f"  {mode}: fit {r['fit_s']:.1f} s, warm "
            f"{r.get('tasks_per_s', float('nan')):.2f} tasks/s, peak "
            f"{r['peak_gb']:.2f} GB, launches {r['launches']}"
            + (f", data_s {[round(x, 3) for x in r['data_s']]}"
               if r["data_s"] else "")
            + (f", pool {r['pool']}" if "pool" in r else "")
            + f", theta sha256 {r['theta_sha256'][:16]}")
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
    shutil.rmtree(ck, ignore_errors=True)

    summary = {"order": order, "steps": steps, "theta_diff": diffs,
               "resume": {"theta_diff": resume_diff,
                          "start": resumed["start"],
                          "fit_s": resumed["fit_s"]}}
    for m, rs in runs.items():
        summary[m] = {k: [r.get(k) for r in rs] for k in
                      ("tasks_per_s", "record_tasks_per_s", "peak_gb",
                       "fit_s", "data_s", "launches", "theta_sha256")}
        if "pool" in rs[0]:
            summary[m]["pool"] = [r["pool"] for r in rs]
        summary[m]["tasks_per_s_mean"] = statistics.mean(
            r["tasks_per_s"] for r in rs)
    return summary, launched.of(sp.LAUNCHES)


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
    launched = counted()
    t0 = time.time()
    result, trainer = spy_main(argv)
    torch.cuda.synchronize()
    out = {"remat": remat, "main_s": time.time() - t0,
           "launches": launched.of(sp.LAUNCHES),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "result": dataclasses.asdict(result)}
    assert trainer.device.type == device.type and trainer.agg == "sized"
    assert trainer.cfg.remat_inner == remat
    assert not any(launched.of(sp.CSR_LAUNCHES).values()), out
    out["theta"] = [p.detach().cpu().numpy() for p in trainer.learner.params]
    out["theta_sha256"] = theta_digest(out["theta"])
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
    thetas, launched = {}, counted()
    for remat in (True, False, False, True):
        ml = MetaLearner(spec, cfg.n_way, update_lr=cfg.update_lr,
                         meta_lr=cfg.meta_lr, update_step=cfg.update_step,
                         update_step_test=cfg.update_step_test,
                         first_order=False, remat=remat, seed=cfg.seed,
                         agg="sized", task_chunk=chunk, device=device)
        ml.set_features(store.features)
        fresh_card()
        seconds = step_seconds(ml, batch)
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
            "theta_diff": diff}, launched.of(sp.LAUNCHES)


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
             "launches", "theta_sha256")}
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


def theta_digest(theta):
    """sha256 of a fit's parameters' bytes, in order: two fits with equal
    digests ended at bitwise-equal theta."""
    import hashlib
    h = hashlib.sha256()
    for p in theta:
        h.update(p.tobytes())
    return h.hexdigest()


def edge_fit(argv, metrics_path, device):
    """One main() of the edge-partitioned engine in this process (a world
    of one, NCCL on the card), with its launch counts set to 0 before it.
    Returns (its numbers, the trainer)."""
    import torch
    from gmeta_tpu_torch.ops import sized_spmm as sp
    if metrics_path.exists():
        metrics_path.unlink()
    fresh_card()
    launched = counted()
    t0 = time.time()
    result, trainer = spy_main(argv + ["--mesh_edges", "1", "--metrics_path",
                                       str(metrics_path)])
    torch.cuda.synchronize()
    out = {"main_s": time.time() - t0,
           "csr_launches": launched.of(sp.CSR_LAUNCHES),
           "combine_launches": launched.of(sp.COMBINE_LAUNCHES),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "result": dataclasses.asdict(result), "comm": trainer.comm,
           "theta": [p.detach().cpu().numpy() for p in trainer.engine.params]}
    out["theta_sha256"] = theta_digest(out["theta"])
    assert trainer.engine.device.type == device.type
    assert not any(launched.of(sp.LAUNCHES).values()), out
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
    """The rectangular entry point at the full-graph shape, on two CSR
    pairs of one V and nnz: the edge engine's (uniform endpoints, rows of
    about 28 edges) and a power-law pair (`powerlaw_edges`, rows of up to
    about 93k edges, split by the plan). Both directions, H = 128 and 256,
    float32. Checks, each on the card: on small-integer tables, whose sums
    are exact in any order, the kernel (body and combine) and
    torch.sparse.mm equal `csr_plain`; on normal tables, two launches
    give the same bits, every row that is not split equals the row-wise
    body (`rowwise_gather`, the kernel csr_gather ran before its
    full-graph body) bitwise, and every row lies within TOLS["float32"]
    of `csr_plain` (uniform) or within `rounding_bound` of it (power-law,
    rows of hundreds of edges); the combine kernel equals
    `combine_plain` on exact partials. Times (medians of CUDA-event
    times): the kernel, the row-wise body, the plain version and
    torch.sparse.mm of the same CSR, beside `gather_bound`; the combine
    kernel alone on the power-law forward CSR's split rows beside its own
    bound (`time_combine`). Returns ({(graph, count, H): row}, the combine
    kernel's rows by "dtype H", shapes)."""
    import torch
    from gmeta_tpu_torch.ops import sized_spmm as sp
    rows, combine = {}, {}
    g = torch.Generator(device=device).manual_seed(1)
    n_dst, n_src = pair.row_ptr.numel() - 1, pair.row_ptr_t.numel() - 1
    nnz = pair.col.numel()
    t0 = time.time()
    power = sp.csr_pair(*powerlaw_edges(n_src, nnz), n_src, n_dst).to(device)
    lengths = (power.row_ptr[1:] - power.row_ptr[:-1]).long()
    log(f"  power-law CSR built in {time.time() - t0:.1f} s: longest row "
        f"{int(lengths.max())}, median {float(lengths.median()):.0f}, "
        f"{power.split.rows.numel()} rows above {power.split.chunk} edges "
        f"cut into {power.split.chunk_row.numel()} chunks")
    for graph, p in (("uniform", pair), ("powerlaw", power)):
        for count, row_ptr, col, split, n_out, n_in in (
                ("fwd", p.row_ptr, p.col, p.split, n_dst, n_src),
                ("bwd", p.row_ptr_t, p.col_t, p.split_t, n_src, n_dst)):
            read_rows = torch.unique(col).numel()
            sparse = torch.sparse_csr_tensor(
                row_ptr, col, torch.ones(nnz, device=device),
                size=(n_out, n_in), check_invariants=False)
            whole = torch.ones(n_out, dtype=torch.bool, device=device)
            whole[split.rows.long()] = False          # rows not split
            for H in (128, 256):
                xi = torch.randint(-8, 9, (n_in, H), device=device,
                                   generator=g).float()
                exact = sp.csr_plain(row_ptr, col, xi)
                assert torch.equal(sp.csr_gather(row_ptr, col, xi, count,
                                                 split), exact)
                assert torch.equal(torch.sparse.mm(sparse, xi), exact)
                x = torch.randn(n_in, H, device=device, generator=g)
                got = sp.csr_gather(row_ptr, col, x, count, split)
                assert torch.equal(got, sp.csr_gather(row_ptr, col, x,
                                                      count, split))
                assert torch.equal(got[whole],
                                   rowwise_gather(row_ptr, col, x)[whole])
                want = sp.csr_plain(row_ptr, col, x)
                if graph == "uniform":
                    rtol, atol = TOLS["float32"]
                    torch.testing.assert_close(got, want, rtol=rtol,
                                               atol=atol)
                else:        # rows of up to `chunk` edges, split rows
                    assert ((got - want).abs()
                            <= rounding_bound(row_ptr, col, x)).all()
                e = (got - want).abs().max().item()
                if count == "fwd" and graph == "powerlaw":
                    combine.update(time_combine(split, row_ptr, col, xi,
                                                exact, device))
                del xi, exact, got, want
                row = rows[(graph, count, H)] = dict(timed_row(
                    lambda: sp.csr_gather(row_ptr, col, x, count, split),
                    lambda: sp.csr_plain(row_ptr, col, x),
                    lambda: torch.sparse.mm(sparse, x),
                    nnz, H, read_rows, n_out), max_abs_err=e,
                    rowwise_ms=cuda_ms(lambda: rowwise_gather(row_ptr, col,
                                                              x)),
                    longest_row=int((row_ptr[1:] - row_ptr[:-1]).max()),
                    split_rows=split.rows.numel(),
                    chunks=split.chunk_row.numel(),
                    slab=sp.slab_width(n_in, H, 4,
                                       sp.l2_bytes(device.index or 0)))
                # the rows the kernel gathers, each edge's once
                row["edge_gb_per_s"] = 4.0 * nnz * H / (row["ms"] * 1e-3) / 1e9
                log(f"  csr_gather {graph} {count} H={H}: kernel "
                    f"{row['ms']:.3f} ms ({100 * row['bound_ms'] / row['ms']:.1f}"
                    f"% of the bound; rows gathered at "
                    f"{row['edge_gb_per_s']:.0f} GB/s; slab {row['slab']}), "
                    f"row-wise body {row['rowwise_ms']:.3f} ms, plain "
                    f"{row['plain_ms']:.3f} ms, torch.sparse.mm "
                    f"{row['library_ms']:.3f} ms, bound "
                    f"{row['bound_ms']:.4f} ms ({row['bound_by']}), max abs "
                    f"err {e:.3g} (split rows {row['split_rows']})")
                del x
            del sparse
    torch.cuda.empty_cache()
    return rows, combine, {"uniform": f"V={n_dst} nnz={nnz}",
                           "powerlaw": f"V={n_dst} nnz={nnz} Zipf-0.8 "
                                       f"in-degrees, seed 0"}


def time_combine(split, row_ptr, col, xi, exact, device):
    """The combine kernel alone on the power-law CSR's split rows at
    H = xi's width, into float32 and bf16 rows: the chunks' float32
    partial sums of the small-integer table xi (exact, so the kernel must
    equal `combine_plain` bitwise, and the rows it writes must equal
    `exact`, the plain gather, rounded once to the row's dtype), and of a
    normal table, where the kernel must equal `combine_plain` on the CPU
    (which adds in chunk order) bitwise and leave every other row of out
    as it was. Timed, single launches and back to back, beside
    combine_plain, one index_add_ that sums the partials per row, and
    `combine_bound`. Returns {"<dtype> <H>": row}."""
    import torch
    from gmeta_tpu_torch.ops import sized_spmm as sp
    H = xi.shape[1]
    starts = split.chunk_start.long()
    ends = torch.minimum(starts + split.chunk,
                         row_ptr[split.chunk_row.long() + 1].long())
    per = ends - starts                               # edges per chunk
    edge = (torch.repeat_interleave(starts - torch.cumsum(per, 0) + per, per)
            + torch.arange(int(per.sum()), device=device))
    owner = torch.repeat_interleave(torch.arange(per.numel(),
                                                 device=device), per)
    partial = torch.zeros((per.numel(), H), device=device).index_add_(
        0, owner, xi[col[edge].long()])
    g = torch.Generator(device=device).manual_seed(H)
    noise = torch.randn(partial.shape, device=device, generator=g)
    n_split = split.rows.numel()
    owner_row = torch.repeat_interleave(
        torch.arange(n_split, device=device),
        (split.chunk_ptr[1:] - split.chunk_ptr[:-1]).long())
    split_cpu, noise_cpu = split.to("cpu"), noise.cpu()
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        out = torch.zeros(exact.shape, dtype=dtype, device=device)
        got = sp.csr_combine(split, partial, out.clone())
        assert torch.equal(got, sp.combine_plain(split, partial, out.clone()))
        assert torch.equal(got[split.rows.long()],
                           exact[split.rows.long()].to(dtype))
        sentinel = torch.full(exact.shape, 7.0, dtype=dtype, device=device)
        got = sp.csr_combine(split, noise, sentinel.clone())
        assert torch.equal(got.cpu(), sp.combine_plain(
            split_cpu, noise_cpu, sentinel.cpu()))
        assert torch.equal(got, sp.csr_combine(split, noise,
                                               sentinel.clone()))
        del got, sentinel
        bound_ms, bound_by, _ = combine_bound(
            per.numel(), n_split, H, out.element_size())

        def kernel():
            sp.csr_combine(split, partial, out)

        def library():
            torch.zeros((n_split, H), device=device).index_add_(
                0, owner_row, partial)
        name = str(dtype).removeprefix("torch.")
        row = rows[f"{name} {H}"] = dict(
            ms=cuda_ms(kernel), ms_b2b=cuda_ms_b2b(kernel),
            plain_ms=cuda_ms(lambda: sp.combine_plain(split, partial, out)),
            library_ms=cuda_ms(library), library_ms_b2b=cuda_ms_b2b(library),
            bound_ms=bound_ms, bound_by=bound_by, max_abs_err=0.0,
            split_rows=n_split, chunks=per.numel(),
            longest_row_chunks=int(
                (split.chunk_ptr[1:] - split.chunk_ptr[:-1]).max()),
            H=H, dtype=name)
        log(f"  combine kernel, {n_split} split rows from {per.numel()} "
            f"chunks, H={H} {name}: {row['ms']:.4f} ms (back to back "
            f"{row['ms_b2b']:.4f}; {100 * bound_ms / row['ms']:.1f}% / "
            f"{100 * bound_ms / row['ms_b2b']:.1f}% of the bound), plain "
            f"{row['plain_ms']:.4f} ms, index_add_ {row['library_ms']:.4f} "
            f"ms (back to back {row['library_ms_b2b']:.4f}), bound "
            f"{bound_ms:.4f} ms ({bound_by}); equal to combine_plain and "
            f"to the plain gather")
        del out
    return rows


def powerlaw_edges(V, nnz, seed=0):
    """Edges (src, dst) of a power-law graph of V nodes and nnz edges:
    destinations drawn with Zipf-0.8 weights, so in-degrees are power-law;
    sources uniform; sorted by destination. The generator of
    scripts/bench_edges.py (`powerlaw_graph`), copied, at a given nnz."""
    import numpy as np
    rng = np.random.RandomState(seed)
    w = 1.0 / np.arange(1, V + 1) ** 0.8
    w /= w.sum()
    dst = rng.choice(V, size=nnz, p=w)
    src = rng.randint(0, V, size=nnz)
    order = np.argsort(dst, kind="stable")
    return src[order].astype(np.int32), dst[order].astype(np.int32)


def rowwise_gather(row_ptr, col, x):
    """The packed path's body (csr_gather_kernel, one lane group per row
    over all of H, rows in order) on a rectangular CSR: the kernel that
    `csr_gather` ran before its full-graph body, a yardstick here. Counted
    in no launch count."""
    import torch
    from gmeta_tpu_torch.ops import sized_spmm as sp
    n_rows = row_ptr.numel() - 1
    out = torch.empty((n_rows, x.shape[1]), dtype=x.dtype, device=x.device)
    sp._run_kernel(row_ptr, col, x, out, n_rows, "row-wise")
    return out


class OneStep(Exception):
    """Raised in a resumed fit after its first checkpoint: its one step is
    taken and saved."""


@contextlib.contextmanager
def first_save_stops():
    """Within it, Trainer._save raises OneStep after its first save (after
    the save's barrier, so every rank of a mesh stops there); yields the
    list that receives the trainer."""
    from gmeta_tpu_torch.run.train import Trainer
    save, stopped = Trainer._save, []

    def save_then_stop(self, *args, **kwargs):
        save(self, *args, **kwargs)
        stopped.append(self)
        raise OneStep
    Trainer._save = save_then_stop
    try:
        yield stopped
    finally:
        Trainer._save = save


def one_step_fit(argv):
    """main(argv) resumed from its checkpoint directory and stopped after
    the first step it saves; returns its Trainer."""
    with first_save_stops() as stopped:
        try:
            spy_main(argv)
        except OneStep:
            pass
    trainer, = stopped
    return trainer


def rank_main(out_path, argv, one_step=False):
    """One rank of phase 10(c), started by spawn_ranks: main(argv) with the
    counts set to 0 before it. Writes this rank's theta, kernel launch
    counts, collective seconds and, for the edge engine, its communication
    plan to out_path (npz). With `one_step`, the fit stops after its first
    checkpoint (every rank, after the save's barrier), before evaluating."""
    import numpy as np
    from gmeta_tpu_torch.ops import epilogue as ep
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.parallel import collectives
    launched = counted()
    t0 = time.time()
    if one_step:
        trainer = one_step_fit(argv)
        global_step = trainer.global_step
    else:
        result, trainer = spy_main(argv)
        global_step = result.global_step
    engine = getattr(trainer, "engine", None)
    params = engine.params if engine is not None else trainer.learner.params
    meta = {"rank": int(os.environ["RANK"]), "main_s": time.time() - t0,
            "launches": launched.of(sp.LAUNCHES),
            "csr_launches": launched.of(sp.CSR_LAUNCHES),
            "epilogue_launches": launched.of(ep.LAUNCHES),
            "seconds": launched.of(collectives.SECONDS),
            "calls": launched.of(collectives.CALLS),
            "global_step": global_step,
            "comm": getattr(trainer, "comm", None)}
    np.savez(out_path, meta=json.dumps(meta),
             **{f"theta{i}": p.detach().cpu().numpy()
                for i, p in enumerate(params)})


def spawn_fit(argv, nprocs, tag, one_step=False):
    """Phase 10(c): main(argv) as `nprocs` ranks sharing this card over
    gloo, each in its own process (`rank_main`, one step with
    `one_step`). Returns each rank's (meta, theta) and the wall seconds."""
    import numpy as np
    from gmeta_tpu_torch.parallel.launch import spawn_ranks
    root = Path(__file__).resolve().parent
    out_dir = root / "build" / "chip_smoke_ranks"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(root), OMP_NUM_THREADS="2")
    fresh_card()
    t0 = time.time()
    spawn_ranks([sys.executable, str(root / "chip_smoke.py"),
                 "--one-step-rank" if one_step else "--rank",
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
    """Two checkpointed fits from one initial theta (rank 0's files for a
    mesh), step by step. The first step's gradient (Adam's first moment
    after it, 0.1 x the gradient) must equal the reference's at rtol 1e-5,
    atol `grad_atol` of its largest entry: the same reduction at the same
    params, summed in another order. After step 1 the two fits no longer
    share their params, so their later gradients differ by more than
    rounding; `equal_params_steps` holds those, one step at a time from
    the reference's own checkpoints. Here theta after each step is only
    held within 2 x step x meta_lr, the furthest two Adam runs can move an
    entry apart, a check that a wrong step count or learning rate fails.
    Returns the step-1 gradient's largest difference over its largest
    entry, and per step theta's (max abs, max rel without the head
    bias)."""
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


def _ckpt(d, step):
    """(params, mu, nu, count) of checkpoint `step` in d, as numpy."""
    import numpy as np
    from gmeta_tpu_torch.utils import checkpoint as ckpt
    state = ckpt.restore(str(Path(d) / f"ckpt_{step:08d}.pkl"))
    opt = state["opt_state"]
    return ([np.asarray(x, np.float64) for x in state["params"]],
            [np.asarray(x, np.float64) for x in opt["mu"]],
            [np.asarray(x, np.float64) for x in opt["nu"]],
            int(np.asarray(opt["count"])))


def _resume_dir(ref_dir, name, step):
    """A fresh checkpoint directory holding only the reference's
    checkpoint `step`."""
    d = CKPT10 / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    ckpt = f"ckpt_{step:08d}.pkl"
    shutil.copy(Path(ref_dir) / ckpt, d / ckpt)
    os.symlink(ckpt, d / "latest")
    return d


def equal_params_steps(ref_dir, mesh_argv, chunk_argv, steps, meta_lr):
    """Phase 10(c): the task-DP gradient at equal params, step by step. For
    each step k, from the reference's (a world of one, 32 tasks in one
    batch) checkpoint k - 1, two runs take step k and stop: `mesh_argv` on
    4 gloo ranks (`spawn_fit` one_step; each rank runs 8 tasks in one
    batch), and `chunk_argv`, a world of one in this process that runs the
    same 32 tasks in chunks of 8 (what each rank computes, in turn). Each
    run's gradient is g_k = 10 (mu_k - 0.9 mu_{k-1}) (Adam's first moment,
    b1 = 0.9). The 4 ranks' must equal the chunked world's at rtol 1e-5,
    atol 1e-5 of its largest entry (step 1's tolerances): the task split's
    own sum. Against the reference, whose batch has another shape (and so
    other kernels, rounding otherwise), the 4 ranks' gradient is reported:
    its largest difference over the largest entry, the entries outside
    step 1's tolerances and the columns they lie in, and the same for the
    chunked world. And every run's theta_k must be Adam's step (b2 0.999,
    eps 1e-8) from theta_{k-1} by its own moments, recomputed here in
    float64, to within the float32 rounding of that step (1e-4 of the
    step, 2^-23 of theta): theta parts from the reference only as Adam
    moves the gradients it is given. Returns these numbers per step."""
    import numpy as np
    out = {}
    for k in steps:
        theta0, mu0, _, count0 = _ckpt(ref_dir, k - 1)
        t0 = time.time()
        d = _resume_dir(ref_dir, f"r{k}", k - 1)
        ranks, wall = spawn_fit(mesh_argv + every_step(d), 4, f"r{k}",
                                one_step=True)
        for meta, _ in ranks:
            assert meta["global_step"] == k, meta
        d8 = _resume_dir(ref_dir, f"q{k}", k - 1)
        fresh_card()
        assert one_step_fit(chunk_argv + every_step(d8)).global_step == k
        runs = {"ref": _ckpt(ref_dir, k), "mesh": _ckpt(d, k),
                "chunked": _ckpt(d8, k)}
        grads = {w: [10.0 * (m - 0.9 * m0) for m, m0 in zip(r[1], mu0)]
                 for w, r in runs.items()}
        for w, (theta, mu, nu, count) in runs.items():
            assert count == count0 + 1, (w, count, count0)
            bc1, bc2 = 1 - 0.9 ** count, 1 - 0.999 ** count
            for i, (p, p0, m, v) in enumerate(zip(theta, theta0, mu, nu)):
                u = meta_lr * (m / bc1) / (np.sqrt(v / bc2) + 1e-8)
                # float32: the bias corrections 1 - b^count round to 2^-24
                # absolute, 1e-5 of the step at count >= 2; theta to 2^-24
                assert (np.abs(p - (p0 - u)) <= 1e-4 * np.abs(u)
                        + 2.0**-23 * np.abs(p) + 1e-12).all(), (
                    f"step {k}, {w}: param {i} is not Adam's step by its "
                    f"own moments")

        def parting(got, want):
            scale = max(float(np.abs(g).max()) for g in want)
            far = [np.abs(x - y) > 1e-5 * np.abs(y) + 1e-5 * scale
                   for x, y in zip(got, want)]
            worst = int(np.argmax([f.sum() for f in far]))
            cols = (np.unique(np.nonzero(far[worst])[-1]).tolist()
                    if far[worst].ndim > 1 else [])
            return {"grad": max(float(np.abs(x - y).max()) for x, y in
                                zip(got, want)) / scale,
                    "entries_outside": int(sum(f.sum() for f in far)),
                    "param": worst, "columns": cols[:16]}
        split = parting(grads["mesh"], grads["chunked"])
        assert split["entries_outside"] == 0, (
            f"step {k}: the 4 ranks' gradient at equal params is not the "
            f"chunked world's: {split}")
        out[k] = {"mesh_vs_chunked": split,
                  "mesh_vs_ref": parting(grads["mesh"], grads["ref"]),
                  "chunked_vs_ref": parting(grads["chunked"], grads["ref"]),
                  "theta_mesh_vs_ref": max(
                      float(np.abs(x - y).max())
                      for x, y in zip(runs["mesh"][0], runs["ref"][0])),
                  "wall_s": wall, "step_s": time.time() - t0}
        shutil.rmtree(d, ignore_errors=True)
        shutil.rmtree(d8, ignore_errors=True)
        log(f"  (c) step {k} from (a)'s step {k - 1}: {out[k]}")
    return out


POWER_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_powerlaw"
# (b) on the power-law graph: (c)'s depth cut
POWER_CUT = [str(POWER_DIR) if f == str(DATA_DIR) else f for f in EDGE_CUT]


def prepare_powerlaw_dir(V, nnz, seed=0):
    """10(b): a power-law graph of V nodes and nnz edges
    (`powerlaw_edges`; in-degrees Zipf, so the forward CSR has rows of tens
    of thousands of edges), random features (128) and labels (15 classes)
    from the seed, written by prepare_node_disjoint. Returns seconds."""
    import numpy as np
    from gmeta_tpu_torch.data.graph import CSRGraph
    from gmeta_tpu_torch.data.prepare import prepare_node_disjoint
    t0 = time.time()
    shutil.rmtree(POWER_DIR, ignore_errors=True)
    src, dst = powerlaw_edges(V, nnz, seed)
    rng = np.random.RandomState(seed)
    prepare_node_disjoint(str(POWER_DIR), [CSRGraph.from_edges(src, dst, V)],
                          [rng.randn(V, 128).astype(np.float32)],
                          [rng.randint(0, 15, V)], num_label_set=3,
                          seed=seed)
    return time.time() - t0


def mesh_phase(device, plain9):
    """Phase 10. Returns (summary, packed launches, rectangular launches,
    combine launches, the rectangular entry point's timing)."""
    import torch
    from gmeta_tpu_torch.parallel.edgepart_train import EdgePartTask
    t0 = time.time()
    packed = {"fwd": 0, "bwd": 0}
    rect = {"fwd": 0, "bwd": 0}
    combine = {"fwd": 0, "bwd": 0}

    def add(counts, run):
        for k in counts:
            counts[k] += run[k]

    shutil.rmtree(CKPT10, ignore_errors=True)

    # (a) task-DP on a world of one (NCCL, in this process) = phase 9's fit;
    # theta after every step is kept for (c)
    a = cli_fit(False, DATA_DIR / "metrics_10a.jsonl", device,
                extra=["--mesh_tasks", "1"] + every_step(CKPT10 / "a"))
    add(packed, a["launches"])
    a_diff = max_rel(a["theta"], plain9["theta"])
    if a_diff[0] != 0.0:
        assert_theta_close(a["theta"], plain9["theta"], 1e-6, 6, 1e-3,
                           "10a vs phase 9")
    log(f"  (a) --mesh_tasks 1: warm {a['warm_tasks_per_s']:.2f} tasks/s "
        f"against phase 9's {plain9['warm_tasks_per_s']:.2f}; theta vs "
        f"phase 9 (max abs, max rel) {a_diff}")

    # (b) the edge-partitioned engine at full width on a world of one
    b, trainer = edge_fit(EDGE_FULL, DATA_DIR / "metrics_10b.jsonl", device)
    add(rect, b["csr_launches"])
    assert not any(b["combine_launches"].values()), b   # no row is split
    log(f"  (b) --mesh_edges 1, arxiv widths: {b['main_s']:.1f} s, steps "
        f"{[round(x, 3) for x in b['step_s']]} s, warm "
        f"{b.get('warm_tasks_per_s', float('nan')):.2f} tasks/s, peak "
        f"{b['peak_gb']:.2f} GB, csr_gather launches {b['csr_launches']}, "
        f"comm {b['comm']}; theta sha256 {b['theta_sha256']}")
    train = trainer.tasks["train"]
    first = EdgePartTask(*(a[:trainer.cfg.task_num] for a in train))
    b["profile"] = profile_step(
        lambda: trainer.engine.train_step(first)["meta_loss"])
    pair = trainer.engine._shard.local
    del trainer
    fresh_card()
    timing, combine_row, shapes = time_rect(pair, device)
    n_nodes, nnz = pair.row_ptr.numel() - 1, pair.col.numel()
    del pair
    fresh_card()

    # (b) on a power-law graph of the same size: its split rows run the
    # combine kernel; the depth cut as in (c)
    prep_s = prepare_powerlaw_dir(170_000, nnz)
    power, _ = edge_fit(POWER_CUT, POWER_DIR / "metrics.jsonl", device)
    shutil.rmtree(POWER_DIR, ignore_errors=True)
    add(rect, power["csr_launches"])
    add(combine, power["combine_launches"])
    assert power["combine_launches"]["fwd"] > 0, power
    log(f"  (b) power-law graph (170,000 nodes, {nnz} edges, prepared in "
        f"{prep_s:.1f} s), --mesh_edges 1, depth cut: {power['main_s']:.1f}"
        f" s, steps {[round(x, 3) for x in power['step_s']]} s, peak "
        f"{power['peak_gb']:.2f} GB, csr_gather launches "
        f"{power['csr_launches']}, combine launches "
        f"{power['combine_launches']}")
    fresh_card()

    # (c) several ranks on this one card over gloo, each its own process
    packed_flags = ["--preset", "arxiv", "--data_dir", str(DATA_DIR),
                    "--agg", "sized", "--extractor", "native", "--batchsz",
                    "192", "--eval_batchsz", "48", "--epoch", "1",
                    "--dtype", "float32", "--update_step_test", "2"]
    tasks_argv = packed_flags + [
        "--metrics_path", str(DATA_DIR / "metrics_10c.jsonl"),
        "--mesh_tasks", "4", *SHARED_CARD]
    ranks, wall = spawn_fit(tasks_argv + every_step(CKPT10 / "c"), 4,
                            "tasks")
    for meta, _ in ranks:
        assert meta["global_step"] == 6, meta
        assert all(v > 0 for v in meta["launches"].values()), meta
        add(packed, meta["launches"])
    c_steps = compare_steps(CKPT10 / "c", CKPT10 / "a", 1e-3,
                            "10c task-DP vs 10a")
    log(f"  (c) --mesh_tasks 4, 4 gloo ranks: {wall:.1f} s; vs (a): {c_steps}"
        f"; launches by rank "
        f"{[m['launches'] for m, _ in ranks]}; all-reduce s by rank "
        f"{[round(m['seconds']['all_reduce'], 3) for m, _ in ranks]}")
    # every later step at equal params: resumed from (a)'s checkpoints
    chunk_argv = packed_flags + [
        "--metrics_path", str(DATA_DIR / "metrics_10c8.jsonl"),
        "--task_vmap_chunk", "8"]
    equal = equal_params_steps(CKPT10 / "a", tasks_argv, chunk_argv,
                               range(2, 7), 1e-3)
    c_tasks = {"wall_s": wall, "vs_a": c_steps, "equal_params": equal,
               "ranks": [m for m, _ in ranks]}

    one, _ = edge_fit(EDGE_CUT + every_step(CKPT10 / "e1"),
                      DATA_DIR / "metrics_10c1.jsonl", device)
    add(rect, one["csr_launches"])
    ranks, wall = spawn_fit(EDGE_CUT + [
        "--mesh_tasks", "2", "--mesh_edges", "2", "--metrics_path",
        str(DATA_DIR / "metrics_10c2.jsonl"), *SHARED_CARD,
        *every_step(CKPT10 / "e4")], 4, "edges")
    for meta, _ in ranks:
        assert meta["global_step"] == one["result"]["global_step"], meta
        assert all(v > 0 for v in meta["csr_launches"].values()), meta
        assert not any(meta["launches"].values()), meta
        add(rect, meta["csr_launches"])
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
                                "peak_gb", "launches", "theta_sha256")},
        "a_theta_diff": a_diff,
        "phase9_warm_tasks_per_s": plain9["warm_tasks_per_s"],
        "b": {k: b[k] for k in b if k != "theta"},
        "b_powerlaw": {k: power[k] for k in power if k != "theta"},
        "c_tasks": c_tasks,
        "c_edges": {"wall_s": wall, "vs_world1": e_steps,
                    "world1_s": one["main_s"],
                    "ranks": [m for m, _ in ranks]},
        "phase_s": time.time() - t0}
    torch.cuda.empty_cache()
    return summary, packed, rect, combine, (timing, combine_row, shapes)

# ---- phase 11: parity from the runs of record's checkpoints; the entry points

REPLICAS = Path(__file__).resolve().parent / "build" / "chip_smoke_replicas"
RECORDS = Path(__file__).resolve().parent / "parity"
PARITY_RECIPES = ("fold_ppi", "firstmm_db", "tissue_ppi")


def eval_parity(name, device):
    """One recipe of phase 11 through the runner's `eval_from`: its replica
    made here and held against the checkpoint's DATASET marker, then the
    dual final test from the run of record's completed checkpoint on the
    full test set, with the record's aggregation and then with
    agg="sized", held at the runner's EVAL_BOUNDS against the JAX
    package's CPU evaluation of the same checkpoint
    (parity_torch/<recipe>.eval_cpu_jax.json), the TPU record and each
    other. Kernel launch counts are set to 0 just before and read just
    after; only the sized pass may launch, and it must launch both
    directions."""
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.run import parity
    import torch

    rec_agg = parity.record(name)["agg"]
    assert rec_agg != "sized", rec_agg
    with counted() as c:
        out = parity.eval_from(name, str(RECORDS / f"{name}.ckpt"),
                               str(REPLICAS), device=device)
    launches = c.of(sp.LAUNCHES)
    assert out["checked"] and out["jax_cpu_acc"] is not None, out["recipe"]
    assert list(out["passes"]) == [rec_agg, "sized"], list(out["passes"])
    assert not any(out["passes"][rec_agg]["launches"].values()), out
    assert launches == out["passes"]["sized"]["launches"], launches
    assert launches["fwd"] > 0 and launches["bwd"] > 0, launches
    for agg, res in out["passes"].items():
        assert res["agg"] == agg, res["agg"]
        # every task's accuracy equal, up to float32 rounding of the mean
        same = res["max_task_diff"] < out["one_query"] / 2
        log(f"  {name} {agg}: {json.dumps(res['acc'])}; vs JAX CPU "
            f"{json.dumps(res['vs_jax_cpu'])}; max per-task diff "
            f"{res['max_task_diff']:.4f} (one query "
            f"{out['one_query']:.4f}; task for task: "
            f"{'yes' if same else 'no'}); {res['eval_s']:.1f} s; "
            f"launches {res['launches']}")
        del res["curves_last"], res["curves_best"]
    gc.collect()
    torch.cuda.empty_cache()
    return out


def entry_phase(device):
    """The driver entry points: entry()'s function on the card against the
    same function on the CPU from the same params, then
    dryrun_multichip(4) as a user calls it, with no device named: its
    ranks share this card over gloo."""
    import torch
    from gmeta_tpu_torch import entry

    fn, (params, task, feats) = entry.entry(device)
    got = [x.item() for x in fn(params, task, feats)]
    _, (_, task_c, feats_c) = entry.entry("cpu")
    want = [x.item() for x in fn(tuple(p.cpu() for p in params), task_c,
                                 feats_c)]
    assert all(math.isfinite(x) for x in got), got
    err = max(abs(a - b) for a, b in zip(got, want))
    assert all(math.isclose(a, b, rel_tol=1e-5, abs_tol=1e-6)
               for a, b in zip(got, want)), (got, want)
    log(f"  entry(): card {got}, cpu {want}")
    t0 = time.time()
    dry = entry.dryrun_multichip(4, timeout=300.0)
    assert dry["backend"] == "gloo" and dry["loaded"] == [], dry
    assert dry["device"] == f"cuda:{device.index or 0}", dry["device"]
    csr = dry["launches"]["csr"]
    assert csr["fwd"] > 0 and csr["bwd"] > 0, dry["launches"]
    dry["wall_s"] = time.time() - t0
    torch.cuda.empty_cache()
    return {"card": got, "cpu": want, "max_abs_diff": err}, dry


def parity_phase(device):
    """Phase 11: evaluation parity for the three recipes with completed
    checkpoints, then the entry points. Returns the phase's summary and
    its kernel launches (the sized passes' and the dry run's ranks')."""
    t0 = time.time()
    shutil.rmtree(REPLICAS, ignore_errors=True)
    try:
        recipes = {name: eval_parity(name, device) for name in PARITY_RECIPES}
    finally:
        shutil.rmtree(REPLICAS, ignore_errors=True)
    misses = [m for r in recipes.values() for m in r["misses"]]
    if misses:
        raise AssertionError("evaluation parity out of bounds:\n  "
                             + "\n  ".join(misses))
    ent, dry = entry_phase(device)
    packed = {d: sum(r["passes"]["sized"]["launches"][d]
                     for r in recipes.values())
              for d in ("fwd", "bwd")}
    summary = {"recipes": recipes, "entry": ent, "dryrun_multichip": dry,
               "phase_s": time.time() - t0}
    return summary, packed, dry["launches"]


MEASURE = Path(__file__).resolve().parent / "build" / "chip_smoke_measure"
TOL_PREFIX = 64          # graphs of the Tree-of-Life-shaped prefix


def run_script(name, argv):
    """One measurement script's main() in this process on the card, its
    printed lines caught: the JSON line must hold the result, and the
    markdown table is logged. Returns (result, seconds)."""
    import importlib
    mod = importlib.import_module(f"gmeta_tpu_torch.scripts.{name}")
    buf = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stdout(buf):
        result = mod.main(["--device", "cuda", "--out",
                           str(MEASURE / f"{name}.json")] + argv)
    seconds = time.time() - t0
    lines = buf.getvalue().splitlines()
    printed = [json.loads(x) for x in lines if x.startswith("{")]
    assert printed == [json.loads(json.dumps(result))], name
    for x in lines:
        if not x.startswith("{"):
            log(f"  {x}")
    log(f"  {name} {' '.join(argv)}: {seconds:.1f} s")
    return result, seconds


def measure_phase():
    """Phase 12: the measurement scripts (gmeta_tpu_torch/scripts/), each
    main() at a cut size: bench_kernels at the five records' buckets with
    one task each, bench_pallas_spmm, bench_transfer (2 reps), bench_edges
    at 2^19 nodes, and bench_edgepart on a Tree-of-Life-shaped replica of
    TOL_PREFIX graphs made here (the ToL recipe's per-graph parameters:
    ToL's rows, not the full replica's size; removed after). Each script
    holds every path against its plain version and raises on a miss.
    Launch counts are set to 0 just before and read just after; the packed
    kernel (both directions), the full-graph body (both) and the combine
    kernel must have launched. Returns (summary, launches)."""
    from gmeta_tpu_torch.data import replicas
    from gmeta_tpu_torch.ops import sized_spmm as sp
    import torch

    t0 = time.time()
    shutil.rmtree(MEASURE, ignore_errors=True)
    launched = counted()
    res, secs = {}, {}
    try:
        res["bench_kernels"], secs["bench_kernels"] = run_script(
            "bench_kernels", ["--tasks", "1", "--iters", "10"])
        res["bench_pallas_spmm"], secs["bench_pallas_spmm"] = run_script(
            "bench_pallas_spmm", ["--iters", "10"])
        res["bench_transfer"], secs["bench_transfer"] = run_script(
            "bench_transfer", ["--reps", "2"])
        res["bench_edges"], secs["bench_edges"] = run_script(
            "bench_edges", ["19", "8", "--iters", "1"])
        t1 = time.time()
        tol = MEASURE / "tree_of_life"
        replicas.make_tree_of_life(str(tol), n_graphs=TOL_PREFIX)
        log(f"  Tree-of-Life-shaped replica of {TOL_PREFIX} graphs made in "
            f"{time.time() - t1:.1f} s")
        res["bench_edgepart"], secs["bench_edgepart"] = run_script(
            "bench_edgepart", ["--data", str(tol), "--graphs",
                               str(TOL_PREFIX)])
    finally:
        shutil.rmtree(MEASURE, ignore_errors=True)
    launches = {"packed": launched.of(sp.LAUNCHES),
                "csr": launched.of(sp.CSR_LAUNCHES),
                "combine": launched.of(sp.COMBINE_LAUNCHES)}
    for kind in ("packed", "csr"):
        assert all(launches[kind].values()), launches
    assert launches["combine"]["fwd"] > 0, launches
    buckets = res["bench_kernels"]["buckets"]
    assert len(buckets) == 10, list(buckets)
    ep = res["bench_edgepart"]
    assert ep["graphs"] == TOL_PREFIX and ep["value"] > 0, ep
    assert math.isclose(ep["value"], ep["tasks_per_s"] * ep["edges"]), ep
    tr = res["bench_transfer"]
    summary = {
        "seconds": secs, "phase_s": time.time() - t0,
        "kernels_winner_f32": {k: r["winner_f32_fwd"]
                               for k, r in buckets.items()},
        "kernels_max_abs_err": {k: r["max_abs_err"]
                                for k, r in buckets.items()},
        "pallas_spmm": {t: res["bench_pallas_spmm"][t]
                        for t in ("f32", "bf16")},
        "transfer": {k: tr[k] for k in (
            "pack_s", "transfer_pageable_s", "transfer_pinned_s",
            "transfer_window_s", "step_pool_s", "step_stream_s")},
        "edges": {k: v for k, v in res["bench_edges"].items()
                  if k.startswith(("segment", "ell", "csr_gather"))},
        "edgepart": {k: ep[k] for k in ("graphs", "nodes", "edges",
                                        "step_s", "value", "peak_gb")},
        "launches": launches}
    torch.cuda.empty_cache()
    return summary, launches


# ---- phase 13: the replica calibrators -------------------------------------

CAL = Path(__file__).resolve().parent / "build" / "chip_smoke_cal"
PROXY_TOL = 0.002   # a proxy against the plain run's and the JAX script's


def checked_hop(errs):
    """calibrate_replicas' hop through the kernel, each call held against
    csr_plain on the same input within `rounding_bound`; appends each
    call's largest difference to errs."""
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.scripts.calibrate_replicas import hop_gather

    def gather(pair, h):
        got = hop_gather(pair, h)
        want = sp.csr_plain(pair.row_ptr, pair.col, h)
        err = (got - want).abs()
        over = err - rounding_bound(pair.row_ptr, pair.col, h)
        assert float(over.max()) <= 0.0, (
            f"a hop parts from csr_plain by {float(err.max())}, past the "
            f"rounding bound by {float(over.max())}")
        errs.append(float(err.max()))
        return got
    return gather


def proxies(device):
    """13(a): the five proxies with the kernel, then through csr_plain on
    the card. Returns (rows, launches of the kernel run)."""
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.scripts import calibrate_replicas as cr

    errs = []
    with counted() as c:
        got = cr.run(list(cr.RECIPE_PROXIES), device,
                     gather=checked_hop(errs))
    launches = {"csr": c.of(sp.CSR_LAUNCHES),
                "combine": c.of(sp.COMBINE_LAUNCHES)}
    with counted() as c:
        plain = cr.run(list(cr.RECIPE_PROXIES), device,
                       gather=lambda pair, h: sp.csr_plain(pair.row_ptr,
                                                           pair.col, h))
    assert not any(c.of(sp.CSR_LAUNCHES).values()), c.of(sp.CSR_LAUNCHES)
    graphs = sum(r["graphs"] for r in got.values())
    split = sum(r["split_rows"] for r in got.values())
    assert launches["csr"]["fwd"] == 2 * graphs, (launches, graphs)
    assert launches["combine"]["fwd"] == 2 * sum(
        r["graphs"] for r in got.values() if r["split_rows"]), launches
    rows = {}
    for name, r in got.items():
        p = plain[name]
        vals = (r["proto"], r["lda"])
        for ref, what in (((p["proto"], p["lda"]), "csr_plain"),
                          (r["jax_cpu"], "the JAX script")):
            assert all(abs(a - b) <= PROXY_TOL for a, b in zip(vals, ref)), (
                f"{name}: {vals} against {what}'s {ref}")
        rows[name] = {**r, "plain": [p["proto"], p["lda"]],
                      "plain_seconds": p["seconds"]}
        log(f"  {name}: proto {r['proto']:.4f} lda {r['lda']:.4f} (plain "
            f"{p['proto']:.4f} {p['lda']:.4f}; JAX {r['jax_cpu'][0]:.4f} "
            f"{r['jax_cpu'][1]:.4f}); {r['seconds']:.2f} s (plain "
            f"{p['seconds']:.2f} s); {r['graphs']} graphs, {r['edges']} "
            f"edges, {r['split_rows']} split rows")
    log(f"  {len(errs)} hops, largest difference from csr_plain "
        f"{max(errs):.3g}, all within the rounding bound; {split} split "
        f"rows; launches {launches}")
    return rows, max(errs), launches


def calibrate_phase(device):
    """Phase 13: (a) the proxies; (b) one probe row of calibrate_link
    firstmm_db with --agg sized. Returns (summary, launches)."""
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.scripts import calibrate_link
    import torch

    t0 = time.time()
    rows, max_err, launches = proxies(device)
    a_s = time.time() - t0
    shutil.rmtree(CAL, ignore_errors=True)
    launched = counted()
    t1 = time.time()
    try:
        link = calibrate_link.main([
            "firstmm_db", "--noises", "0.30", "--betas", "3.5", "--probe",
            "--agg", "sized", "--device", "cuda", "--out", str(CAL)])
        sweep = json.loads((CAL / "firstmm_db_sweep.json").read_text())
        res = json.loads((CAL / "res_firstmm_db_n0.30_b3.50"
                          / "firstmm_db.json").read_text())
    finally:
        shutil.rmtree(CAL, ignore_errors=True)
    packed = launched.of(sp.LAUNCHES)
    assert packed["fwd"] > 0 and packed["bwd"] > 0, packed
    launches["packed"] = packed
    (row,) = link
    assert sweep["rows"] == link and sweep["target"] == 0.769, sweep
    assert list(row) == ["noise", "beta", "final", "best", "ref_style"], row
    assert all(math.isfinite(row[k]) and 0.0 <= row[k] <= 1.0
               for k in ("final", "best", "ref_style")), row
    assert res["agg"] == "sized" and res["init_from_jax"], res["agg"]
    log(f"  calibrate_link firstmm_db probe row {row}; {res['tasks_per_s']}"
        f" tasks/s, wall {res['wall_s']}; {time.time() - t1:.1f} s; packed "
        f"launches {packed}")
    summary = {"proxies": rows, "max_abs_err": max_err, "proxies_s": a_s,
               "link_row": row, "link_tasks_per_s": res["tasks_per_s"],
               "link_wall_s": res["wall_s"], "launches": launches,
               "phase_s": time.time() - t0}
    torch.cuda.empty_cache()
    return summary, launches


# ---- phase 14: the throughput benchmark; the shared-adjacency call ---------

SHARED_TASKS = (3, 32)   # tasks sharing one adjacency, the timed widths
SHARED_H = 256


def densify_check(data, name, chunk=8):
    """14(a): `densify` of a shape's whole pool, `chunk` tasks at a time,
    in the host form (pad edges src 0, dst B*P-1) and as the compact pool
    decodes it on the card (pads src (B-1)*P), float32 and bf16, under
    torch.cuda.set_sync_debug_mode("error") (a host sync raises), bitwise
    equal to `densify_serial` (the form that scattered every pad into one
    cell). Returns the number of adjacencies compared."""
    import numpy as np
    import torch
    from gmeta_tpu_torch.meta.maml import MetaLearner
    from gmeta_tpu_torch.ops.spmm import densify
    from gmeta_tpu_torch.scripts.bench_kernels import (densify_serial,
                                                       same_bits)
    checked = 0
    for sg in (data.tasks.spt, data.tasks.qry):
        B, P = sg.node_gid.shape[-2:]
        leaves, meta = MetaLearner._encode_set_leaves(sg)
        for lo in range(0, sg.edge_src.shape[0], chunk):
            host = [torch.from_numpy(np.ascontiguousarray(a[lo:lo + chunk]))
                    .cuda() for a in (sg.edge_src, sg.edge_dst,
                                      sg.edge_mask)]
            dec = MetaLearner._build_set(
                [torch.from_numpy(l[lo:lo + chunk]).cuda() for l in leaves],
                meta)
            for edges in (host, (dec.edge_src, dec.edge_dst,
                                 dec.edge_mask)):
                for dtype in (torch.float32, torch.bfloat16):
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        A = densify(*edges, B, P, dtype=dtype)
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                    assert same_bits(A, densify_serial(*edges, B, P,
                                                       dtype=dtype)), \
                        (name, B, P, lo, dtype)
                    checked += 1
                    del A
    return checked


def bench_phase(device):
    """14(a): gmeta_tpu_torch/bench.py's `bench_shape` on the five shapes
    at full width and the record's geometry, the record's aggregation and
    agg="sized" in turns; launch counts set to 0 just before each sized run
    and read just after (the packed kernel must launch both ways in every
    shape, in bf16, and forward in float32 exactly where layer 1
    aggregates first: feat <= hidden). Finite tasks/s, 0 < mfu <= 1, and
    the first meta-step's loss under sized equal to the record
    aggregation's within TOLS["bfloat16"] (only the first: 16 bf16 Adam
    steps may part by rounding alone). Then the extraction bench. Returns
    (summary, launches, arxiv's data)."""
    from gmeta_tpu_torch import bench
    from gmeta_tpu_torch.ops import sized_spmm as sp
    import torch

    rtol, atol = TOLS["bfloat16"]
    shapes, launches, arxiv = {}, {"fwd": 0, "bwd": 0}, None
    by_dtype = {t: {"fwd": 0, "bwd": 0} for t in sp.LAUNCHES_BY_DTYPE}
    for name, s in bench.SHAPES.items():
        data = bench.shape_data(name, s)
        meta = bench.REPLICA_META[name]
        auto = auto_choices(
            bench.record_geometry(bench._load_parity(name)),
            bench.shape_spec(s, meta["feat"], meta["n_out"]), "bfloat16")
        t0 = time.time()
        n_dense = densify_check(data, name)
        log(f"  {name}: auto resolves to {auto['card']} on the card, "
            f"{auto['cpu']} on the CPU ({auto['edges_per_slot']:.4f} real "
            f"edges per slot, crossover {auto['crossover']:.2f}); densify "
            f"bitwise equal to densify_serial with no host sync on "
            f"{n_dense} adjacencies ({time.time() - t0:.1f} s)")
        rec = bench.bench_shape(name, s, device=device, data=data)
        with counted() as c:
            sized = bench.bench_shape(name, s, agg="sized", device=device,
                                      data=data)
        got = c.of(sp.LAUNCHES)
        split = {t: c.of(v) for t, v in sp.LAUNCHES_BY_DTYPE.items()}
        assert got["fwd"] > 0 and got["bwd"] > 0, (name, got)
        assert all(split["bfloat16"].values()), (name, split)
        # layer 1 aggregates first where it does not shrink the width
        # (models/gcn.py); its float32 input gets no gradient
        f32 = split["float32"]
        if s["feat"] <= s["hidden"]:
            assert f32["fwd"] > 0 and f32["bwd"] == 0, (name, split)
        else:
            assert f32 == {"fwd": 0, "bwd": 0}, (name, split)
        for k in launches:
            launches[k] += got[k]
            for t in by_dtype:
                by_dtype[t][k] += split[t][k]
        for r in (rec, sized):
            assert math.isfinite(r["tasks_per_s"]) and r["tasks_per_s"] > 0, r
            assert r["mfu"] is not None and 0.0 < r["mfu"] <= 1.0, r
        assert rec["flops_per_step"] == sized["flops_per_step"], (rec, sized)
        a, b = sized["meta_loss_first"], rec["meta_loss_first"]
        assert abs(a - b) <= atol + rtol * abs(b), (name, a, b)
        shapes[name] = dict(rec, sized=sized, sized_launches=got,
                            sized_launches_by_dtype=split, auto=auto,
                            densify_checked=n_dense)
        busy = [None if r["profile"] is None else
                round(r["profile"]["busy_share"], 3) for r in (rec, sized)]
        log(f"  {name}: {rec['agg']} {rec['tasks_per_s']:.2f} tasks/s "
            f"(step {rec['step_s']:.4f} s, mfu {rec['mfu']:.5f}, peak "
            f"{rec['peak_gb']:.2f} GB, compile {rec['compile_s']:.2f} s); "
            f"sized {sized['tasks_per_s']:.2f} tasks/s (step "
            f"{sized['step_s']:.4f} s, mfu {sized['mfu']:.5f}, peak "
            f"{sized['peak_gb']:.2f} GB); {rec['flops_per_step']:.4g} "
            f"FLOPs a step, useful {rec['useful_flops']:.4g}; first "
            f"meta-loss {b:.6f} / {a:.6f}; device busy {busy}; launches "
            f"{got}, by dtype {split}")
        if name == "arxiv":
            arxiv = data
        del data
        torch.cuda.empty_cache()
    t0 = time.time()
    extraction = bench.bench_extraction(device)
    log(f"  extraction {extraction} ({time.time() - t0:.1f} s)")
    return ({"shapes": shapes, "extraction": extraction,
             "launches_by_dtype": by_dtype}, launches, arxiv)


def shared_phase(arxiv, device):
    """14(b): `aggregate_sized_shared` on task 0's query set of the bench's
    arxiv pool (the record's buckets), H = SHARED_H. Driven once at T = 3,
    forward and backward, launch counts set to 0 just before and read just
    after: one launch each way. Then, for T in SHARED_TASKS, float32 and
    bf16, held against sized_plain (TOLS) and bitwise against T launches,
    forward and gradient; and timed in float32 against the T launches,
    the plain version and torch.sparse.mm (on h laid out as rows of T * H
    beforehand), beside `gather_bound` at width T * H. Returns (the
    kernels line's fields, launches)."""
    import numpy as np
    import torch
    from gmeta_tpu_torch.ops import sized_spmm as sp

    qry = arxiv.tasks.qry
    B, P = qry.node_gid.shape[-2:]
    N = B * P
    edges = [torch.from_numpy(np.ascontiguousarray(getattr(qry, f)[0]))
             .to(device) for f in ("edge_src", "edge_dst", "edge_mask")]
    graph = sp.sized_graph(*edges, B, P)
    nnz = int(graph.row_ptr[-1])
    row_ptr, col = graph.csr("fwd")
    read_rows = torch.unique(col[:nnz]).numel()
    g = torch.Generator(device=device).manual_seed(0)

    def draw(T, dtype):
        return torch.randn(T, B, P, SHARED_H, device=device,
                           generator=g).to(dtype)

    with counted() as c:
        h = draw(SHARED_TASKS[0], torch.float32).requires_grad_(True)
        out = sp.aggregate_sized_shared(graph, h)
        out.backward(torch.ones_like(out))
        torch.cuda.synchronize()
    launches = c.of(sp.LAUNCHES)
    assert launches == {"fwd": 1, "bwd": 1}, launches
    del h, out

    errs, rows = {"float32": 0.0, "bfloat16": 0.0}, {}
    for T in SHARED_TASKS:
        for dtype in (torch.float32, torch.bfloat16):
            tag = str(dtype).replace("torch.", "")
            h = draw(T, dtype).requires_grad_(True)
            got = sp.aggregate_sized_shared(graph, h)
            want = sp.sized_plain(row_ptr, col, h.detach())
            rtol, atol = TOLS[tag]
            torch.testing.assert_close(got, want, rtol=rtol, atol=atol)
            errs[tag] = max(errs[tag],
                            (got.float() - want.float()).abs().max().item())
            w = draw(T, dtype)
            (grad,) = torch.autograd.grad(got, h, w)
            for t in range(T):
                assert torch.equal(got[t], sp.launch("fwd", graph,
                                                     h[t].detach()))
                assert torch.equal(grad[t], sp.launch("bwd", graph, w[t]))
            del got, want, grad, w
            if dtype != torch.float32:
                continue
            x = h.detach()
            sparse = torch.sparse_csr_tensor(
                row_ptr, col[:nnz], torch.ones(nnz, device=device),
                size=(N, N), check_invariants=False)
            wide = x.permute(1, 2, 0, 3).reshape(N, T * SHARED_H)
            torch.testing.assert_close(      # the yardstick's function
                torch.sparse.mm(sparse, wide).view(B, P, T, SHARED_H)
                .permute(2, 0, 1, 3), sp.aggregate_sized_shared(graph, x),
                rtol=rtol, atol=atol)
            row = timed_row(lambda: sp.aggregate_sized_shared(graph, x),
                            lambda: sp.sized_plain(row_ptr, col, x),
                            lambda: torch.sparse.mm(sparse, wide),
                            nnz, T * SHARED_H, read_rows, N)
            row["separate_ms"] = cuda_ms(
                lambda: [sp.launch("fwd", graph, x[t]) for t in range(T)])
            rows[T] = row
            log(f"  shared T={T} H={SHARED_H}: {row['ms']:.3f} ms, {T} "
                f"launches {row['separate_ms']:.3f} ms, plain "
                f"{row['plain_ms']:.3f} ms, torch.sparse.mm "
                f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
                f"({row['bound_by']})")
            del x, sparse, wide
        torch.cuda.empty_cache()
    head = rows[SHARED_TASKS[0]]
    fields = {"max_abs_err": errs["float32"],
              "max_abs_err_bf16": errs["bfloat16"],
              **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")},
              "separate_ms": head["separate_ms"],
              "shape": f"S={B} P={P} nnz={nnz} shared by T="
                       f"{SHARED_TASKS[0]} H={SHARED_H} float32",
              "by_T": {str(T): r for T, r in rows.items()}}
    return fields, launches


# GAT_SETS: the gat_ppi.pool cell's sets, (bins, real edges a task, edge
# slots, centers) at P = 1024 slots with 586 live a bin (benchmark/configs/
# gat_ppi.json's buckets and fill, bench_gat.SHAPES's real edges)
GAT_P, GAT_LIVE, GAT_ROWS = 1024, 586, 56944
GAT_SETS = {"spt": (6, 36146, 51200, 6), "qry": (16, 99763, 141312, 20)}


def gat_set(rng, T, B, E_real, E, S):
    """T tasks' packed SubgraphSet (numpy, leading task axis) at P =
    GAT_P: GAT_LIVE live slots a bin, each with an in-edge, the rest of
    the E_real real edges at random live destinations, sources in the
    destination's bin; then pad edges (src 0, dst B*P-1, mask 0) to E
    slots, as the packer leaves them. Center k sits at slot k // B of bin
    k % B, its label k % 2."""
    import numpy as np

    from gmeta_tpu_torch.data.pack import SubgraphSet
    P, live = GAT_P, GAT_LIVE
    first = np.arange(B * live)
    first = np.broadcast_to(first // live * P + first % live, (T, B * live))
    rest = E_real - B * live
    dst = np.concatenate([first, rng.integers(0, B, (T, rest)) * P
                          + rng.integers(0, live, (T, rest))], 1)
    src = dst // P * P + rng.integers(0, live, (T, E_real))
    order = np.argsort(dst, axis=1, kind="stable")
    dst, src = (np.take_along_axis(a, order, 1) for a in (dst, src))
    pad = E - E_real
    k = np.arange(S)
    centers = np.broadcast_to((k % B * P + k // B)[:, None], (T, S, 2))
    return SubgraphSet(
        node_gid=rng.integers(0, GAT_ROWS, (T, B, P)).astype(np.int32),
        node_mask=np.broadcast_to((np.arange(P) < live).astype(np.float32),
                                  (T, B, P)).copy(),
        edge_src=np.pad(src, ((0, 0), (0, pad))).astype(np.int32),
        edge_dst=np.pad(dst, ((0, 0), (0, pad)),
                        constant_values=B * P - 1).astype(np.int32),
        edge_mask=np.pad(np.ones((T, E_real), np.float32), ((0, 0), (0, pad))),
        centers=centers.astype(np.int32).copy(),
        labels=np.broadcast_to(k % 2, (T, S)).astype(np.int32).copy(),
        bin_fill=np.full((T, B), live, np.int32))


def check_gat(device):
    """Phase 15(a): the wrapper `attend` and the autograd Function on the
    card against `fwd_plain` and `bwd_plain` at the cell's set shapes
    (bench_gat.SHAPES: 16 tasks x 16 or 6 bins x 1024 slots, repacked
    into one bin of M rows a task as the CSR path runs them, each
    original bin's rows a segment) and both head widths (4 x 256, 16-byte
    copies; 6 x 121, 4-byte ones): one forward and three backward
    launches a call, all staged, and the staged forward's o and lse the
    walk kernel's bits; o, and the gradient of
    zst's z, s and t, within rtol 1e-4 and atol 2e-5 of each tensor's
    largest magnitude (float32 sums of a row's ~11 terms, and of F
    products, in another order; g . z - D cancels). A row averages ~11
    terms of unit scale, so a kernel that dropped or doubled one of them,
    or took the wrong slope, errs by percents of the scale, three orders
    over the tolerance. Returns {set heads: max abs error over
    scale, by tensor}."""
    import torch

    from gmeta_tpu_torch.ops import gat_attention as ga
    from gmeta_tpu_torch.scripts.bench_gat import (HEADS, SHAPES,
                                                   packed_graph, walk)
    errs = {}
    for name, (T, B, P, live, edges) in SHAPES.items():
        graph = packed_graph(T, B, P, live, edges, device, repacked=True)
        N = graph.sized.row_ptr.numel() - 1
        for K, F in HEADS:
            KF = K * F
            gen = torch.Generator(device=device).manual_seed(K)
            zst = torch.randn(N, KF + 2 * K, generator=gen, device=device)
            g = torch.randn(N, KF, generator=gen, device=device)
            with counted() as c:
                x = zst.clone().requires_grad_()
                o = ga.attend(graph, x, K, F)
                (dzst,) = torch.autograd.grad(o, x, g)
                torch.cuda.synchronize()
            assert c.of(ga.LAUNCHES) == c.of(ga.STAGED) == \
                {"fwd": 1, "bwd": 3}, (name, K, F, c.of(ga.LAUNCHES),
                                       c.of(ga.STAGED))
            staged = ga._launch_fwd(graph, zst, K, F)
            walked = ga._launch_fwd(walk(graph), zst, K, F)
            assert all(torch.equal(a, b) for a, b in zip(staged, walked)), \
                (name, K, F, "the staged forward is not the walk's bits")
            del staged, walked
            want_o, lse = ga.fwd_plain(graph, zst, K, F)
            want = ga.bwd_plain(graph, zst, want_o, lse, g, K, F)
            row = {}
            for what, got, ref in (
                    ("o", o.detach(), want_o),
                    ("dz", dzst[:, :KF], want[:, :KF]),
                    ("ds", dzst[:, KF:KF + K], want[:, KF:KF + K]),
                    ("dt", dzst[:, KF + K:], want[:, KF + K:])):
                scale = float(ref.abs().max())
                torch.testing.assert_close(
                    got, ref, rtol=1e-4, atol=2e-5 * scale,
                    msg=lambda m: f"{name} {K}x{F} {what}: {m}")
                row[what] = float((got - ref).abs().max()) / scale
            errs[f"{name} {K}x{F}"] = row
            log(f"  {name} {T}x{B}x{P} as {N} rows, heads {K}x{F}: max "
                f"abs error over scale {row}")
            del zst, g, x, o, dzst, want_o, lse, want
            torch.cuda.empty_cache()
    return errs


def gat_step(device):
    """Phase 15(b): one GAT meta-step of the gat_ppi.pool cell's
    configuration (PRESETS["tissue_ppi"] with arch 'gat' at the published
    widths, 16 tasks, float32, the CSR path) on a batch of its geometry
    (GAT_SETS: a host batch, so the step runs it repacked, which the
    repack's tally shows) and PPI's feature rows, after a warm step, launch
    counts set to 0 just before it and read just after. Each of the 3
    layers runs
    2 U + 2 attention forwards (support: the curve's and U inner; query:
    the curve's after each of U steps and before them) and U + 2
    backwards (U inner gradients; the meta-gradient through the query and
    the last support pass), 3 kernels a backward. Returns (launches,
    seconds, peak GB)."""
    import numpy as np
    import torch

    from gmeta_tpu_torch.config import PRESETS, build_model_config
    from gmeta_tpu_torch.data import repack
    from gmeta_tpu_torch.data.pack import TaskBatch
    from gmeta_tpu_torch.meta.maml import MetaLearner
    from gmeta_tpu_torch.ops import gat_attention as ga
    cfg = dataclasses.replace(PRESETS["tissue_ppi"], arch="gat",
                              task_num=16, dtype="float32",
                              agg="sized").validate()
    spec = build_model_config(cfg, 50, cfg.n_way)
    learner = MetaLearner(
        spec, cfg.n_way, update_lr=cfg.update_lr, meta_lr=cfg.meta_lr,
        update_step=cfg.update_step, update_step_test=cfg.update_step_test,
        first_order=cfg.first_order, seed=cfg.seed,
        track_curve=cfg.track_train_curve, agg="sized", device=device)
    rng = np.random.default_rng(0)
    learner.set_features(rng.standard_normal((GAT_ROWS, 50),
                                             dtype=np.float32))
    batch = TaskBatch(*(gat_set(rng, cfg.task_num, *GAT_SETS[s])
                        for s in ("spt", "qry")))
    assert math.isfinite(learner.train_step(batch)["meta_loss"].item())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with counted() as c:
        loss = learner.train_step(batch)["meta_loss"].item()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    got = c.of(ga.LAUNCHES)
    U, layers = cfg.update_step, len(spec) - 1
    want = {"fwd": layers * (2 * U + 2), "bwd": layers * 3 * (U + 2)}
    assert math.isfinite(loss) and got == want == c.of(ga.STAGED), \
        (loss, got, want, c.of(ga.STAGED))
    rows = c[repack.TALLY["rows"]]
    assert rows == sum(cfg.task_num * repack.bin_rows(
        repack.live_counts(sg.bin_fill)) for sg in batch), rows
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  one meta-step of 16 tasks: {seconds:.3f} s "
        f"({cfg.task_num / seconds:.2f} tasks/s), launches {got}, "
        f"{rows} rows repacked, peak {peak:.2f} GB, meta-loss {loss:.6f}")
    del learner, batch
    torch.cuda.empty_cache()
    return got, seconds, peak


def check_graphormer(device):
    """Phase 16(a): the distance kernel and the attention kernels, through
    `spatial_graph`, `attend` and the autograd Function, on the card
    against `distances_plain`, `fwd_plain` and `bwd_plain` at the cell's
    set shapes (bench_graphormer.SHAPES: 16 tasks x 16 or 6 graphs of 586
    live slots, repacked into one bin of M rows a task as the CSR path
    runs them, each original bin's rows a segment), 8 heads of 10: the
    distances' bytes equal; one forward and four backward launches a
    call; o and the gradients of q, k, v and the table within rtol 1e-4
    and atol 2e-5 of each tensor's largest magnitude (float32 sums of a
    segment's 586 terms in another order, the kernel's softmax online in
    base 2; the backward's g . v - D cancels). A pair dropped or doubled
    errs by a percent of the scale. Returns {set heads: max abs error over
    scale, by tensor}."""
    import torch

    from gmeta_tpu_torch.ops import spatial_attention as sa
    from gmeta_tpu_torch.ops.sized_spmm import sized_graph
    from gmeta_tpu_torch.scripts.bench_graphormer import (HEADS, SHAPES,
                                                          graph_inputs,
                                                          operands)
    K, D = HEADS
    H = K * D
    errs = {}
    for name, (T, B, P, live, edges) in SHAPES.items():
        inputs = graph_inputs(T, B, P, live, edges, device, repacked=True)
        with counted() as c:
            graph = sa.spatial_graph(*inputs)
            torch.cuda.synchronize()
        assert c.of(sa.LAUNCHES) == {"fwd": 0, "bwd": 0, "spd": 1}, \
            c.of(sa.LAUNCHES)
        src, dst, mask, _, b, p = inputs[:6]
        sized = sized_graph(src, dst, mask, b, p)
        want = sa.distances_plain(sized.row_ptr, sized.col, graph.seg,
                                  graph.stride)
        st, seg = graph.stride, graph.seg.cpu().long().tolist()
        got, want = graph.phi.view(-1, st, st), want.view(-1, st, st)
        for s in range(len(seg) - 1):
            n = seg[s + 1] - seg[s]
            assert torch.equal(got[s, :n, :n], want[s, :n, :n]), (name, s)
        del sized, want
        qkv, table, g = operands(graph, K, D, device)
        with counted() as c:
            x = qkv.clone().requires_grad_()
            tb = table.clone().requires_grad_()
            o = sa.attend(graph, x, tb, K, D)
            dx, dtb = torch.autograd.grad(o, (x, tb), g)
            torch.cuda.synchronize()
        assert c.of(sa.LAUNCHES) == {"fwd": 1, "bwd": 4, "spd": 0}, \
            (name, c.of(sa.LAUNCHES))
        want_o, lse = sa.fwd_plain(graph, qkv, table, K, D)
        want_dx, want_dtb = sa.bwd_plain(graph, qkv, table, want_o, lse, g,
                                         K, D)
        row = {}
        for what, got_t, ref in (
                ("o", o.detach(), want_o),
                ("dq", dx[:, :H], want_dx[:, :H]),
                ("dk", dx[:, H:2 * H], want_dx[:, H:2 * H]),
                ("dv", dx[:, 2 * H:], want_dx[:, 2 * H:]),
                ("dtable", dtb, want_dtb)):
            scale = float(ref.abs().max())
            torch.testing.assert_close(
                got_t, ref, rtol=1e-4, atol=2e-5 * scale,
                msg=lambda m: f"{name} {K}x{D} {what}: {m}")
            row[what] = float((got_t - ref).abs().max()) / scale
        errs[f"{name} {K}x{D}"] = row
        log(f"  {name} {T}x{B}x{P} as {graph.live.numel()} rows, "
            f"{len(seg) - 1} segments, heads {K}x{D}: distances equal; max "
            f"abs error over scale {row}")
        del graph, qkv, table, g, x, tb, o, dx, dtb, want_o, lse, want_dx
        torch.cuda.empty_cache()
    return errs


def graphormer_step(device):
    """Phase 16(b): one Graphormer meta-step of the graphormer_ppi.pool
    cell's configuration (PRESETS["tissue_ppi"] with arch 'graphormer' at
    Graphormer-slim's widths, 16 tasks, float32, the CSR path) on a batch
    of its geometry (GAT_SETS: one graph a bin, a host batch, so the step
    runs it repacked) and PPI's feature rows, after a warm step, launch
    counts set to 0 just before it and read just after. Each of the L
    layers runs 2 U + 2 attention forwards and U + 2 backwards of 4
    kernels (as the GAT's, phase 15(b)); each set's distances one launch.
    Returns (launches, seconds, peak GB)."""
    import numpy as np
    import torch

    from gmeta_tpu_torch.config import PRESETS, build_model_config
    from gmeta_tpu_torch.data.pack import TaskBatch
    from gmeta_tpu_torch.meta.maml import MetaLearner
    from gmeta_tpu_torch.ops import spatial_attention as sa
    cfg = dataclasses.replace(PRESETS["tissue_ppi"], arch="graphormer",
                              task_num=16, dtype="float32",
                              agg="sized").validate()
    spec = build_model_config(cfg, 50, cfg.n_way)
    learner = MetaLearner(
        spec, cfg.n_way, update_lr=cfg.update_lr, meta_lr=cfg.meta_lr,
        update_step=cfg.update_step, update_step_test=cfg.update_step_test,
        first_order=cfg.first_order, seed=cfg.seed,
        track_curve=cfg.track_train_curve, agg="sized", device=device)
    rng = np.random.default_rng(0)
    learner.set_features(rng.standard_normal((GAT_ROWS, 50),
                                             dtype=np.float32))
    batch = TaskBatch(*(gat_set(rng, cfg.task_num, *GAT_SETS[s])
                        for s in ("spt", "qry")))
    assert math.isfinite(learner.train_step(batch)["meta_loss"].item())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with counted() as c:
        loss = learner.train_step(batch)["meta_loss"].item()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    got = c.of(sa.LAUNCHES)
    U, L = cfg.update_step, cfg.graphormer_layers
    want = {"fwd": L * (2 * U + 2), "bwd": 4 * L * (U + 2), "spd": 2}
    assert math.isfinite(loss) and got == want, (loss, got, want)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  one meta-step of 16 tasks: {seconds:.3f} s "
        f"({cfg.task_num / seconds:.2f} tasks/s), launches {got}, "
        f"{c[sa.PAIRS]} distance pairs, peak {peak:.2f} GB, meta-loss "
        f"{loss:.6f}")
    del learner, batch
    torch.cuda.empty_cache()
    return got, seconds, peak


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false: "
                         "this script needs an NVIDIA GPU")
    try:
        from gmeta_tpu_torch.config import PRESETS
        from gmeta_tpu_torch.ops import cuda_build
        from gmeta_tpu_torch.ops import epilogue as ep
        from gmeta_tpu_torch.ops import gat_attention
        from gmeta_tpu_torch.ops import spatial_attention
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

    epi_mark = counted()

    def epi_take():
        """The epilogue's launches in this process since the last take."""
        nonlocal epi_mark
        got, epi_mark = epi_mark.of(ep.LAUNCHES), counted()
        return got

    def timed(fn, name):
        t0 = time.time()
        return fn(name), time.time() - t0
    with ThreadPoolExecutor(5) as pool:      # nvcc and g++ at once
        cu = pool.submit(timed, cuda_build.build, "sized_spmm")
        epi = pool.submit(timed, cuda_build.build, "gcn_epilogue")
        gat = pool.submit(timed, cuda_build.build, "gat_attention")
        sat = pool.submit(timed, cuda_build.build, "spatial_attention")
        cpp = pool.submit(timed, cuda_build.build_host, "extract")
        (path, cu_s), (epi_path, epi_s) = cu.result(), epi.result()
        gat_path, gat_s = gat.result()
        sat_path, sat_s = sat.result()
        host_path, cpp_s = cpp.result()
    build_s = time.time() - t
    log(f"  sized_spmm.cu -> {path.name} in {cu_s:.1f} s; gcn_epilogue.cu "
        f"-> {epi_path.name} in {epi_s:.1f} s; gat_attention.cu -> "
        f"{gat_path.name} in {gat_s:.1f} s; spatial_attention.cu -> "
        f"{sat_path.name} in {sat_s:.1f} s; extract.cpp -> "
        f"{host_path.name} in {cpp_s:.1f} s; all {build_s:.1f} s")
    for so in (path, epi_path, gat_path, sat_path):
        log("  " + so.with_suffix(".ptxas.txt").read_text()
            .strip().replace("\n", "\n  "))

    t = phase("3 kernel checks")
    errs = check_kernels(device)
    check_epilogue(device)
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
    epi_shapes = epilogue_shapes(batch)
    epi_timing = time_epilogue(device, epi_shapes)
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
    launched = counted()
    epi_take()
    t_fit = time.time()
    result = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.time() - t_fit
    main_path = launched.of(sp.LAUNCHES)
    epi_by_phase = {"7": epi_take()}
    assert all(epi_by_phase["7"].values()), epi_by_phase
    fit_sha256 = theta_digest([p.detach().cpu().numpy()
                               for p in trainer.learner.params])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  FitResult {result}")
    log(f"  fit {fit_s:.1f} s; kernel launches {main_path}; peak device "
        f"memory {peak_gb:.2f} GB; theta sha256 {fit_sha256}")
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
    auto7 = auto_trainer(cfg, store, ds)

    # one more meta-step on its own: kernel launches per meta-step
    launched = counted()
    epi_take()
    assert math.isfinite(trainer.learner.train_step(batch)["meta_loss"]
                         .item())
    per_step = launched.of(sp.LAUNCHES)
    epi_per_step = epi_take()
    assert epi_per_step["fwd"] > 0 and epi_per_step["bwd"] > 0, epi_per_step
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
        f"launches {per_step}, epilogue {epi_per_step}; fit steps "
        f"compute_s "
        f"{[round(r['compute_s'], 3) for r in steps]}; evaluate(test) of "
        f"{n_eval} tasks {eval_s:.3f} s")
    del trainer
    torch.cuda.empty_cache()

    t = phase("8 the execution modes: streaming, compact pool, host-windowed"
              " pool; kill and resume")
    epi_take()
    modes, mode_launches = fit_modes(
        dataclasses.replace(cfg, train_result_report_steps=2), store, ds)
    epi_by_phase["8"] = epi_take()
    log(f"  {time.time() - t:.1f} s; kernel launches of phase 8 "
        f"{mode_launches}, epilogue {epi_by_phase['8']}")

    t = phase("9 the CLI from disk: prepare, extract, remat")
    cli, cli_launches, plain9 = cli_phase(store, ds, device)
    epi_by_phase["9"] = epi_take()
    log(f"  {time.time() - t:.1f} s; kernel launches of phase 9 "
        f"{cli_launches}, epilogue {epi_by_phase['9']}")
    del store, ds, tr_ds, batch
    gc.collect()

    t = phase("10 the mesh: task-DP and the edge-partitioned engine")
    (mesh, mesh_launches, rect_launches, combine_launches,
     (rect, combine_row, rect_shapes)) = mesh_phase(device, plain9)
    shutil.rmtree(DATA_DIR, ignore_errors=True)
    # in this process, and in (c)'s four task-DP ranks, as the packed
    # kernel's count of the phase
    epi_by_phase["10"] = epi_take()
    for meta in mesh["c_tasks"]["ranks"]:
        for k in ep.LAUNCHES:
            epi_by_phase["10"][k] += meta["epilogue_launches"][k]
    log(f"  {time.time() - t:.1f} s; kernel launches of phase 10: packed "
        f"{mesh_launches}, csr_gather {rect_launches}, combine "
        f"{combine_launches}, epilogue {epi_by_phase['10']}")

    t = phase("11 parity: evaluation from the runs of record's checkpoints;"
              " the entry points")
    parity11, packed11, dry11 = parity_phase(device)
    epi_by_phase["11"] = epi_take()
    log(f"  {time.time() - t:.1f} s; kernel launches of phase 11: packed "
        f"{packed11}, the dry run's ranks {dry11}, epilogue "
        f"{epi_by_phase['11']}")
    log(json.dumps({"parity": parity11}))

    t = phase("12 measure: the measurement scripts at cut sizes")
    measure12, l12 = measure_phase()
    epi_by_phase["12"] = epi_take()
    log(f"  {time.time() - t:.1f} s; kernel launches of phase 12: packed "
        f"{l12['packed']}, csr_gather {l12['csr']}, combine "
        f"{l12['combine']}, epilogue {epi_by_phase['12']}")

    t = phase("13 calibrate: the replica calibrators")
    calibrate13, l13 = calibrate_phase(device)
    epi_by_phase["13"] = epi_take()
    log(f"  {time.time() - t:.1f} s; kernel launches of phase 13: packed "
        f"{l13['packed']}, csr_gather {l13['csr']}, combine "
        f"{l13['combine']}, epilogue {epi_by_phase['13']}")

    t = phase("14 bench: the throughput benchmark's five shapes; the "
              "shared-adjacency call")
    bench14, l14, arxiv14 = bench_phase(device)
    t1 = time.time()
    shared14, shared_launches = shared_phase(arxiv14, device)
    del arxiv14
    bench14.update(phase_s=time.time() - t, shared_s=time.time() - t1,
                   launches=l14)
    epi_by_phase["14"] = epi_take()
    log(f"  {time.time() - t:.1f} s; kernel launches of phase 14: packed "
        f"{l14}, the shared call {shared_launches}, epilogue "
        f"{epi_by_phase['14']}")
    log(json.dumps({"bench": bench14}))
    torch.cuda.empty_cache()

    t = phase("15 gat: the attention kernels at gat_ppi.pool's shapes; one "
              "meta-step of its configuration")
    gat_errs = check_gat(device)
    gat_step_launches, gat_step_s, gat_peak = gat_step(device)
    with counted() as c:
        gat_bench, _ = run_script("bench_gat", [])
    shutil.rmtree(MEASURE, ignore_errors=True)
    log(f"  {time.time() - t:.1f} s; attention launches of the timing "
        f"{c.of(gat_attention.LAUNCHES)}")

    t = phase("16 graphormer: the distances and attention kernels at "
              "graphormer_ppi.pool's shapes; one meta-step of its "
              "configuration")
    sat_errs = check_graphormer(device)
    sat_step_launches, sat_step_s, sat_peak = graphormer_step(device)
    with counted() as c:
        sat_bench, _ = run_script("bench_graphormer", [])
    shutil.rmtree(MEASURE, ignore_errors=True)
    log(f"  {time.time() - t:.1f} s; launches of the timing "
        f"{c.of(spatial_attention.LAUNCHES)}")

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
                         + mesh_launches[direction]
                         + packed11[direction]
                         + dry11["packed"][direction]
                         + l12["packed"][direction]
                         + l13["packed"][direction] + l14[direction]),
            "launches_by_phase": {"7": main_path[direction],
                                  "8": mode_launches[direction],
                                  "9": cli_launches[direction],
                                  "10": mesh_launches[direction],
                                  "11": packed11[direction]
                                  + dry11["packed"][direction],
                                  "12": l12["packed"][direction],
                                  "13": l13["packed"][direction],
                                  "14": l14[direction]},
            "max_abs_err": max(errs[direction]["float32"],
                               head["max_abs_err"]),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "dense_bmm_ms": head["dense_bmm_ms"],
            "shape": f"{qry_shape} H=256 float32",
            "max_abs_err_bf16": errs[direction]["bfloat16"],
            "launches_per_meta_step": per_step[direction],
            "launches_by_dtype_phase_14": {
                t: v[direction]
                for t, v in bench14["launches_by_dtype"].items()},
            "by_H": {str(H): timing[(direction, H)] for H in (128, 256)},
        })
    for direction in ("fwd", "bwd"):
        head = rect[("uniform", direction, 256)]
        kernels.append({
            "name": f"csr_gather_{direction}",
            "route": "cuda",
            "source": "gmeta_tpu_torch/csrc/sized_spmm.cu",
            # the edge engine's segment-sum, an XLA op in the JAX package
            "replaces": "gmeta_tpu/parallel/edgepart_train.py:129",
            "launches": (rect_launches[direction] + dry11["csr"][direction]
                         + l12["csr"][direction] + l13["csr"][direction]),
            "launches_by_phase": {"10": rect_launches[direction],
                                  "11": dry11["csr"][direction],
                                  "12": l12["csr"][direction],
                                  "13": l13["csr"][direction]},
            "max_abs_err": head["max_abs_err"],
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "rowwise_ms": head["rowwise_ms"],
            "shape": f"{rect_shapes['uniform']} H=256 float32",
            "by_graph_H": {f"{g} {H}": rect[(g, direction, H)]
                           for g in ("uniform", "powerlaw")
                           for H in (128, 256)},
            "powerlaw_shape": rect_shapes["powerlaw"],
        })
    kernels.append({
        "name": "csr_combine",
        "route": "cuda",
        "source": "gmeta_tpu_torch/csrc/sized_spmm.cu",
        "replaces": "gmeta_tpu/parallel/edgepart_train.py:129",
        "launches": (sum(combine_launches.values())
                     + sum(dry11["combine"].values())
                     + sum(l12["combine"].values())
                     + sum(l13["combine"].values())),
        "launches_by_direction": combine_launches,
        "launches_phase_11": dry11["combine"],
        "launches_phase_12": l12["combine"],
        "launches_phase_13": l13["combine"],
        **{k: combine_row["float32 256"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "split_rows", "chunks")},
        "shape": f"{rect_shapes['powerlaw']} forward, H=256 float32",
        "by_dtype_H": combine_row,
    })
    kernels.append({
        "name": "sized_spmm_shared",
        "route": "cuda",
        "source": "gmeta_tpu_torch/csrc/sized_spmm.cu",
        # the batching rule of a task-invariant adjacency over _fwd_kernel
        "replaces": "gmeta_tpu/ops/pallas_spmm.py:254",
        "launches": shared_launches["fwd"],
        "launches_by_direction": shared_launches,
        **shared14,
    })
    for direction in ("fwd", "bwd"):
        kernels.append({
            "name": f"gcn_epilogue_{direction}",
            "route": "cuda",
            "source": "gmeta_tpu_torch/csrc/gcn_epilogue.cu",
            # XLA fuses this chain of jnp ops in the JAX package
            "replaces": None,
            # each phase's launches in this process (phase 10: and in
            # its task-DP ranks), counted from 0 at the phase's start;
            # phase 7 is the fit alone, as for sized_spmm
            "launches": sum(c[direction] for c in epi_by_phase.values()),
            "launches_by_phase": {p: c[direction]
                                  for p, c in epi_by_phase.items()},
            "launches_per_meta_step": epi_per_step[direction],
            "shape": " x ".join(map(str, epi_shapes[0])),
            "by_dtype": {d: {k: v for k, v in r.items()
                             if k.startswith(direction)
                             or k.startswith(f"chain_{direction}")}
                         for d, r in epi_timing.items()},
        })
    for direction, n_kernels in (("fwd", 1), ("bwd", 3)):
        rows = {f"{r['set']} {r['K']}x{r['F']}": r
                for r in gat_bench["rows"]}
        head = rows["qry 4x256"]
        kernels.append({
            "name": f"gat_attn_{direction}",
            "route": "cuda",
            "source": "gmeta_tpu_torch/csrc/gat_attention.cu",
            # the JAX package has no GAT
            "replaces": None,
            "kernels_a_call": n_kernels,
            "launches_per_meta_step": gat_step_launches[direction],
            "max_abs_err_over_scale": max(
                v for e in gat_errs.values() for k, v in e.items()
                if (k == "o") == (direction == "fwd")),
            "ms": head[f"{direction}_ms"],
            "bound_ms": head[f"{direction}_bound_ms"],
            "bound_by": head[f"{direction}_bound"],
            "share": head[f"{direction}_share"],
            "walk_ms": head[f"walk_{direction}_ms"],
            "walk_share": head[f"walk_{direction}_share"],
            "plain_ms": head[f"{direction}_plain_ms"],
            "shape": f"16 x 16 x 1024 repacked into {head['rows']} "
                     f"rows, 4 x 256 heads, float32, staged",
            "by_set_heads": {
                k: {x: r[f"{direction}_{x}"]
                    for x in ("ms", "bound_ms", "share", "plain_ms")}
                | {f"walk_{x}": r[f"walk_{direction}_{x}"]
                   for x in ("ms", "share")}
                for k, r in rows.items()},
        })
    for direction, n_kernels in (("fwd", 1), ("bwd", 4)):
        rows = {r["set"]: r for r in sat_bench["rows"]}
        head = rows["qry"]
        kernels.append({
            "name": f"sattn_{direction}",
            "route": "cuda",
            "source": "gmeta_tpu_torch/csrc/spatial_attention.cu",
            # the JAX package has no Graphormer
            "replaces": None,
            "kernels_a_call": n_kernels,
            "launches_per_meta_step": sat_step_launches[direction],
            "max_abs_err_over_scale": max(
                v for e in sat_errs.values() for k, v in e.items()
                if (k == "o") == (direction == "fwd")),
            "ms": head[f"{direction}_ms"],
            "bound_ms": head[f"{direction}_bound_ms"],
            "bound_by": head[f"{direction}_bound"],
            "share": head[f"{direction}_share"],
            "plain_ms": head[f"{direction}_plain_ms"],
            "shape": f"16 x 16 x 1024 repacked into {head['rows']} rows, "
                     f"{head['segments']} graphs of 586, 8 x 10 heads, "
                     f"float32",
            "by_set": {k: {x: r[f"{direction}_{x}"]
                           for x in ("ms", "bound_ms", "share", "plain_ms")}
                       | {"spd_ms": r["spd_ms"]}
                       for k, r in rows.items()},
        })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"slice": {
        "fit_s": fit_s, "fit_theta_sha256": fit_sha256,
        "warm_step_s": step_s,
        "tasks_per_s": task_num / step_s, "eval_test_s": eval_s,
        "peak_gb": peak_gb, "buckets": buckets, "build_s": build_s,
        "step_compute_s": [r["compute_s"] for r in steps],
        "dense_step_s": dense_s, "step_s_turns": turns,
        "step_peak_gb": peaks, "profile": breakdown,
        "result": dataclasses.asdict(result), "auto": auto7,
        "modes": modes, "cli": cli,
        "mesh": mesh, "measure": measure12, "calibrate": calibrate13,
        "gat": {"errors": gat_errs, "step_s": gat_step_s,
                "peak_gb": gat_peak, "launches": gat_step_launches},
        "graphormer": {"errors": sat_errs, "step_s": sat_step_s,
                       "peak_gb": sat_peak, "launches": sat_step_launches},
        "card": card}}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] in (["--rank"], ["--one-step-rank"]):  # phase 10(c)
        rank_main(f"{sys.argv[2]}_{os.environ['RANK']}.npz", sys.argv[3:],
                  one_step=sys.argv[1] == "--one-step-rank")
    else:
        main()
