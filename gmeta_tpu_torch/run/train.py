"""Training entry point: the reference's full protocol on the port.

Counterpart of gmeta_tpu/run/train.py: per-epoch train loop over
task_num-sized meta-batches, per-epoch validation with an early-stopping
snapshot of the best model (val acc at the LAST finetune step,
train.py:123-127), final test of both the last and the best model,
structured jsonl metrics, batched evaluation, checkpoint/resume (also from
a checkpoint the JAX package wrote) and profiler traces, in the JAX
package's three execution modes:

- streaming (default): the host packs each meta-batch and ships it;
- `device_task_pool`, compact pool resident on the device: the pool is
  packed and encoded once, and each report window ships only task indices;
- `device_task_pool` with a compact pool above `compact_pool_hbm_gb`: the
  pool stays in host memory and a producer thread ships windows of
  `host_pool_window` meta-steps as one int32 buffer each (pinned, copied on
  a side stream, on CUDA).

Reporting parity notes: the reference prints `accs[1]` as "Test acc"
(train.py:137) and its "Early Stopped Test acc" averages a list
contaminated by the previous test loop (train.py:130-146). Both
reference-style numbers are reported alongside the clean ones.

Multi-device training is one process per rank (parallel/mesh.py):
`--mesh_tasks T` is task data-parallelism over T ranks (meta/maml.py), and
`--mesh_edges D` trains with the edge-partitioned full-graph engine
(run/edgepart.py) over T x D ranks (T = max(--mesh_tasks, 1)):

    torchrun --nproc_per_node R -m gmeta_tpu_torch.run.train \
        --mesh_tasks T --mesh_edges D ...           # R = T x max(D, 1)

`main` reads RANK, WORLD_SIZE, LOCAL_RANK (and LOCAL_WORLD_SIZE,
MASTER_ADDR, MASTER_PORT) from the launcher; with none of them and a mesh
of one rank it runs a world of one on an in-process store. Each rank runs
on cuda:LOCAL_RANK unless --device names a device. --dist_backend is nccl
on CUDA and gloo on the CPU by default; NCCL refuses ranks that share a
card, so that raises, and ranks sharing one card meet over gloo only when
--dist_backend gloo asks for it. Only rank 0 writes metrics and
checkpoints, and every rank resumes from them.

CLI: python -m gmeta_tpu_torch.run.train --preset arxiv --data_dir ...
     [--device cuda|cpu] [--mesh_tasks T] [--mesh_edges D]
     [--dist_backend nccl|gloo] [overrides]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from gmeta_tpu_torch.config import Config, PRESETS, build_model_config
from gmeta_tpu_torch.data import repack
from gmeta_tpu_torch.data.pack import TaskBatch
from gmeta_tpu_torch.data.pipeline import (MetaDataset, agg_for,
                                           edges_per_slot)
from gmeta_tpu_torch.meta.maml import MetaLearner, take_tasks
from gmeta_tpu_torch.models.gcn import count_params
from gmeta_tpu_torch.parallel import mesh as mesh_mod
from gmeta_tpu_torch.utils import checkpoint as ckpt
from gmeta_tpu_torch.utils.device import resolve_device
from gmeta_tpu_torch.utils.metrics import (MetricLogger, StreamClock,
                                           clear_spans, counted, rss_gb,
                                           span_summary, spans)

@dataclasses.dataclass
class FitResult:
    test_acc_ref: float            # reference-style: mean accs[1], last model
    test_acc_final: float          # clean: mean accs[-1], last model
    best_test_acc: float           # clean: mean accs[-1], best model
    early_stopped_ref: float       # reference-style contaminated average
    val_max_acc: float
    epochs_run: int                # epochs executed THIS process (resume-aware)
    global_step: int


def rank_metrics(path: str, mesh) -> MetricLogger:
    """The metric stream of this rank: rank 0 writes `path` and echoes,
    every other rank of a mesh neither writes nor echoes."""
    if mesh is None or mesh.rank == 0:
        return MetricLogger(path)
    return MetricLogger("", echo=False)


class Trainer:
    """The protocol over the packed-subgraph MetaLearner. With a `mesh`
    (parallel/mesh.py) every rank runs it: steps are task data-parallel,
    the meta-step is never chunked (task_vmap_chunk is forced to 0, as in
    the JAX package), only rank 0 writes metrics and checkpoints, and every
    rank restores."""

    def __init__(self, cfg: Config, store, datasets: Dict[str, MetaDataset],
                 labels_num: int, metrics: Optional[MetricLogger] = None,
                 device=None, mesh=None):
        self.cfg = cfg
        self.store = store
        self.datasets = datasets
        self.device = resolve_device(device)
        self.mesh = mesh
        if cfg.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        self.metrics = metrics or rank_metrics(cfg.metrics_path, mesh)
        self.spec = build_model_config(cfg, store.feat_dim, labels_num)
        compute_dtype = (torch.bfloat16 if cfg.dtype == "bfloat16"
                         else torch.float32)
        agg = cfg.agg
        tr = datasets["train"]
        if agg == "auto":
            agg = agg_for(tr, self.device, self.spec, cfg.dtype)
            rule = ("the card's crossover" if self.device.type == "cuda"
                    else "the JAX package's rule")
            self.metrics.echo_line(
                f"agg kernel: {agg} by {rule} (bin fill "
                f"{tr.mean_bin_fill:.2f}, {edges_per_slot(tr):.2f} real "
                f"edges per slot)")
        self.agg = agg
        self.buckets = dict(P_spt=tr.P_spt, B_spt=tr.B_spt, E_spt=tr.E_spt,
                            P_qry=tr.P_qry, B_qry=tr.B_qry, E_qry=tr.E_qry)
        # -1 (auto) runs all tasks at once: no preset has yet been shown to
        # run out of device memory unchunked (PERF.md); a mesh never chunks
        task_chunk = 0 if mesh is not None else max(cfg.task_vmap_chunk, 0)
        if task_chunk:
            self.metrics.echo_line(f"meta-step chunked at {task_chunk} tasks")
        self.task_chunk = task_chunk
        self.metrics.log("run_config", agg=agg, device=str(self.device),
                         mean_bin_fill=round(tr.mean_bin_fill, 4),
                         device_task_pool=cfg.device_task_pool,
                         task_chunk=task_chunk, **self.buckets)
        self.learner = MetaLearner(
            self.spec, labels_num,
            update_lr=cfg.update_lr, meta_lr=cfg.meta_lr,
            update_step=cfg.update_step, update_step_test=cfg.update_step_test,
            first_order=cfg.first_order, compute_dtype=compute_dtype,
            remat=cfg.remat_inner, seed=cfg.seed,
            track_curve=cfg.track_train_curve, agg=agg,
            task_chunk=task_chunk, device=self.device, mesh=mesh)
        self.learner.set_features(store.features)
        self.metrics.echo_line(
            f"Total trainable tensors: {count_params(self.learner.params)}")

        # early stopping state (train.py:86-87,125-127)
        self.max_acc = 0.0
        self.best_params = self.learner.snapshot()
        self.start_epoch = 0
        self.start_batch = 0   # in-epoch batch position (mid-epoch resume)
        self.global_step = 0

        if cfg.checkpoint_dir:
            path = ckpt.latest_path(cfg.checkpoint_dir)
            if path:
                self._restore(path)

    # ---- checkpointing -----------------------------------------------------

    def _restore(self, path: str):
        """Resume from a checkpoint of either package (utils/checkpoint)."""
        state = ckpt.restore(path)
        self.learner.set_params(state["params"], state["opt_state"])
        self.max_acc = float(state["max_acc"])
        self.best_params = tuple(torch.as_tensor(p).to(self.device)
                                 for p in state["best_params"])
        self.global_step = int(state["step"])
        batch_in_epoch = int(state.get("batch_in_epoch", -1))
        if batch_in_epoch >= 0:
            # mid-epoch snapshot: re-enter the SAME epoch and skip the batches
            # already consumed (the stream order is a pure function of
            # seed + epoch, so position alone pins the remaining stream)
            self.start_epoch = int(state["epoch"])
            self.start_batch = batch_in_epoch
        else:
            self.start_epoch = int(state["epoch"]) + 1
            self.start_batch = 0
        self.metrics.echo_line(
            f"resumed from {path} at epoch {self.start_epoch}"
            f" batch {self.start_batch}")

    def _save(self, epoch: int, batch_in_epoch: int = -1,
              params=None, opt_state=None):
        """batch_in_epoch >= 0 marks a mid-epoch snapshot: `batch_in_epoch`
        batches of this epoch are already consumed; -1 = epoch complete.
        `params`/`opt_state` replace the learner's current state: the
        host-windowed loop saves copies taken at a window's end, because by
        the time it saves, the next window's steps have updated theta in
        place."""
        if not self.cfg.checkpoint_dir:
            return
        if self.mesh is None or self.mesh.rank == 0:
            ckpt.save(self.cfg.checkpoint_dir, self.global_step, {
                "params": self.learner.params if params is None else params,
                "opt_state": (self.learner.opt_state if opt_state is None
                              else opt_state),
                "best_params": self.best_params,
                "max_acc": self.max_acc,
                "epoch": epoch,
                "batch_in_epoch": batch_in_epoch,
                "step": self.global_step,
            })
        if self.mesh is not None:
            self.mesh.barrier()     # the file is whole before anyone goes on

    # ---- evaluation --------------------------------------------------------

    def evaluate(self, split: str, params=None) -> np.ndarray:
        """Accuracy curves (n_tasks, update_step_test+1) over a split's
        tasks, evaluated task_num at a time. The ragged last batch is padded
        to the full size (repeating tasks) and the padded rows dropped."""
        ds = self.datasets[split]
        chunk = max(1, self.cfg.task_num)
        curves = []
        for batch in ds.batches(chunk, shuffle=False, drop_last=False,
                                pad_last=True):
            accs = self.learner.finetune_batch(batch, params=params)
            curves.append(accs.cpu().numpy())
        return np.concatenate(curves, axis=0)[:len(ds)]

    def _end_epoch(self, epoch: int):
        """Per-epoch validation, early stopping and the epoch checkpoint
        (train.py:115-127)."""
        curves = self.evaluate("val")
        acc_curve = curves.mean(axis=0)
        self.metrics.echo_line(
            f"Epoch: {epoch + 1}  Val acc: {acc_curve[-1]:.3f}")
        self.metrics.log("val", epoch=epoch, step=self.global_step,
                         acc_curve=acc_curve.tolist())
        if acc_curve[-1] > self.max_acc:
            self.max_acc = float(acc_curve[-1])
            self.best_params = self.learner.snapshot()
        if (epoch + 1) % self.cfg.checkpoint_every_epochs == 0:
            self._save(epoch)

    # ---- training ----------------------------------------------------------

    def fit(self) -> FitResult:
        cfg = self.cfg
        train = self.datasets["train"]
        t_start = time.time()
        # profiler window: starts after the first step (warm-up excluded),
        # covers cfg.profile_steps steps
        prof_stop = (self.global_step + 1 + cfg.profile_steps
                     if cfg.profile_dir else -1)
        prof = None

        mean_edges = train.mean_edges_per_task
        win_t, win_steps = time.time(), 0
        self._fit_from_epoch = self.start_epoch  # for epochs_run on resume

        if cfg.device_task_pool:
            return self._fit_device_pool(t_start, mean_edges)

        # Depth-1 dispatch: packing batch N+1 overlaps the device executing
        # step N, but step N+1 is not dispatched until step N has completed,
        # so the host never runs more than one step ahead. Per report
        # window: data_s, the host's wait in the batch iterator; compute_s,
        # each step's time from its dispatch to the end of its work, in
        # stream order (StreamClock), read once the window's fetch synced.
        clock = StreamClock(self.device)
        prev_done = None
        data_t, marks = 0.0, []
        for epoch in range(self.start_epoch, cfg.epoch):
            skip = self.start_batch if epoch == self.start_epoch else 0
            batches = enumerate(train.batches(
                cfg.task_num, shuffle=True, seed=cfg.seed + epoch,
                num_workers=cfg.num_workers, skip_batches=skip), start=skip)
            while True:
                t0 = time.perf_counter()
                item = next(batches, None)
                data_t += time.perf_counter() - t0
                if item is None:
                    break
                step, batch = item
                if prof is None and \
                        self.global_step == prof_stop - cfg.profile_steps:
                    prof = _start_trace(self.device)
                if prev_done is not None:
                    _wait(prev_done)
                start = clock.mark()
                m = self.learner.train_step(batch)
                prev_done = clock.mark()
                marks.append((start, prev_done))
                if prof is not None and self.global_step + 1 >= prof_stop:
                    self._stop_trace(prof)
                    prof = None
                win_steps += 1
                if step % cfg.train_result_report_steps == 0:
                    accs = m["accs"].cpu().numpy()  # sync point (host fetch)
                    compute_t = sum(clock.seconds(a, b) for a, b in marks)
                    # window throughput: tasks (and their real edges) per
                    # wall-second since the previous report
                    dt = max(time.time() - win_t, 1e-9)
                    tasks_per_s = win_steps * cfg.task_num / dt
                    win_t, win_steps = time.time(), 0
                    self.metrics.echo_line(
                        f"Epoch: {epoch + 1}  Step: {step}  training acc: "
                        f"{accs[-1]:.3f}  time elapsed: {compute_t:.3f}  "
                        f"data loading takes: {data_t:.3f}  Memory usage "
                        f"(process RSS, GiB): {rss_gb():.1f}")
                    self.metrics.log(
                        "train_step", epoch=epoch, step=self.global_step,
                        acc_curve=accs.tolist(),
                        meta_loss=float(m["meta_loss"]),
                        nan_skip=int(m["nan_skip"]),
                        tasks_per_s=round(tasks_per_s, 2),
                        edges_per_s=round(tasks_per_s * mean_edges, 1),
                        data_s=data_t, compute_s=compute_t, rss_gb=rss_gb())
                    data_t, marks = 0.0, []
                self.global_step += 1
                if (cfg.checkpoint_every_steps
                        and self.global_step % cfg.checkpoint_every_steps == 0):
                    self._save(epoch, batch_in_epoch=step + 1)
            self._end_epoch(epoch)

        if prof is not None:  # fewer total steps than the requested window
            self._stop_trace(prof)
        return self._final_test(t_start)

    def _stop_trace(self, prof) -> None:
        """Stop the profiler window, write its Chrome trace and a `spans`
        record of the window's meta-step spans (utils/metrics.py)."""
        name = f"step{self.global_step:08d}"
        if self.mesh is not None:
            name += f"_rank{self.mesh.rank}"
        path = _stop_trace(prof, self.cfg.profile_dir, self.device, name)
        self.metrics.echo_line(f"profiler trace written to {path}")
        self.metrics.log("spans", **span_summary(spans()))

    def _epoch_steps(self, epoch: int) -> np.ndarray:
        """(steps_per_epoch, task_num) task indices of an epoch: the order
        `MetaDataset.batches` streams for the same seed."""
        n_tasks = len(self.datasets["train"])
        steps = n_tasks // self.cfg.task_num
        order = np.random.RandomState(self.cfg.seed + epoch).permutation(
            n_tasks)[:steps * self.cfg.task_num]
        return order.reshape(steps, self.cfg.task_num)

    def _log_window(self, epoch, start, n_steps, m, dt, mean_edges, counts):
        """The train_window record of a window's metrics (on the host);
        `counts`, the window's counts (utils/metrics.py `counted`), give
        its row_share (rows run / slots packed) and live_share (live nodes
        / rows run) where its steps were repacked (data/repack.py)."""
        accs, rows = m["accs"][-1], counts.of(repack.TALLY)
        tasks_per_s = n_steps * self.cfg.task_num / dt
        self.metrics.echo_line(
            f"Epoch: {epoch + 1}  Step: {start + n_steps}  training acc: "
            f"{accs[-1]:.3f}  tasks/s: {tasks_per_s:.1f}")
        self.metrics.log(
            "train_window", epoch=epoch, step=self.global_step,
            acc_curve=accs.tolist(), meta_loss=float(m["meta_loss"][-1]),
            nan_skip=int(m["nan_skip"].sum()),
            tasks_per_s=round(tasks_per_s, 2),
            edges_per_s=round(tasks_per_s * mean_edges, 1), rss_gb=rss_gb(),
            **({"row_share": round(rows["rows"] / rows["slots"], 4),
                "live_share": round(rows["live"] / rows["rows"], 4)}
               if rows["slots"] else {}))

    def _fit_device_pool(self, t_start: float, mean_edges: float) -> FitResult:
        """Epoch loop over a pre-packed task pool: the epoch's shuffled
        task stream is chunked into report windows, each one call of K
        meta-steps, with one host sync per window (the metric fetch). The
        protocol (per-epoch val, early stopping, checkpointing, final tests)
        is the streaming path's.

        The compact pool is resident on the device when it fits
        cfg.compact_pool_hbm_gb; above it, the host-resident windowed
        variant runs (_fit_host_pool). The budget and the window's byte cap
        below are the JAX package's, sized for a 16 GB TPU and kept so that
        a flag means the same in both packages."""
        cfg = self.cfg
        train = self.datasets["train"]
        t0 = time.time()
        pool_np = train.stacked_pool()
        compact_bytes = MetaLearner.compact_pool_bytes(pool_np)
        compact_gb = compact_bytes / 1e9
        if compact_gb > cfg.compact_pool_hbm_gb:
            self.metrics.echo_line(
                f"compact pool {compact_gb:.1f} GB >"
                f" compact_pool_hbm_gb={cfg.compact_pool_hbm_gb}"
                f" -> host-resident windowed pool"
                f" ({cfg.host_pool_window}-step windows)")
            self.metrics.log("task_pool", mode="host_window",
                             compact_bytes=compact_bytes,
                             build_s=time.time() - t0)
            return self._fit_host_pool(pool_np, t_start, mean_edges)
        self.learner.set_task_pool_compact(pool_np)
        self.metrics.echo_line(
            f"compact task pool resident on {self.device} "
            f"({compact_gb:.1f} GB)")
        self.metrics.log("task_pool", mode="compact",
                         compact_bytes=compact_bytes,
                         build_s=time.time() - t0)
        # Bound a window's decoded batches as the JAX package does (its scan
        # decodes a whole window up front; here one step is decoded at a
        # time, and the cap only sets the report cadence):
        # K * task_num * full-form task bytes <= 5e8.
        task_bytes = (sum(x.nbytes for sg in pool_np for x in sg
                          if x is not None) / max(len(train), 1))
        byte_cap = max(1, int(5e8 // max(task_bytes * cfg.task_num, 1)))
        del pool_np
        steps_per_epoch = len(train) // cfg.task_num
        window = max(1, min(cfg.train_result_report_steps, steps_per_epoch,
                            byte_cap))
        # profiler window: the second chunk (the first includes warm-up)
        prof_chunk = 1 if cfg.profile_dir else -1
        chunks_done = 0

        steps_since_save = 0
        for epoch in range(self.start_epoch, cfg.epoch):
            idx_mat = self._epoch_steps(epoch)
            win_t = time.time()
            # Mid-epoch resume: skipping the consumed steps reproduces the
            # remaining stream; theta depends only on the per-step sequence,
            # not on how it is chunked into windows.
            skip = self.start_batch if epoch == self.start_epoch else 0
            for start in range(skip, steps_per_epoch, window):
                chunk = idx_mat[start:start + window]
                prof = (_start_trace(self.device)
                        if chunks_done == prof_chunk else None)
                with counted() as counts:
                    m = self.learner.train_steps_from_compact(chunk)
                m = {k: v.cpu().numpy() for k, v in m.items()}  # sync point
                if prof is not None:
                    self._stop_trace(prof)
                chunks_done += 1
                dt = max(time.time() - win_t, 1e-9)
                win_t = time.time()
                n_steps = int(chunk.shape[0])
                self.global_step += n_steps
                self._log_window(epoch, start, n_steps, m, dt, mean_edges,
                                 counts)
                steps_since_save += n_steps
                if (cfg.checkpoint_every_steps
                        and steps_since_save >= cfg.checkpoint_every_steps):
                    # window-granular mid-epoch snapshot: `start + n_steps`
                    # steps of this epoch are consumed
                    self._save(epoch, batch_in_epoch=start + n_steps)
                    steps_since_save = 0
            self._end_epoch(epoch)

        return self._final_test(t_start)

    def _fit_host_pool(self, pool_np: TaskBatch, t_start: float,
                       mean_edges: float) -> FitResult:
        """Windowed host-resident pool: the packed pool lives in host
        memory; each K = cfg.host_pool_window meta-steps run over one window
        buffer. A producer thread gathers and encodes the windows (queue
        depth 2). On CUDA it encodes into one of two pinned buffers, which
        the main thread copies to the device without blocking on a copy
        stream; a buffer is refilled only after its copy's event completed.
        Window N's metrics (and, where it saves, theta and the Adam state)
        are copied to the host in stream order right after its steps, and
        read after window N+1 is enqueued, so the host's gather, encode and
        copy of a window overlap the previous window's device work. Its
        seconds are measured between stream-ordered marks (StreamClock),
        since the host clock runs up to a window ahead of the card."""
        cfg = self.cfg
        n_tasks = len(self.datasets["train"])
        steps_per_epoch = n_tasks // cfg.task_num
        window = max(1, min(cfg.host_pool_window, steps_per_epoch))

        # (pinned buffer, event of its last copy) pairs free to fill
        free = None
        if self.device.type == "cuda":
            words = (MetaLearner.compact_pool_bytes(pool_np) // (4 * n_tasks)
                     * window * cfg.task_num)
            free = queue.Queue()
            for _ in range(2):
                free.put((torch.empty(words, dtype=torch.int32,
                                      pin_memory=True), None))
        prof_window = 1 if cfg.profile_dir else -1
        windows_done = 0
        clock = StreamClock(self.device)

        steps_since_save = 0
        for epoch in range(self.start_epoch, cfg.epoch):
            idx_mat = self._epoch_steps(epoch)
            skip = self.start_batch if epoch == self.start_epoch else 0
            starts = list(range(skip, steps_per_epoch, window))
            q: "queue.Queue" = queue.Queue(maxsize=2)
            stop = threading.Event()

            def produce():
                try:
                    for start in starts:
                        if stop.is_set():
                            return
                        rows = idx_mat[start:start + window]
                        slot = out = None
                        if free is not None:
                            slot, copied = free.get()
                            if copied is not None:
                                copied.synchronize()
                            out = slot.numpy()
                        buf, codec = self.learner.encode_window(
                            take_tasks(pool_np, rows.reshape(-1)),
                            cfg.task_num, out=out)
                        if slot is not None:
                            buf = slot[:buf.size]
                        q.put((start, int(rows.shape[0]), buf, codec, slot))
                    q.put(None)
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    q.put(e)

            def consume(p, epoch=epoch):
                start, n_steps, (m, snap), landed, t0, t1, counts = p
                if landed is not None:
                    landed.synchronize()          # window N only, not N+1
                m = {k: v.numpy() for k, v in m.items()}
                dt = max(clock.seconds(t0, t1), 1e-9)
                self.global_step += n_steps
                self._log_window(epoch, start, n_steps, m, dt, mean_edges,
                                 counts)
                if snap is not None:
                    self._save(epoch, batch_in_epoch=start + n_steps,
                               params=snap[0], opt_state=snap[1])

            th = threading.Thread(target=produce, daemon=True)
            th.start()
            # (start, n_steps, host copies, event, marks, counts)
            pending = None
            prof = None
            mark = clock.mark()
            try:
                while True:
                    item = q.get()
                    if item is None:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    start, n_steps, buf, codec, slot = item
                    if windows_done == prof_window:
                        prof = _start_trace(self.device)
                    dev, copied = self.learner.put_buffer(buf, codec)
                    if slot is not None:
                        free.put((slot, copied))
                    with counted() as counts:
                        m = self.learner.train_steps_from_window(
                            dev, cfg.task_num)
                    end = clock.mark()
                    steps_since_save += n_steps
                    snap = None
                    if (cfg.checkpoint_dir and cfg.checkpoint_every_steps
                            and steps_since_save
                            >= cfg.checkpoint_every_steps):
                        # theta is updated in place: the copies below are
                        # taken in stream order, before the next window's
                        # steps change it
                        snap = (self.learner.params, self.learner.opt_state)
                        steps_since_save = 0
                    copies, landed = _host_copies((m, snap), self.device)
                    if pending is not None:
                        consume(pending)
                        if windows_done == prof_window + 1:
                            self._stop_trace(prof)
                            prof = None
                    pending = (start, n_steps, copies, landed, mark, end,
                               counts)
                    mark = end
                    windows_done += 1
                if pending is not None:
                    consume(pending)
                if prof is not None:
                    self._stop_trace(prof)
            finally:
                # a loop that stopped early leaves the producer blocked on
                # the queue or on a free buffer: release it and wait for it
                stop.set()
                while th.is_alive():
                    try:
                        item = q.get(timeout=0.1)
                    except queue.Empty:
                        continue
                    if isinstance(item, tuple) and item[-1] is not None:
                        free.put((item[-1], None))
                th.join()
            self._end_epoch(epoch)

        return self._final_test(t_start)

    def _final_test(self, t_start: float) -> FitResult:
        # final test: last model, then best model (train.py:129-146)
        cfg = self.cfg
        last_curves = self.evaluate("test")
        best_curves = self.evaluate("test", params=self.best_params)
        last_mean = last_curves.mean(axis=0)
        best_mean = best_curves.mean(axis=0)
        # reference-style contaminated average (train.py:130-146: the list is
        # not reset between the two loops)
        contaminated = np.concatenate([last_curves, best_curves], 0).mean(0)

        self.metrics.echo_line(f"Test acc: {last_mean[1]:.3f}")
        self.metrics.echo_line(f"Early Stopped Test acc: {contaminated[-1]:.3f}")
        self.metrics.echo_line(f"Total Time: {time.time() - t_start:.1f}")
        result = FitResult(
            test_acc_ref=float(last_mean[1]),
            test_acc_final=float(last_mean[-1]),
            best_test_acc=float(best_mean[-1]),
            early_stopped_ref=float(contaminated[-1]),
            val_max_acc=self.max_acc,
            epochs_run=cfg.epoch - self._fit_from_epoch,
            global_step=self.global_step)
        self.metrics.log("fit_result", **dataclasses.asdict(result))
        return result


def _wait(mark) -> None:
    """Wait for a StreamClock mark's work (a host mark has none left)."""
    if not isinstance(mark, float):
        mark.synchronize()


def _host_copies(tree, device: torch.device):
    """Host copies of the tensors in a tree of dicts, tuples and
    NamedTuples, taken in stream order, so that later in-place updates do
    not reach them. On CUDA they go to pinned memory without waiting for
    the card, and the returned event completes when they have landed (with
    the work queued so far, not any queued later); elsewhere they are
    plain clones and the event is None."""
    cuda = device.type == "cuda"

    def copy(x):
        if isinstance(x, torch.Tensor):
            x = x.detach()
            if not cuda:
                return x.clone()
            return torch.empty(x.shape, dtype=x.dtype,
                               pin_memory=True).copy_(x, non_blocking=True)
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*map(copy, x))
        if isinstance(x, (tuple, list)):
            return type(x)(map(copy, x))
        return x

    out = copy(tree)
    if not cuda:
        return out, None
    landed = torch.cuda.Event()
    landed.record(torch.cuda.current_stream(device))
    return out, landed


def _start_trace(device: torch.device):
    """Start torch.profiler: host activity, and the card's on CUDA; the
    window's spans start afresh."""
    from torch.profiler import ProfilerActivity, profile
    clear_spans()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_trace(prof, out_dir: str, device: torch.device, name: str) -> str:
    """Stop a profiler once the device has finished the traced work, and
    write its Chrome trace into out_dir; returns the file's path."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"trace_{name}.json")
    prof.export_chrome_trace(path)
    return path


# ---- dataset assembly ------------------------------------------------------

def build_datasets(cfg: Config):
    """Load an on-disk dataset (reference format) and build the three
    episodic MetaDatasets. Returns (store, datasets, labels_num).

    The extractor: `native` is the C++ engine (data/native.py), or an error
    where it cannot be built; `auto` is the engine where it can be built,
    else numpy; `numpy` is the numpy path. With the engine and
    `extract_disk_cache`, extractions are read from and written to a cache
    beside the dataset (data/extract_cache.py)."""
    from gmeta_tpu_torch.data import extract_cache, native
    from gmeta_tpu_torch.data.extract import SubgraphExtractor
    from gmeta_tpu_torch.data.io import Dataset
    from gmeta_tpu_torch.data.pipeline import map_labels

    data = Dataset(cfg.data_dir, cfg.task_setup, cfg.link_pred_mode,
                   task_mode=cfg.task_mode, task_n=cfg.task_n)
    use_native = (cfg.extractor == "native"
                  or (cfg.extractor == "auto" and native.available()))
    cache_file = None
    if use_native:
        extractor = native.NativeSubgraphExtractor(
            data.store.graphs, h=cfg.h, sample_nodes=cfg.sample_nodes,
            seed=cfg.seed, n_threads=max(cfg.num_workers, 0),
            cap_strategy=cfg.cap_strategy)
        if cfg.extract_disk_cache:
            # sound only for the native engine: its cap RNG is content-
            # derived per name, so partial caches compose bit-exactly
            cache_file = extract_cache.cache_path(
                cfg.data_dir, cfg.h, cfg.sample_nodes, cfg.cap_strategy)
            if os.path.exists(cache_file):
                extractor.cache.update(extract_cache.load(cache_file))
                print(f"extraction cache: {len(extractor.cache)} subgraphs "
                      f"from {cache_file}")
    else:
        extractor = SubgraphExtractor(
            data.store.graphs, h=cfg.h, sample_nodes=cfg.sample_nodes,
            seed=cfg.seed, cap_strategy=cfg.cap_strategy)
    # Which backend runs matters for throughput debugging: with
    # extractor="auto" the numpy fallback is silent otherwise.
    print(f"extractor: {'native C++' if use_native else 'numpy'} "
          f"(requested {cfg.extractor!r})")
    # input_dim mirrors the reference: derived from the feature width at
    # load (train.py:67); a user-set nonzero value must agree with the data.
    if cfg.input_dim and cfg.input_dim != data.store.feat_dim:
        raise ValueError(
            f"input_dim={cfg.input_dim} != features width "
            f"{data.store.feat_dim}")
    cfg.input_dim = data.store.feat_dim

    datasets = {}
    # Per-split sampler-seed offsets, as in the JAX package: identical seeds
    # would correlate val and test episodes.
    salt = {"train": 0, "val": 101, "test": 202}
    dense = map_labels(data.labels)
    for mode in ("train", "val", "test"):
        split = data.splits[mode]
        datasets[mode] = MetaDataset(
            data.store, extractor, split["main"], data.labels,
            task_setup=cfg.task_setup, link_pred_mode=cfg.link_pred_mode,
            n_way=cfg.n_way, k_spt=cfg.k_spt, k_qry=cfg.k_qry,
            batchsz=cfg.batchsz if mode == "train" else cfg.eval_batchsz,
            index_spt=split.get("spt"), index_qry=split.get("qry"),
            seed=cfg.seed + salt[mode], dense_labels=dense)
    if cache_file is not None:
        known = 0
        if os.path.exists(cache_file):
            known = len(np.load(cache_file, allow_pickle=False)["names"])
        if len(extractor.cache) > known:
            # drop only THIS parameterization's superseded caches; other
            # (h, sample_nodes, cap) configs' caches stay valid; the ranks
            # of a mesh build at once, so another may have removed one
            for stale in extract_cache.stale_paths(cfg.data_dir, cache_file):
                Path(stale).unlink(missing_ok=True)
            extract_cache.save(cache_file, extractor.cache)
            print(f"extraction cache: wrote {len(extractor.cache)} "
                  f"subgraphs to {cache_file}")
    # output dim: Disjoint -> n_way; Shared -> total class count
    # (train.py:58-61)
    labels_num = cfg.n_way if cfg.task_setup == "Disjoint" else data.total_class
    return data.store, datasets, labels_num


def rank_device(device_arg: Optional[str], backend_arg: Optional[str]):
    """(device, backend) of this rank under the launch model of the module
    docstring. Raises, before any process group exists, where a rank has no
    card of its own and no --device, and where NCCL is asked for ranks
    that share a device; gloo on CUDA runs only when asked for."""
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if device_arg is not None:
        device = resolve_device(device_arg)
    else:
        resolve_device(None)                  # raises without CUDA
        n = torch.cuda.device_count()
        if local_rank >= n:
            raise RuntimeError(
                f"LOCAL_RANK {local_rank} has no card of its own ({n} CUDA "
                f"devices here); pass --device to choose one")
        device = resolve_device(f"cuda:{local_rank}")
    backend = backend_arg or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"--dist_backend nccl needs CUDA devices, not "
                             f"{device}; use --dist_backend gloo")
        shared = (local_world > torch.cuda.device_count()
                  or (device_arg is not None and local_world > 1))
        if shared:
            raise ValueError(
                f"NCCL refuses ranks that share a card: {local_world} ranks "
                f"on this host"
                + (f" all pinned to {device} by --device"
                   if device_arg is not None else
                   f" and {torch.cuda.device_count()} CUDA devices")
                + "; give each rank its own card, or pass --dist_backend "
                  "gloo to run them over host memory")
    return device, backend


def main(argv=None):
    # allow_abbrev=False: flags must be spelled out, as in the JAX package.
    ap = argparse.ArgumentParser("gmeta_tpu_torch.run.train",
                                 allow_abbrev=False)
    ap.add_argument("--preset", choices=sorted(PRESETS), default=None)
    for f in dataclasses.fields(Config):
        if f.type in ("int", "float", "str"):
            ap.add_argument(f"--{f.name}",
                            type={"int": int, "float": float, "str": str}[f.type],
                            default=None)
        elif f.type == "bool":
            ap.add_argument(f"--{f.name}", type=lambda s: s == "True",
                            default=None)
    ap.add_argument("--mesh_tasks", type=int, default=0,
                    help="shard each meta-batch over this many ranks "
                         "(task data-parallelism)")
    ap.add_argument("--mesh_edges", type=int, default=0,
                    help="edge-partition the (union) graph over this many "
                         "ranks and train with the sharded full-graph "
                         "engine (run/edgepart.py) instead of packed "
                         "subgraphs; combines with --mesh_tasks for a "
                         "(task, edge) mesh")
    ap.add_argument("--device", default=None,
                    help="torch device of this rank; default cuda, or "
                         "cuda:LOCAL_RANK under a mesh (raises without one)")
    ap.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                    help="torch.distributed backend of a mesh; default nccl "
                         "on CUDA, gloo on the CPU")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset] if args.preset else Config()
    cfg = dataclasses.replace(cfg)
    for f in dataclasses.fields(Config):
        v = getattr(args, f.name, None)
        if v is not None:
            setattr(cfg, f.name, v)
    cfg.validate(mesh_tasks=args.mesh_tasks, mesh_edges=args.mesh_edges)

    if not (args.mesh_tasks or args.mesh_edges):
        device = resolve_device(args.device)
        store, datasets, labels_num = build_datasets(cfg)
        trainer = Trainer(cfg, store, datasets, labels_num, device=device)
        result = trainer.fit()
        print(result)
        return result

    import torch.distributed as dist
    task, edge = max(args.mesh_tasks, 1), max(args.mesh_edges, 1)
    world = (dist.get_world_size() if dist.is_initialized()
             else mesh_mod.env_world())
    if task * edge > world:
        raise ValueError(
            f"--mesh_tasks {args.mesh_tasks} --mesh_edges {args.mesh_edges} "
            f"needs {task * edge} ranks, but the world has {world}: "
            f"{mesh_mod.launch_hint(task * edge)}")
    device, backend = rank_device(args.device, args.dist_backend)
    created = mesh_mod.init_distributed(backend, device)
    try:
        mesh = mesh_mod.make_mesh(task=task, edge=edge, device=device)
        if args.mesh_edges:
            from gmeta_tpu_torch.run.edgepart import (EdgePartTrainer,
                                                      build_edgepart_tasks)
            store, tasks, labels_num = build_edgepart_tasks(cfg)
            trainer = EdgePartTrainer(cfg, store, tasks, labels_num, mesh)
        else:
            store, datasets, labels_num = build_datasets(cfg)
            trainer = Trainer(cfg, store, datasets, labels_num,
                              device=device, mesh=mesh)
        result = trainer.fit()
    finally:
        if created:
            dist.destroy_process_group()
    if mesh.rank == 0:
        print(result)
    return result


if __name__ == "__main__":
    main()
