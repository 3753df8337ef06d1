"""The streaming step split into packing, the host-to-device copy and
compute, at the arxiv cell's buckets (PERF.md §4: spt P 1024, B 9, E
18,432; qry P 1024, B 72, E 129,024; 32 tasks, hidden 256, 128 features),
with agg="sized", the port's main path.

Counterpart of scripts/bench_transfer.py, with its keys:

  pack_s            host: stack_tasks of the step's tasks
  transfer_s        the copy streaming makes today, `batch_to` of the
                    numpy batch (meta/maml.py: `.to(device)` of pageable
                    memory; index fields become int64 on the host), plus
                    a sync; also `transfer_pageable_s`
  transfer_pinned_s the same arrays from pinned buffers (filled in
                    `pin_s`), copied with non_blocking=True on a side
                    stream and converted on the card, as the host-windowed
                    pool copies (run/train.py `_fit_host_pool`)
  encode_s, transfer_window_s, window_mb
                    the host-windowed pool's own form: `encode_window`
                    into a pinned buffer, then `put_buffer` and a sync
  wire_mb           the numpy batch's bytes; copied_mb what `batch_to`
                    ships
  dispatch_s        one tiny kernel and a sync
  step_pool_s       a one-step `train_steps_from_compact`, synced: the
                    compact resident pool the Trainer runs, which
                    streaming is compared with
  step_stream_s     stack_tasks, then `train_step` of the numpy batch
                    (copy and compute), synced
  pool_tasks_per_s, stream_tasks_per_s

Before timing, one pool step and one stream step from the same theta
must give the same meta_loss. The batch is random (`synth_packed`, the
JAX script's draws): its edge sources may lie in another bin than their
destination, and the port clamps them into the destination's bin (`densify`,
`sized_graph`, the window codec alike).

    python -m gmeta_tpu_torch.scripts.bench_transfer [--tasks 32] [--reps 5]
        [--device cpu] [--out PATH]
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from gmeta_tpu_torch.data.pack import SubgraphSet, TaskBatch, stack_tasks
from gmeta_tpu_torch.meta.maml import MetaLearner, batch_to
from gmeta_tpu_torch.ops import sized_spmm as sp
from gmeta_tpu_torch.scripts.common import finish, parser, start
from gmeta_tpu_torch.utils.cardtime import sync
from gmeta_tpu_torch.utils.metrics import counted

ARXIV = (1024, 9, 18432, 1024, 72, 129024)   # P, B, E of spt, then qry


def synth_packed(T, P_spt, B_spt, E_spt, P_qry, B_qry, E_qry,
                 S_spt, S_qry, n_feat, rng):
    """A random packed TaskBatch at the given buckets (edges name slots of
    the bins, centers live slots); the JAX script's draws, bitwise."""

    def one_set(P, B, E, S):
        node_gid = rng.randint(0, n_feat, size=(T, B, P)).astype(np.int32)
        node_mask = np.ones((T, B, P), np.float32)
        bin_of = rng.randint(0, B, size=(T, E))
        src_l = rng.randint(0, P, size=(T, E))
        dst_l = rng.randint(0, P, size=(T, E))
        edge_src = (bin_of * P + src_l).astype(np.int32)
        edge_dst = np.sort((bin_of * P + dst_l).astype(np.int32), axis=1)
        edge_mask = np.ones((T, E), np.float32)
        centers = rng.randint(0, B * P, size=(T, S, 2)).astype(np.int32)
        labels = np.tile(np.arange(S) % 3, (T, 1)).astype(np.int32)
        bin_fill = np.full((T, B), P, np.int32)
        return SubgraphSet(node_gid, node_mask, edge_src, edge_dst,
                           edge_mask, centers, labels, bin_fill)

    return TaskBatch(spt=one_set(P_spt, B_spt, E_spt, S_spt),
                     qry=one_set(P_qry, B_qry, E_qry, S_qry))


def split_tasks(batch: TaskBatch):
    """The stacked batch as a list of one-task TaskBatches."""
    T = batch.spt.node_gid.shape[0]
    return [TaskBatch(*(SubgraphSet(*(x[i] for x in sg)) for sg in batch))
            for i in range(T)]


def make_learner(feat_dim, hidden, update_step, agg, device, n_feat, rng):
    """The JAX script's learner (3-way heads, lr 0.01 / 1e-3, 2 x
    update_step test steps), with a random feature table."""
    spec = (("GraphConv", (feat_dim, hidden)), ("GraphConv", (hidden, hidden)),
            ("Linear", (hidden, 3)))
    learner = MetaLearner(spec, 3, update_lr=0.01, meta_lr=1e-3,
                          update_step=update_step,
                          update_step_test=2 * update_step,
                          track_curve=False, agg=agg, device=device)
    learner.set_features(rng.randn(n_feat, feat_dim).astype(np.float32))
    return learner


def pool_and_stream_losses(learner, batch_np):
    """meta_loss of one compact pool step and one stream step from the same
    theta (Adam restarted for each), theta restored after; the pool stays."""
    theta = [p.detach().clone() for p in learner.params]
    T = batch_np.spt.node_gid.shape[0]
    learner.set_task_pool_compact(batch_np)
    pool = pool_step(learner, np.arange(T)[None])
    learner.set_params(theta)
    stream = learner.train_step(
        stack_tasks(split_tasks(batch_np)))["meta_loss"].item()
    learner.set_params(theta)
    return pool, stream


def pool_step(learner, idx_mat) -> float:
    """meta_loss of a compact pool call of one step, idx_mat (1, T)."""
    return learner.train_steps_from_compact(idx_mat)["meta_loss"][0].item()


def _seconds(fn, reps, device, warm=1):
    for _ in range(warm):
        fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync(device)
    return (time.perf_counter() - t0) / reps


def _pinned_copy(bufs, dtypes, device, stream):
    """The pinned buffers copied on `stream` without blocking, the compute
    stream waiting on the copy, then each field converted on the card to
    its dtype in `dtypes` (those `batch_to` gives)."""
    compute = torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        dev = [b.to(device, non_blocking=True) for b in bufs]
        done = torch.cuda.Event()
        done.record(stream)
    compute.wait_event(done)
    for d in dev:
        d.record_stream(compute)
    return [d.to(dt) for d, dt in zip(dev, dtypes)]


def main(argv=None):
    ap = parser("bench_transfer", __doc__)
    ap.add_argument("--tasks", type=int, default=32)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--buckets", type=int, nargs=6, default=ARXIV,
                    metavar=("P_SPT", "B_SPT", "E_SPT", "P_QRY", "B_QRY",
                             "E_QRY"))
    ap.add_argument("--n_feat", type=int, default=169_343)
    ap.add_argument("--feat_dim", type=int, default=128)
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--update_step", type=int, default=10)
    args = ap.parse_args(argv)
    device, head = start(args.device)
    cuda = device.type == "cuda"
    T, reps = args.tasks, args.reps
    rng = np.random.RandomState(0)
    learner = make_learner(args.feat_dim, args.hidden, args.update_step,
                           "sized", device, args.n_feat, rng)
    batch_np = synth_packed(T, *args.buckets, S_spt=9, S_qry=72,
                            n_feat=args.n_feat, rng=rng)
    leaves = [x for sg in batch_np for x in sg]
    wire_mb = sum(a.nbytes for a in leaves) / 1e6
    out = dict(head, tasks=T, agg="sized", buckets=list(args.buckets),
               hidden=args.hidden, feat_dim=args.feat_dim,
               update_step=args.update_step, reps=reps, wire_mb=wire_mb)
    launched = counted()

    # host: the per-step stack (packing is cached after the first epoch)
    per_task = split_tasks(batch_np)
    out["pack_s"] = _seconds(lambda: stack_tasks(per_task), reps, device)

    # the copy streaming makes: pageable memory, int64 indices from the host
    moved = [x for sg in batch_to(batch_np, device) for x in sg]
    dtypes = [x.dtype for x in moved]
    out["copied_mb"] = sum(x.numel() * x.element_size() for x in moved) / 1e6
    out["transfer_pageable_s"] = _seconds(lambda: batch_to(batch_np, device),
                                          reps, device, warm=2)
    out["transfer_s"] = out["transfer_pageable_s"]
    out["transfer_mb_s"] = wire_mb / out["transfer_s"]

    # pinned buffers on a side stream, as the host-windowed pool copies
    out["pin_s"] = out["transfer_pinned_s"] = None
    if cuda:
        bufs = [torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                            pin_memory=True) for a in leaves]

        def fill():
            for b, a in zip(bufs, leaves):
                b.numpy()[...] = a
        out["pin_s"] = _seconds(fill, reps, device)
        side = torch.cuda.Stream(device)
        got = _pinned_copy(bufs, dtypes, device, side)
        if not all(torch.equal(a, b) for a, b in zip(got, moved)):
            raise AssertionError("the pinned copy differs from batch_to's")
        del got
        out["transfer_pinned_s"] = _seconds(
            lambda: _pinned_copy(bufs, dtypes, device, side), reps, device,
            warm=2)
    del moved

    # the host-windowed pool's encoded window, one step of T tasks
    words = MetaLearner.compact_pool_bytes(batch_np) // 4
    wbuf = torch.empty(words, dtype=torch.int32, pin_memory=cuda)
    out["encode_s"] = _seconds(
        lambda: MetaLearner.encode_window(batch_np, T, out=wbuf.numpy()),
        reps, device)
    buf, codec = MetaLearner.encode_window(batch_np, T, out=wbuf.numpy())
    out["window_mb"] = buf.nbytes / 1e6
    out["transfer_window_s"] = _seconds(
        lambda: learner.put_buffer(wbuf[:buf.size], codec), reps, device,
        warm=2)

    # the card's round trip for one tiny kernel
    x = torch.zeros(8, device=device)
    out["dispatch_s"] = _seconds(lambda: (x.add_(1.0), sync(device)), 20,
                                 device)

    # one pool step and one stream step from the same theta agree
    pool, stream = pool_and_stream_losses(learner, batch_np)
    if not (math.isfinite(pool) and math.isclose(pool, stream,
                                                  rel_tol=1e-6)):
        raise AssertionError(f"pool step meta_loss {pool} != stream step "
                             f"{stream}")
    out["meta_loss_pool"], out["meta_loss_stream"] = pool, stream

    idxs = np.arange(T)[None]
    out["step_pool_s"] = _seconds(lambda: pool_step(learner, idxs), reps,
                                  device)
    out["step_stream_s"] = _seconds(
        lambda: learner.train_step(stack_tasks(per_task))["meta_loss"]
        .item(), reps, device)
    out["pool_tasks_per_s"] = T / out["step_pool_s"]
    out["stream_tasks_per_s"] = T / out["step_stream_s"]
    out["launches"] = launched.of(sp.LAUNCHES)
    if cuda and not all(out["launches"].values()):
        raise RuntimeError(f"the sized kernel did not launch both ways: "
                           f"{out['launches']}")

    keys = ("pack_s", "transfer_pageable_s", "pin_s", "transfer_pinned_s",
            "encode_s", "transfer_window_s", "dispatch_s", "step_pool_s",
            "step_stream_s", "pool_tasks_per_s", "stream_tasks_per_s",
            "wire_mb", "copied_mb", "window_mb")
    lines = ["| " + " | ".join(keys) + " |", "|---" * len(keys) + "|",
             "| " + " | ".join("-" if out[k] is None else f"{out[k]:.4f}"
                               for k in keys) + " |"]
    return finish(out, args.out, lines)


if __name__ == "__main__":
    main()
