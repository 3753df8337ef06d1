"""Edge-partitioned training: the reference's full protocol
(G-Meta/train.py:86-148: epoch loop, per-epoch validation, early-stopping
snapshot, dual final test) on a graph sharded across the mesh's 'edge'
axis, with task data-parallelism over its 'task' axis
(parallel/edgepart_train.py).

Counterpart of gmeta_tpu/run/edgepart.py. This is the scale path for
datasets whose full-graph activations exceed one card's memory
(Tree-of-Life is the motivating recipe). No subgraphs are extracted: the
store's graphs become ONE disjoint-union CSR graph partitioned by edges,
episodes address centers by global node id, and each GCN layer ships only
the boundary rows other shards reference. Semantically this is the UNCAPPED
neighbourhood variant: the reference's `sample_nodes` cap truncates large
h-hop ego-nets, the full-graph computation does not.

Every run logs its per-layer communication: `comm_rows` (boundary rows
shipped per layer) against `allgather_rows` (what an all-gather of every
shard's rows would ship).

Only rank 0 writes metrics and checkpoints; a barrier after each save lets
a killed-and-resumed run see a whole file, and every rank restores.

CLI: python -m gmeta_tpu_torch.run.train --mesh_edges D [--mesh_tasks T] ...
(launched on T x D ranks, see run/train.py).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from gmeta_tpu_torch.config import Config
from gmeta_tpu_torch.data.graph import CSRGraph, GraphStore
from gmeta_tpu_torch.data.pipeline import map_labels
from gmeta_tpu_torch.data.sampler import EpisodeSampler
from gmeta_tpu_torch.parallel.edgepart_train import (EdgePartMetaTrainer,
                                                     EdgePartTask)
from gmeta_tpu_torch.run.train import (FitResult, _start_trace, _stop_trace,
                                       rank_metrics)
from gmeta_tpu_torch.utils import checkpoint as ckpt
from gmeta_tpu_torch.utils.metrics import rss_gb


def union_graph(store: GraphStore) -> CSRGraph:
    """Disjoint union of every graph in the store, nodes renumbered by the
    store's global ids (graph_offset + local id). Edges never cross graphs,
    so the union CSR is the per-graph CSRs concatenated with shifted
    indices, the same global id space the packed feature table uses."""
    indptrs = [g.indptr for g in store.graphs]
    edge_off = np.zeros(len(indptrs) + 1, dtype=np.int64)
    np.cumsum([g.num_edges for g in store.graphs], out=edge_off[1:])
    indptr = np.concatenate(
        [indptrs[0][:1]] + [ip[1:] + off for ip, off
                            in zip(indptrs, edge_off[:-1])])
    indices = np.concatenate(
        [g.indices.astype(np.int64) + store.node_offsets[i]
         for i, g in enumerate(store.graphs)])
    if indices.max(initial=0) >= np.iinfo(np.int32).max:
        raise ValueError("the union graph's node ids exceed int32")
    return CSRGraph(indptr=indptr, indices=indices.astype(np.int32))


def episodes_to_tasks(sampler: EpisodeSampler, labels: Dict[str, int],
                      store: GraphStore, task_setup: str,
                      seed: int = 0) -> EdgePartTask:
    """Every episode of a sampler as one stacked EdgePartTask (leading axis
    = episode). Names 'g_i' / 'g_i_j' map to global center ids; Disjoint
    episodes get the reference's shuffled relabel to 0..n_way-1
    (subgraph_data_processing.py:389-397)."""
    rng = np.random.RandomState(seed)

    def centers_of(names: List[str]) -> np.ndarray:
        out = np.zeros((len(names), 2), dtype=np.int64)
        for r, nm in enumerate(names):
            parts = [int(p) for p in nm.split("_")]
            off = store.node_offsets[parts[0]]
            out[r, 0] = off + parts[1]
            out[r, 1] = off + (parts[2] if len(parts) > 2 else parts[1])
        return out

    spt_c, spt_y, qry_c, qry_y = [], [], [], []
    for i in range(len(sampler.support_x_batch)):
        s_names = [n for grp in sampler.support_x_batch[i] for n in grp]
        q_names = [n for grp in sampler.query_x_batch[i] for n in grp]
        sy = np.array([labels[n] for n in s_names], dtype=np.int64)
        qy = np.array([labels[n] for n in q_names], dtype=np.int64)
        if task_setup == "Disjoint":
            uniq = np.unique(sy)
            rng.shuffle(uniq)
            s_rel, q_rel = np.zeros_like(sy), np.zeros_like(qy)
            for slot, l in enumerate(uniq):
                s_rel[sy == l] = slot
                q_rel[qy == l] = slot
            sy, qy = s_rel, q_rel
        spt_c.append(centers_of(s_names))
        spt_y.append(sy)
        qry_c.append(centers_of(q_names))
        qry_y.append(qy)

    return EdgePartTask(
        np.stack(spt_c).astype(np.int32), np.stack(spt_y).astype(np.int32),
        np.stack(qry_c).astype(np.int32), np.stack(qry_y).astype(np.int32))


def _slice_task(t: EdgePartTask, idxs: np.ndarray) -> EdgePartTask:
    return EdgePartTask(*(np.asarray(a)[idxs] for a in t))


class EdgePartTrainer:
    """run/train.py's Trainer protocol over the edge-partitioned engine,
    on every rank of `mesh`."""

    def __init__(self, cfg: Config, store: GraphStore,
                 tasks: Dict[str, EdgePartTask], labels_num: int, mesh):
        self.cfg = cfg
        self.tasks = tasks
        self.mesh = mesh
        self.metrics = rank_metrics(cfg.metrics_path, mesh)

        layer_dims = [(store.feat_dim, cfg.hidden_dim)]
        layer_dims += [(cfg.hidden_dim, cfg.hidden_dim)] * (cfg.h - 1)
        g = union_graph(store)
        self.engine = EdgePartMetaTrainer(
            layer_dims, (cfg.hidden_dim, labels_num), labels_num,
            g=g, feats=store.features, mesh=mesh,
            link_pred=cfg.link_pred_mode,
            update_lr=cfg.update_lr, meta_lr=cfg.meta_lr,
            update_step=cfg.update_step,
            update_step_test=cfg.update_step_test,
            first_order=cfg.first_order, seed=cfg.seed)

        # per-layer communication: boundary rows shipped against the
        # all-gather alternative (every shard's Vb rows to every other)
        D = mesh.edge
        plan = self.engine.plan
        self.comm = {
            "edge_shards": D,
            "comm_rows_per_layer": int(plan.comm_rows),
            "allgather_rows_per_layer": int(self.engine.sg.Vb * D * (D - 1)),
            "local_edges": int(plan.local_edges),
            "remote_edges": int(plan.remote_edges),
        }
        self.metrics.echo_line(
            f"edge partition: {D} shards, comm {self.comm['comm_rows_per_layer']}"
            f" rows/layer vs all-gather {self.comm['allgather_rows_per_layer']}"
            f" ({plan.remote_edges}/{plan.local_edges + plan.remote_edges}"
            " edges remote)")
        self.metrics.log("edgepart_comm", **self.comm)

        self.max_acc = 0.0
        self.best_params = self.engine.params
        self.start_epoch = 0
        self.start_batch = 0   # in-epoch step position (mid-epoch resume)
        self.global_step = 0
        if cfg.checkpoint_dir:
            path = ckpt.latest_path(cfg.checkpoint_dir)
            if path:
                self._restore(path)

    # ---- checkpointing (run/train.Trainer's on-disk schema) -----------------

    def _restore(self, path: str):
        state = ckpt.restore(path)
        self.engine.set_params(state["params"], state["opt_state"])
        self.max_acc = float(state["max_acc"])
        self.best_params = tuple(torch.as_tensor(p).to(self.engine.device)
                                 for p in state["best_params"])
        self.global_step = int(state["step"])
        batch_in_epoch = int(state.get("batch_in_epoch", -1))
        if batch_in_epoch >= 0:
            # mid-epoch snapshot: the epoch's step stream is a pure function
            # of (seed, epoch), so the position alone pins the remainder
            self.start_epoch = int(state["epoch"])
            self.start_batch = batch_in_epoch
        else:
            self.start_epoch = int(state["epoch"]) + 1
            self.start_batch = 0
        self.metrics.echo_line(
            f"resumed from {path} at epoch {self.start_epoch}"
            f" batch {self.start_batch}")

    def _save(self, epoch: int, batch_in_epoch: int = -1):
        if not self.cfg.checkpoint_dir:
            return
        if self.mesh.rank == 0:
            ckpt.save(self.cfg.checkpoint_dir, self.global_step, {
                "params": self.engine.params,
                "opt_state": self.engine.opt_state,
                "best_params": self.best_params,
                "max_acc": self.max_acc,
                "epoch": epoch,
                "batch_in_epoch": batch_in_epoch,
                "step": self.global_step,
            })
        self.mesh.barrier()

    # ---- evaluation ----------------------------------------------------------

    def evaluate(self, split: str, params=None) -> np.ndarray:
        """(n_tasks, update_step_test+1) accuracy curves, in padded chunks
        of task_num rounded up to a multiple of the task groups (the ragged
        tail repeats tasks, whose rows are dropped)."""
        t = self.tasks[split]
        n = t.spt_centers.shape[0]
        A = self.engine.n_tasks_axis
        chunk = ((max(self.cfg.task_num, 1) + A - 1) // A) * A
        curves = []
        for s in range(0, n, chunk):
            idxs = np.arange(s, min(s + chunk, n))
            if len(idxs) < chunk:
                idxs = np.concatenate([idxs, np.arange(chunk - len(idxs))])
            curves.append(self.engine.finetune_batch(
                _slice_task(t, idxs), params=params))
        return np.concatenate(curves, axis=0)[:n]

    # ---- training ------------------------------------------------------------

    def fit(self) -> FitResult:
        cfg = self.cfg
        train = self.tasks["train"]
        n_tasks = train.spt_centers.shape[0]
        steps_per_epoch = n_tasks // cfg.task_num
        t_start = time.time()
        win_t, win_steps = time.time(), 0
        # edges per task: the full-graph path aggregates the WHOLE union
        # graph for every task, so edges/s measures full-graph aggregation
        # throughput per layer pass
        graph_edges = self.comm["local_edges"] + self.comm["remote_edges"]
        comm_rows = self.comm["comm_rows_per_layer"]
        # profiler window: skip the first step, trace cfg.profile_steps
        prof_stop = (self.global_step + 1 + cfg.profile_steps
                     if cfg.profile_dir else -1)
        prof = None
        steps_since_save = 0
        device = self.engine.device

        for epoch in range(self.start_epoch, cfg.epoch):
            rng = np.random.RandomState(cfg.seed + epoch)
            order = rng.permutation(n_tasks)[:steps_per_epoch * cfg.task_num]
            skip = self.start_batch if epoch == self.start_epoch else 0
            for step in range(skip, steps_per_epoch):
                s = step * cfg.task_num
                if prof is None and \
                        self.global_step == prof_stop - cfg.profile_steps:
                    prof = _start_trace(device)
                m = self.engine.train_step(
                    _slice_task(train, order[s:s + cfg.task_num]))
                if prof is not None and self.global_step + 1 >= prof_stop:
                    self._stop_trace(prof)
                    prof = None
                win_steps += 1
                if step % cfg.train_result_report_steps == 0:
                    acc = float(m["qry_acc"])  # sync point
                    dt = max(time.time() - win_t, 1e-9)
                    tasks_per_s = win_steps * cfg.task_num / dt
                    win_t, win_steps = time.time(), 0
                    self.metrics.echo_line(
                        f"Epoch: {epoch + 1}  Step: {step}  training acc: "
                        f"{acc:.3f}  tasks/s: {tasks_per_s:.2f}  Memory "
                        f"usage (process RSS, GiB): {rss_gb():.1f}")
                    self.metrics.log(
                        "train_step", epoch=epoch, step=self.global_step,
                        qry_acc=acc, meta_loss=float(m["meta_loss"]),
                        nan_skip=int(m["nan_skip"]),
                        tasks_per_s=round(tasks_per_s, 2),
                        edges_per_s=round(tasks_per_s * graph_edges, 1),
                        comm_rows_per_layer=comm_rows,
                        rss_gb=rss_gb())
                self.global_step += 1
                steps_since_save += 1
                if (cfg.checkpoint_every_steps
                        and steps_since_save >= cfg.checkpoint_every_steps):
                    self._save(epoch, batch_in_epoch=step + 1)
                    steps_since_save = 0

            curves = self.evaluate("val")
            acc_curve = curves.mean(axis=0)
            self.metrics.echo_line(
                f"Epoch: {epoch + 1}  Val acc: {acc_curve[-1]:.3f}")
            self.metrics.log("val", epoch=epoch, step=self.global_step,
                             acc_curve=acc_curve.tolist())
            if acc_curve[-1] > self.max_acc:
                self.max_acc = float(acc_curve[-1])
                self.best_params = self.engine.params
            if (epoch + 1) % cfg.checkpoint_every_epochs == 0:
                self._save(epoch)

        if prof is not None:  # fewer total steps than the requested window
            self._stop_trace(prof)

        # dual final test incl. the reference's contaminated average
        # (train.py:129-146)
        last_curves = self.evaluate("test")
        best_curves = self.evaluate("test", params=self.best_params)
        last_mean = last_curves.mean(axis=0)
        best_mean = best_curves.mean(axis=0)
        contaminated = np.concatenate([last_curves, best_curves], 0).mean(0)
        self.metrics.echo_line(f"Test acc: {last_mean[1]:.3f}")
        self.metrics.echo_line(
            f"Early Stopped Test acc: {contaminated[-1]:.3f}")
        self.metrics.echo_line(f"Total Time: {time.time() - t_start:.1f}")
        result = FitResult(
            test_acc_ref=float(last_mean[1]),
            test_acc_final=float(last_mean[-1]),
            best_test_acc=float(best_mean[-1]),
            early_stopped_ref=float(contaminated[-1]),
            val_max_acc=self.max_acc,
            epochs_run=cfg.epoch - self.start_epoch,
            global_step=self.global_step)
        self.metrics.log("fit_result", **dataclasses.asdict(result))
        return result

    def _stop_trace(self, prof) -> None:
        path = _stop_trace(prof, self.cfg.profile_dir, self.engine.device,
                           f"step{self.global_step:08d}_rank{self.mesh.rank}")
        self.metrics.echo_line(f"profiler trace written to {path}")


def build_edgepart_tasks(cfg: Config):
    """Load the on-disk dataset and sample the three splits' episodes as
    EdgePartTask stacks (no extraction: centers are global ids)."""
    from gmeta_tpu_torch.data.io import Dataset

    data = Dataset(cfg.data_dir, cfg.task_setup, cfg.link_pred_mode,
                   task_mode=cfg.task_mode, task_n=cfg.task_n)
    cfg.input_dim = data.store.feat_dim
    dense, _ = map_labels(data.labels)
    salt = {"train": 0, "val": 101, "test": 202}
    tasks = {}
    for mode in ("train", "val", "test"):
        split = data.splits[mode]
        sampler = EpisodeSampler(
            cfg.task_setup, cfg.link_pred_mode, cfg.n_way, cfg.k_spt,
            cfg.k_qry, cfg.batchsz if mode == "train" else cfg.eval_batchsz,
            split["main"], index_spt=split.get("spt"),
            index_qry=split.get("qry"), seed=cfg.seed + salt[mode])
        tasks[mode] = episodes_to_tasks(
            sampler, dense, data.store, cfg.task_setup,
            seed=cfg.seed + salt[mode])
    labels_num = (cfg.n_way if cfg.task_setup == "Disjoint"
                  else data.total_class)
    return data.store, tasks, labels_num
