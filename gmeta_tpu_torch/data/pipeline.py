"""Task materialization + meta-batch streaming.

Equivalent of the reference's `Subgraphs.__getitem__` + DataLoader
(subgraph_data_processing.py:348-419, train.py:96): extract every subgraph of
a task, relabel Disjoint tasks to 0..n_way-1 with a shuffled class->slot map
(:389-397), and pack into static-shape arrays. Tasks are pre-sampled like the
reference; subgraphs are memoized so epochs after the first are pure cache
hits. Batches are packed on demand (cheap flat numpy copies) and optionally
prefetched on a background thread — replacing torch DataLoader workers.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from gmeta_tpu_torch.data.extract import SubgraphExtractor
from gmeta_tpu_torch.data.io import SplitIndex
from gmeta_tpu_torch.data.graph import GraphStore
from gmeta_tpu_torch.data.pack import TaskBatch, pack_set, stack_tasks
from gmeta_tpu_torch.data.sampler import EpisodeSampler


class _RawTask:
    __slots__ = ("spt_subs", "spt_graphs", "spt_labels",
                 "qry_subs", "qry_graphs", "qry_labels")

    def __init__(self, spt_subs, spt_graphs, spt_labels,
                 qry_subs, qry_graphs, qry_labels):
        self.spt_subs = spt_subs
        self.spt_graphs = spt_graphs
        self.spt_labels = spt_labels
        self.qry_subs = qry_subs
        self.qry_graphs = qry_graphs
        self.qry_labels = qry_labels


def map_labels(labels: Dict[str, int]) -> tuple:
    """(mapped_dict, label_to_id): raw label values -> dense ids preserving
    sorted order (the reference's torch.unique order, meta.py:35,60). When
    labels are already dense 0..C-1 (every shipped dataset), the dict is
    returned as-is — no copy."""
    uniq = sorted(set(labels.values()))
    label_to_id = {v: i for i, v in enumerate(uniq)}
    if all(v == i for i, v in enumerate(uniq)):
        return labels, label_to_id
    return {k: label_to_id[v] for k, v in labels.items()}, label_to_id


class MetaDataset:
    """One split's pre-sampled episodic tasks, ready to stream as TaskBatches."""

    def __init__(self, store: GraphStore, extractor: SubgraphExtractor,
                 index: SplitIndex, labels: Dict[str, int],
                 task_setup: str, link_pred_mode: bool,
                 n_way: int, k_spt: int, k_qry: int, batchsz: int,
                 index_spt: Optional[SplitIndex] = None,
                 index_qry: Optional[SplitIndex] = None,
                 seed: int = 222,
                 dense_labels: Optional[tuple] = None):
        self.store = store
        self.extractor = extractor
        self.task_setup = task_setup
        self.link_pred_mode = link_pred_mode
        self.n_way = n_way
        self.rng = np.random.RandomState(seed + 1)

        # Map raw label values to dense ids preserving sorted order, so
        # prototype rows keep the reference's `torch.unique` (sorted) order
        # (meta.py:35,60). Shared-mode labels are used unmapped by the
        # reference; datasets ship them dense, and this map is then identity.
        # `dense_labels` = (mapped_dict, label_to_id) precomputed by the
        # caller and SHARED across the three split datasets — at
        # Tree-of-Life scale the label dict has ~70M entries and three
        # private remapped copies would cost tens of GB (see map_labels).
        if dense_labels is not None:
            self.labels, self.label_to_id = dense_labels
        else:
            self.labels, self.label_to_id = map_labels(labels)
        self.num_classes = len(self.label_to_id)

        self.sampler = EpisodeSampler(
            task_setup, link_pred_mode, n_way, k_spt, k_qry, batchsz,
            index, index_spt=index_spt, index_qry=index_qry, seed=seed)

        # Native backend: pre-warm the cache with one threaded batch call
        # over every unique name in the pre-sampled episode pool.
        if hasattr(extractor, "extract_many"):
            all_names = sorted({
                n for i in range(batchsz)
                for group in (self.sampler.support_x_batch[i],
                              self.sampler.query_x_batch[i])
                for sub in group for n in sub})
            extractor.extract_many(all_names)

        self.tasks: List[_RawTask] = [
            self._materialize(i) for i in range(batchsz)]

        # Global static buckets for this split: P = bin capacity (max subgraph
        # size rounded up to a multiple of 128; bounded by the
        # sample_nodes cap), E = rounded max total edges of a task's set,
        # B = max bins any task needs under first-fit-decreasing packing
        # (pack.py). Aggregation cost scales with B*P^2 ~= total-nodes * P,
        # so P hugs the true max (fine 128-granularity, not power-of-two).
        from gmeta_tpu_torch.data.pack import num_bins, round_up
        self.P_spt = round_up(max(
            s.num_nodes for t in self.tasks for s in t.spt_subs), 128)
        self.E_spt = round_up(max(
            sum(s.num_edges for s in t.spt_subs) for t in self.tasks), 2048)
        self.P_qry = round_up(max(
            s.num_nodes for t in self.tasks for s in t.qry_subs), 128)
        self.E_qry = round_up(max(
            sum(s.num_edges for s in t.qry_subs) for t in self.tasks), 2048)
        self.B_spt = max(num_bins([s.num_nodes for s in t.spt_subs],
                                  self.P_spt) for t in self.tasks)
        self.B_qry = max(num_bins([s.num_nodes for s in t.qry_subs],
                                  self.P_qry) for t in self.tasks)

    # -- task materialization (reference __getitem__ :348-408) ---------------

    def _materialize(self, index: int) -> _RawTask:
        spt_names = [n for sub in self.sampler.support_x_batch[index] for n in sub]
        qry_names = [n for sub in self.sampler.query_x_batch[index] for n in sub]

        spt_subs = [self.extractor.extract(n) for n in spt_names]
        qry_subs = [self.extractor.extract(n) for n in qry_names]
        spt_graphs = [int(n.split("_")[0]) for n in spt_names]
        qry_graphs = [int(n.split("_")[0]) for n in qry_names]
        spt_y = np.array([self.labels[n] for n in spt_names], dtype=np.int64)
        qry_y = np.array([self.labels[n] for n in qry_names], dtype=np.int64)

        if self.task_setup == "Disjoint":
            # Shuffled relabel to 0..n_way-1 (:389-397).
            uniq = np.unique(spt_y)
            self.rng.shuffle(uniq)
            spt_rel = np.zeros_like(spt_y)
            qry_rel = np.zeros_like(qry_y)
            for slot, l in enumerate(uniq):
                spt_rel[spt_y == l] = slot
                qry_rel[qry_y == l] = slot
            spt_y, qry_y = spt_rel, qry_rel

        return _RawTask(spt_subs, spt_graphs, spt_y,
                        qry_subs, qry_graphs, qry_y)

    # -- packing + streaming ---------------------------------------------------

    def pack_task(self, t: _RawTask) -> TaskBatch:
        return TaskBatch(
            spt=pack_set(t.spt_subs, t.spt_graphs, t.spt_labels, self.store,
                         self.P_spt, self.E_spt, B=self.B_spt),
            qry=pack_set(t.qry_subs, t.qry_graphs, t.qry_labels, self.store,
                         self.P_qry, self.E_qry, B=self.B_qry),
        )

    def stacked_pool(self) -> TaskBatch:
        """All tasks packed + stacked (leading axis = batchsz), for placing
        the whole pre-sampled pool on the device once
        (MetaLearner.set_task_pool_compact) or gathering windows from it on
        the host."""
        return stack_tasks([self.pack_task(t) for t in self.tasks])

    def __len__(self) -> int:
        return len(self.tasks)

    @property
    def mean_bin_fill(self) -> float:
        """Mean live-node fraction of the packed bins across tasks (both
        sets), counting the split-global B (pad bins included). Near 1.0
        when FFD packs tight; low under high task-size variance."""
        tot_live = sum(sum(s.num_nodes for s in t.spt_subs)
                       + sum(s.num_nodes for s in t.qry_subs)
                       for t in self.tasks)
        slots = len(self.tasks) * (self.B_spt * self.P_spt
                                   + self.B_qry * self.P_qry)
        return tot_live / max(slots, 1)

    @property
    def suggested_agg(self) -> str:
        """Static aggregation-kernel choice for this split (models/gcn.py
        `agg`). The rule is the JAX package's, kept verbatim so that `auto`
        means the same in both packages: size-aware aggregation only when
        the mean bin fill is below 0.35. That threshold was measured on a
        TPU, not on this port's GPU kernels; until it is re-measured here
        it picks dense at every preset, so callers that want the kernels
        set agg="sized"."""
        if self.P_spt % 128 or self.P_qry % 128:
            return "dense"
        return "sized" if self.mean_bin_fill < 0.35 else "dense"

    @property
    def mean_edges_per_task(self) -> float:
        """Mean REAL (unpadded) spt+qry edges per task — the basis of the
        edges/s throughput metric (edges ingested per second of training)."""
        tot = sum(sum(s.num_edges for s in t.spt_subs)
                  + sum(s.num_edges for s in t.qry_subs) for t in self.tasks)
        return tot / max(len(self.tasks), 1)

    def batches(self, task_num: int, shuffle: bool = True,
                drop_last: bool = True,
                num_workers: int = 0,
                seed: Optional[int] = None,
                skip_batches: int = 0,
                pad_last: bool = False) -> Iterator[TaskBatch]:
        """Yield meta-batches as TaskBatch pytrees with a leading task axis.
        Passing `seed` makes the epoch's order a pure function of it, so
        checkpoint resume reproduces the stream; `skip_batches` fast-forwards
        past already-consumed batches (mid-epoch resume). `pad_last` pads a
        ragged final batch to task_num by repeating tasks (callers drop the
        padded rows), keeping one compiled shape per split."""
        order = np.arange(len(self.tasks))
        if shuffle:
            rng = self.rng if seed is None else np.random.RandomState(seed)
            rng.shuffle(order)
        n = len(order)
        limit = (n // task_num) * task_num if drop_last else n
        starts = list(range(skip_batches * task_num, limit, task_num))

        def make(start: int) -> TaskBatch:
            idxs = order[start:start + task_num]
            if pad_last and len(idxs) < task_num:
                idxs = np.concatenate(
                    [idxs, order[:task_num - len(idxs)]])
            return stack_tasks([self.pack_task(self.tasks[i])
                                for i in idxs])

        if num_workers <= 0:
            for s in starts:
                yield make(s)
            return

        # N producer threads pack batches concurrently (numpy copies release
        # the GIL); the consumer reassembles in stream order. Exceptions are
        # shipped across the queue and re-raised, keeping the inline path's
        # fail-fast semantics (a swallowed error would silently truncate the
        # epoch).
        workers = min(num_workers, len(starts)) or 1
        q: "queue.Queue" = queue.Queue(maxsize=2 * workers)
        work = queue.Queue()
        for i, s in enumerate(starts):
            work.put((i, s))

        def producer():
            while True:
                try:
                    i, s = work.get_nowait()
                except queue.Empty:
                    return
                try:
                    q.put((i, make(s)))
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    q.put((i, e))
                    return

        threads = [threading.Thread(target=producer, daemon=True)
                   for _ in range(workers)]
        for th in threads:
            th.start()
        pending: Dict[int, object] = {}
        for want in range(len(starts)):
            while want not in pending:
                i, item = q.get()
                pending[i] = item
            item = pending.pop(want)
            if isinstance(item, BaseException):
                raise item
            yield item
        for th in threads:
            th.join()
