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
from typing import Dict, Iterator, List, NamedTuple, Optional

import numpy as np
import torch

from gmeta_tpu_torch.data.extract import SubgraphExtractor
from gmeta_tpu_torch.data.io import SplitIndex
from gmeta_tpu_torch.data.graph import GraphStore
from gmeta_tpu_torch.data.pack import (TaskBatch, num_bins, pack_set,
                                       stack_tasks)
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


def jax_agg_rule(P_spt: int, P_qry: int, mean_bin_fill: float) -> str:
    """The JAX package's aggregation rule (gmeta_tpu/data/pipeline.py
    `suggested_agg`), verbatim: dense unless both bin capacities are
    multiples of 128 and the mean bin fill is below 0.35. It was set on
    the JAX package's hardware, where the size-aware kernel skips only
    dead 128-row tiles; `agg_for` applies it off the card."""
    if P_spt % 128 or P_qry % 128:
        return "dense"
    return "sized" if mean_bin_fill < 0.35 else "dense"


class SplitGeometry(NamedTuple):
    """What `agg_for` reads of a split, where there is no MetaDataset: a
    run of record's buckets, fill and real edges (bench.py)."""
    P_spt: int
    B_spt: int
    E_spt: int
    P_qry: int
    B_qry: int
    E_qry: int
    mean_edges_per_task: float
    mean_bin_fill: float

    @property
    def suggested_agg(self) -> str:
        return jax_agg_rule(self.P_spt, self.P_qry, self.mean_bin_fill)


def edges_per_slot(split) -> float:
    """Mean real edges per node slot of a split (a MetaDataset or a
    SplitGeometry): its real spt + qry edges per task over the task's
    B_spt P_spt + B_qry P_qry slots, pad slots and pad bins included."""
    slots = split.B_spt * split.P_spt + split.B_qry * split.P_qry
    return split.mean_edges_per_task / max(slots, 1)


# The card's crossover: real edges per slot above which one meta-step's
# aggregation work of a layer (2 precomputes, 22 forward and 12 transposed
# calls: update_step 10 with the curve) costs less dense (`densify`,
# torch.bmm) than sized (`sized_graph`, the CSR gather kernel), by compute
# dtype, bin capacity P and aggregated width H, over 128 bins a call, the
# lower of bin fills 0.5 and 0.8. Measured from 1 to 256 real edges per
# slot on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit (`nvidia-smi
# --query-gpu=name,power.limit --format=csv,noheader`):
# measure_torch/bench_crossover.json, written by `python -m
# gmeta_tpu_torch.scripts.bench_kernels --crossover`, whose
# `crossover_table` gives this table.
CARD_CROSSOVER = {
    "float32": {512: {1: 14.9, 5: 24.8, 50: 26.9, 128: 38.7, 256: 41.8},
                1024: {1: 56.9, 5: 78.7, 50: 66.6, 128: 77.2, 256: 86.8}},
    "bfloat16": {512: {1: 73.3, 5: 73.5, 50: 50.8, 128: 90.1, 256: 102.4},
                 1024: {1: 159.4, 5: 168.6, 50: 112.3, 128: 176.0,
                        256: 192.4}},
}


def _interp(x: float, table: Dict[int, float]) -> float:
    """Piecewise-linear in x over the table's keys, flat past its ends."""
    keys = sorted(table)
    if x <= keys[0]:
        return table[keys[0]]
    for lo, hi in zip(keys, keys[1:]):
        if x <= hi:
            return table[lo] + (x - lo) / (hi - lo) * (table[hi] - table[lo])
    return table[keys[-1]]


def card_crossover(P: int, H: int, dtype: str = "float32") -> float:
    """`CARD_CROSSOVER` at any P and H: piecewise linear in H between the
    measured widths (flat past them), linear in P between the measured
    capacities, and in proportion to P outside them (dense's work per slot
    grows as P, the gather's does not)."""
    by_P = CARD_CROSSOVER[dtype]
    at = {p: _interp(H, by_H) for p, by_H in by_P.items()}
    lo, hi = min(at), max(at)
    if P < lo:
        return at[lo] * P / lo
    if P > hi:
        return at[hi] * P / hi
    return _interp(P, at)


def aggregation_width(layer_spec=None) -> int:
    """The widest H the model aggregates: each GraphConv layer aggregates
    at the narrower of its widths (models/gcn.py projects first where it
    shrinks). Without a layer spec, the widest swept width."""
    widths = [min(dims) for name, dims in layer_spec or ()
              if name == "GraphConv"]
    return max(widths) if widths else max(CARD_CROSSOVER["float32"][512])


def agg_for(split, device, layer_spec=None, dtype: str = "float32") -> str:
    """What agg="auto" resolves to for a split (a MetaDataset or a
    SplitGeometry) on a device.

    On a CUDA device, the card's rule: "sized" where the split's real
    edges per slot (`edges_per_slot`) lie below `card_crossover` at its
    bin capacity, the model's widest aggregated width (`layer_spec`, see
    `aggregation_width`) and its compute dtype, else "dense". The gather
    kernel's time follows the edges and dense's the P x P slots, so
    edges per slot decide; no multiple of 128 is asked of P, since the
    kernel has no tile. The crossover was measured on an NVIDIA H100
    80GB HBM3 at 700.00 W (`CARD_CROSSOVER`,
    measure_torch/bench_crossover.json). Whole bench steps
    (scripts/bench_agg.py, measure_torch/bench_agg.json) went its way
    where the card sets the step: tree_of_life's buckets in float32 at
    half and twice its 86.8 edges per slot ran sized 1.31x faster, then
    dense 1.27x. Where the host sets the step (a few tasks of a few bins),
    sized still takes less device time, but which path's wall time is
    shorter changes from call to call.

    On any other device, `split.suggested_agg`: the JAX package's rule,
    so that the CPU resolves `auto` as the JAX package does.

    A GAT (models/gat.py) or a Graphormer (models/graphormer.py) has no
    dense path: "sized" on every device."""
    if layer_spec and layer_spec[0][0] in ("GATConv", "GraphormerEmbed"):
        return "sized"
    if torch.device(device).type != "cuda":
        return split.suggested_agg
    P = max(split.P_spt, split.P_qry)
    H = aggregation_width(layer_spec)
    return ("sized" if edges_per_slot(split) < card_crossover(P, H, dtype)
            else "dense")


def one_per_bin(layer_spec) -> bool:
    """Whether a model packs one subgraph a bin: a Graphormer
    (models/graphormer.py) attends over all nodes of a bin, which must
    then be one graph; every other model takes FFD's bins."""
    return bool(layer_spec) and layer_spec[0][0] == "GraphormerEmbed"


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
        # B = max bins any task needs under its placement (first-fit-
        # decreasing, pack.py; one subgraph a bin: `place_one_per_bin`).
        # Aggregation cost scales with B*P^2 ~= total-nodes * P, so P hugs
        # the true max (fine 128-granularity, not power-of-two).
        from gmeta_tpu_torch.data.pack import round_up
        self.P_spt = round_up(max(
            s.num_nodes for t in self.tasks for s in t.spt_subs), 128)
        self.E_spt = round_up(max(
            sum(s.num_edges for s in t.spt_subs) for t in self.tasks), 2048)
        self.P_qry = round_up(max(
            s.num_nodes for t in self.tasks for s in t.qry_subs), 128)
        self.E_qry = round_up(max(
            sum(s.num_edges for s in t.qry_subs) for t in self.tasks), 2048)
        self.one_per_bin = False
        self._set_bins()

    def _set_bins(self):
        """B of each set: the most bins a task's placement needs."""
        def bins(sizes, P):
            return len(sizes) if self.one_per_bin else num_bins(sizes, P)
        self.B_spt = max(bins([s.num_nodes for s in t.spt_subs], self.P_spt)
                         for t in self.tasks)
        self.B_qry = max(bins([s.num_nodes for s in t.qry_subs], self.P_qry)
                         for t in self.tasks)

    def place_one_per_bin(self, on: bool = True):
        """Pack one subgraph a bin from here on (a Graphormer's placement,
        `one_per_bin`), or FFD's bins again, with the split-global B that
        placement needs."""
        if on != self.one_per_bin:
            self.one_per_bin = on
            self._set_bins()

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
                         self.P_spt, self.E_spt, B=self.B_spt,
                         one_per_bin=self.one_per_bin),
            qry=pack_set(t.qry_subs, t.qry_graphs, t.qry_labels, self.store,
                         self.P_qry, self.E_qry, B=self.B_qry,
                         one_per_bin=self.one_per_bin),
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
        """The JAX package's aggregation choice for this split
        (`jax_agg_rule`), which `agg_for` gives `auto` off the card; on
        the card `agg_for` applies the card's own crossover."""
        return jax_agg_rule(self.P_spt, self.P_qry, self.mean_bin_fill)

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
