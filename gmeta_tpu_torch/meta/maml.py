"""ProtoMAML in PyTorch, batched over tasks.

Counterpart of gmeta_tpu/meta/maml.py:38-566, the streaming step and the
pool and window modes:

- the inner loop runs `update_step` SGD steps on fast weights that carry a
  leading task axis (theta expanded to (T, ...)), so one support forward and
  one `torch.autograd.grad` of the summed support loss give every task its
  own gradient, as `jax.vmap` over tasks does in the reference. Per step:
  support forward -> proto loss (prototypes refreshed) -> grad -> fast-weight
  update -> query eval with the *fresh* prototypes and *updated* weights —
  the reference's exact ordering (meta.py:143-157).
- FIRST-ORDER by default: the inner gradients are detached
  (create_graph=False; the reference never sets create_graph,
  meta.py:125,149), but the LAST step's prototypes keep their graph to
  theta, because the meta-loss needs it: that step's grad is taken with
  retain_graph=True. Every other per-step value is detached or computed
  under no_grad, so earlier steps' graphs are freed. `first_order=False`
  keeps the whole graph (create_graph=True).
- the outer step is Adam on the mean last-step query loss (a functional
  Adam equal to optax.adam), with the reference's NaN skip guard
  (meta.py:161-169) done by torch.where on the device — no host sync —
  and counted as a metric.
- `remat` recomputes each inner step in the backward instead of keeping
  its activations (the JAX package's `jax.checkpoint(step)`), through
  `torch.utils.checkpoint` (see make_inner_loop for what it saves).
- `task_chunk` > 0 runs the tasks in chunks; each chunk adds sum/T of its
  losses to the gradient, so the step equals the unchunked one while only
  one chunk's adjacencies and graphs are live.
- `mesh` (parallel/mesh.py) is task data-parallelism, the JAX package's
  `MetaLearner(mesh=)`: each rank runs its contiguous T/N of the step's T
  tasks (parallel/dp.py), divides its part of the loss by the GLOBAL T, and
  sums its gradients, loss and accuracy sums over the task group in one
  all-reduce, which gives exactly the JAX mean; the NaN guard reads the
  reduced loss, so every rank takes the same decision. Theta is drawn from
  the seed on every rank and broadcast from rank 0 once.
- the pool modes run K meta-steps per call over tasks that are already on
  the device: the compact resident pool gathered by index, or a window of
  K meta-batches shipped as one int32 buffer in the JAX package's wire
  format. PyTorch has no `lax.scan`, so a K-step call is a Python loop of
  meta-steps that decodes one step's T tasks at a time on the device, with
  no host sync, and returns the per-step metrics stacked along a leading
  axis.
- on the CSR path (agg="sized") every decoded step runs repacked, each
  task's live slots in one bin (data/repack.py), so no layer computes the
  pad slots; the row count comes from bin fills the host already holds
  (the pools' and windows' own), never from the device. For a GAT the same
  fills give each repacked set's segments (data/repack.py `segments`),
  which the inner loop hands to the attention's graph.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from gmeta_tpu_torch.data.pack import SubgraphSet, TaskBatch
from gmeta_tpu_torch.data.repack import (bin_rows, live_counts, repack_batch,
                                         segments)
from gmeta_tpu_torch.meta.protonet import proto_loss_qry, proto_loss_spt
from gmeta_tpu_torch.models import gat, module_for
from gmeta_tpu_torch.models.gcn import GCN
from gmeta_tpu_torch.parallel.collectives import all_reduce_flat, broadcast_
from gmeta_tpu_torch.parallel.dp import local_tasks
from gmeta_tpu_torch.utils.device import resolve_device
from gmeta_tpu_torch.utils.metrics import grad, span


class InnerAux(NamedTuple):
    qry_accs: torch.Tensor    # (T, num_steps + 1) accuracy curve
    qry_losses: torch.Tensor  # (T, num_steps + 1)
    spt_losses: torch.Tensor  # (T, num_steps)


def make_inner_loop(layer_spec: Sequence[Tuple[str, tuple]],
                    proto_classes: int, update_lr: float,
                    num_steps: int, first_order: bool = True,
                    compute_dtype=torch.float32, remat: bool = False,
                    track_curve: bool = True, agg: str = "dense"):
    """Returns inner_loop(params, task: TaskBatch, feats, segments=None)
    -> (meta_losses (T,), InnerAux). `params` is theta, shared by the T tasks
    of `task` (fields with a leading task axis, on the device); `segments`,
    for a GAT on repacked sets, their (support, query) data/repack.py
    `Segments`, which the attention's graph takes. meta_losses
    are the LAST-step query losses (meta.py:161); the accuracy curve has
    num_steps+1 entries with entry 0 the pre-update evaluation
    (meta.py:129-134).

    When grad mode is on and theta requires grad, meta_losses carry the
    meta-gradient's graph back to theta. Otherwise the loop only evaluates
    (finetuning): fast weights are re-leafed every step and nothing is kept.

    track_curve=False skips the per-step query evaluations (telemetry
    only); the curve then holds the final eval in every slot.

    remat=True checkpoints each inner step (support forward, inner
    gradient, fast-weight update, query evaluation) as one region of
    `torch.utils.checkpoint.checkpoint(use_reentrant=False)`, the boundary
    of the JAX package's `jax.checkpoint(step)`: of a step, only its input
    fast weights are kept for the meta-gradient, and the backward reruns
    the step to get the rest. The inner gradient is taken inside the
    region, which makes PyTorch rerun the support forward once more in the
    forward pass (the activations that gradient reads were not kept).
    What it saves depends on the mode:
    - first_order=False: without remat every step's support activations
      and the graph of its inner gradient (create_graph) stay alive until
      the meta-gradient, so memory grows with num_steps; with remat the
      backward holds one step's graph at a time.
    - first_order=True: every step's graph but the last is freed anyway
      when its inner gradient is taken, so remat only drops the last
      step's support and query activations, and the backward's
      recomputation brings them back: the peak barely moves, and the
      extra forwards cost time. Remat is off by default.
    Only meta-training (grad mode on, theta requiring grad) checkpoints;
    evaluation keeps nothing either way."""

    model = module_for(layer_spec)
    forward, precompute = model.forward, model.precompute

    def inner_loop(params, task: TaskBatch, feats: torch.Tensor,
                   segments=None):
        T = task.spt.node_gid.shape[0]
        meta = torch.is_grad_enabled() and any(p.requires_grad
                                               for p in params)
        # Adjacency (or edge lists) + norm + the input-feature gather are
        # constant across inner steps: built ONCE here.
        with span("graph"):
            graph_spt, graph_qry = (
                precompute(sg, compute_dtype, feats=feats, agg=agg,
                           **({} if segments is None
                              else {"segments": segments[i]}))
                for i, sg in enumerate(task))

        def spt(w):
            logits = forward(w, task.spt, feats, layer_spec, graph=graph_spt,
                             compute_dtype=compute_dtype, agg=agg)
            loss, _, protos = proto_loss_spt(logits, task.spt.labels,
                                             proto_classes)
            return loss, protos

        def qry(w, protos):
            logits = forward(w, task.qry, feats, layer_spec, graph=graph_qry,
                             compute_dtype=compute_dtype, agg=agg)
            return proto_loss_qry(logits, task.qry.labels, protos)

        w = [p.unsqueeze(0).expand((T,) + tuple(p.shape)) for p in params]
        if not meta:
            w = [x.detach().requires_grad_() for x in w]

        q_losses, q_accs, s_losses = [], [], []
        if track_curve:
            # step-0 evaluation with theta and theta-derived prototypes,
            # under no_grad as in the reference (meta.py:129-134)
            with span("curve"), torch.no_grad():
                ql, qa = qry(w, spt(w)[1])
            q_losses.append(ql)
            q_accs.append(qa)

        def step(last, *w):
            """One inner step from fast weights w: (new fast weights,
            support losses, prototypes, query loss, query accuracy); the
            last two are None without track_curve."""
            w = list(w)
            with span("inner"):
                with torch.enable_grad():
                    loss_s, protos = spt(w)
                    g = grad(loss_s.sum(), w,
                             retain_graph=meta and (last or not first_order),
                             create_graph=meta and not first_order)
                if meta:
                    w = [p - update_lr * gi for p, gi in zip(w, g)]
                else:
                    w = [(p - update_lr * gi).detach().requires_grad_()
                         for p, gi in zip(w, g)]
            ql = qa = None
            if track_curve:
                if meta and last:
                    with span("outer"):     # the meta-loss's query forward
                        ql, qa = qry(w, protos)
                else:
                    with span("curve"), torch.no_grad():
                        ql, qa = qry(w, protos)
            return tuple(w), loss_s, protos, ql, qa

        protos = None
        for k in range(num_steps):
            fn = functools.partial(step, k == num_steps - 1)
            if remat and meta:
                w, loss_s, protos, ql, qa = checkpoint(fn, *w,
                                                       use_reentrant=False)
            else:
                w, loss_s, protos, ql, qa = fn(*w)
            s_losses.append(loss_s.detach())
            if track_curve:
                q_losses.append(ql)
                q_accs.append(qa)

        spt_losses = torch.stack(s_losses, dim=1)
        if track_curve:
            meta_loss = q_losses[-1]
            aux = InnerAux(
                qry_accs=torch.stack(q_accs, dim=1).detach(),
                qry_losses=torch.stack([q.detach() for q in q_losses], 1),
                spt_losses=spt_losses)
            return meta_loss, aux

        # one query forward total, with the final fast weights and the LAST
        # step's support prototypes (meta.py:143-151)
        with span("outer" if meta else "curve"), \
                torch.set_grad_enabled(meta):
            meta_loss, q_acc = qry(w, protos)
        shape = (T, num_steps + 1)
        aux = InnerAux(qry_accs=q_acc.detach()[:, None].expand(shape),
                       qry_losses=meta_loss.detach()[:, None].expand(shape),
                       spt_losses=spt_losses)
        return meta_loss, aux

    return inner_loop


class AdamState(NamedTuple):
    count: torch.Tensor   # () int32 step count
    mu: tuple             # first moments, one per parameter
    nu: tuple             # second moments


def adam_init(params) -> AdamState:
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=params[0].device),
        mu=tuple(torch.zeros_like(p) for p in params),
        nu=tuple(torch.zeros_like(p) for p in params))


def adam_update(grads, state: AdamState, params, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                eps_root: float = 0.0):
    """One step of optax.adam(lr) (torch.optim.Adam's defaults, meta.py:97),
    functional: returns (new_params, new_state) and changes nothing, so the
    caller can keep the old values where the loss was not finite."""
    mu = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, state.mu))
    nu = tuple((1 - b2) * (g * g) + b2 * v for g, v in zip(grads, state.nu))
    count = state.count + 1
    c = count.to(torch.float32)
    bc1 = 1 - torch.pow(b1, c)
    bc2 = 1 - torch.pow(b2, c)
    new_params = tuple(
        p - lr * ((m / bc1) / (torch.sqrt(v / bc2 + eps_root) + eps))
        for p, m, v in zip(params, mu, nu))
    return new_params, AdamState(count=count, mu=mu, nu=nu)


_INDEX_FIELDS = ("node_gid", "edge_src", "edge_dst", "centers", "labels")


def _set_to(sg: SubgraphSet, device) -> SubgraphSet:
    fields = []
    for name, x in zip(SubgraphSet._fields, sg):
        if x is not None:
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.ascontiguousarray(x))
            dtype = (torch.int64 if name in _INDEX_FIELDS
                     else torch.int32 if name == "bin_fill"
                     else torch.float32)
            x = x.to(device=device, dtype=dtype)
        fields.append(x)
    return SubgraphSet(*fields)


def batch_to(batch: TaskBatch, device) -> TaskBatch:
    """A TaskBatch (numpy or torch, leading task axis) as device tensors:
    index fields int64, bin_fill int32, masks float32."""
    return TaskBatch(spt=_set_to(batch.spt, device),
                     qry=_set_to(batch.qry, device))


def take_tasks(batch: TaskBatch, sl) -> TaskBatch:
    """The tasks `sl` (a slice or an index array) of every field."""
    def one(sg):
        return SubgraphSet(*(None if x is None else x[sl] for x in sg))
    return TaskBatch(spt=one(batch.spt), qry=one(batch.qry))


def _host_fills(batch: TaskBatch):
    """The tasks' (support, query) bin fills (T, B), where the batch is
    the host's (numpy); None for tensors, which a learner takes as decoded
    already (on a device, reading them would wait for it)."""
    fills = [sg.bin_fill for sg in batch]
    if not all(isinstance(f, np.ndarray) for f in fills):
        return None
    return tuple(fills)


def _take_tasks_of(per_set, rows):
    """The tasks `rows` of each set's per-task host fills or device
    Segments, or None."""
    if per_set is None:
        return None
    return tuple(x[rows] if isinstance(x, np.ndarray)
                 else x._replace(start=x.start[rows]) for x in per_set)


def _add_task_axis(task: TaskBatch) -> TaskBatch:
    def one(sg):
        return SubgraphSet(*(None if x is None else x[None] for x in sg))
    return TaskBatch(spt=one(task.spt), qry=one(task.qry))


class Window(NamedTuple):
    """A window buffer on the device (MetaLearner.put_buffer) and its
    steps' (support, query) bin fills on the host, each (K, T, B), or None
    where the buffer came from the device."""
    words: torch.Tensor
    fills: Optional[Tuple[np.ndarray, np.ndarray]]


class MetaLearner:
    """Owns theta (a GCN module), the Adam state and the train/eval steps.

    Runs on `device`: CUDA unless the caller names another; with no CUDA
    device and no explicit device it raises. With a `mesh`, train steps are
    task data-parallel (see the module docstring) and `finetune_batch`
    evaluates every task of its batch on every rank, as the JAX package's
    unsharded finetune does: no collective, the same curves everywhere."""

    def __init__(self, layer_spec, proto_classes: int, *,
                 update_lr: float, meta_lr: float,
                 update_step: int, update_step_test: int,
                 first_order: bool = True, compute_dtype=torch.float32,
                 remat: bool = False, seed: int = 222,
                 track_curve: bool = True, agg: str = "dense",
                 task_chunk: int = 0, device=None, mesh=None):
        if task_chunk and mesh is not None:
            raise ValueError("task_chunk is incompatible with a task-DP mesh")
        self.device = resolve_device(device)
        self.layer_spec = layer_spec
        self.meta_lr = meta_lr
        self.task_chunk = task_chunk
        self.mesh = mesh
        gen = torch.Generator().manual_seed(seed)
        self.model = GCN(module_for(layer_spec).init_params(
            gen, layer_spec)).to(self.device)
        if mesh is not None:
            broadcast_(self.params, mesh.world)
        self.opt_state = adam_init(self.params)
        self._train_inner = make_inner_loop(
            layer_spec, proto_classes, update_lr, update_step,
            first_order=first_order, compute_dtype=compute_dtype,
            remat=remat, track_curve=track_curve, agg=agg)
        self._test_inner = make_inner_loop(
            layer_spec, proto_classes, update_lr, update_step_test,
            first_order=first_order, compute_dtype=compute_dtype, agg=agg)
        # the CSR path runs over repacked sets (data/repack.py); the dense
        # path multiplies a (P, P) block per bin and keeps the slot layout;
        # a GAT's attention also takes the repacked sets' segments
        self._repacks = agg == "sized"
        self._segments = self._repacks and module_for(layer_spec) is gat
        self._feats = None
        self._cpool = None        # compact device-resident pool leaves
        self._cmeta = None        # (spt_meta, qry_meta) of the compact pool
        self._cfills = None       # its host bin fills (spt, qry), (N, B)
        self._codec = None        # window codec (K, T, spt_meta, qry_meta)
        self._copy_stream = None  # CUDA stream of pinned window copies

    # -- host-facing API -----------------------------------------------------

    @property
    def params(self):
        return self.model.flat()

    def set_params(self, params, opt_state=None):
        """Load theta (e.g. from convert.params_from_jax or a checkpoint)
        and either restart Adam or, given `opt_state` as a mapping of
        AdamState's fields (numpy or tensors), load its state. Raises where
        theta's leaves are not the model's, in number or shape."""
        params = [torch.as_tensor(v) for v in params]
        want = [tuple(p.shape) for p in self.params]
        got = [tuple(v.shape) for v in params]
        if got != want:
            raise ValueError(f"theta has leaves of shapes {got}; the model "
                             f"{self.layer_spec} has {want}")
        with torch.no_grad():
            for p, v in zip(self.params, params):
                p.copy_(v)
        if opt_state is None:
            self.opt_state = adam_init(self.params)
            return

        def dev(x, dtype=torch.float32):
            return torch.as_tensor(x).to(self.device, dtype)
        self.opt_state = AdamState(
            count=dev(opt_state["count"], torch.int32),
            mu=tuple(dev(m) for m in opt_state["mu"]),
            nu=tuple(dev(v) for v in opt_state["nu"]))

    def set_features(self, feats):
        self._feats = torch.as_tensor(np.asarray(feats, np.float32)).to(
            self.device)

    def _chunks(self, T: int):
        step = self.task_chunk if 0 < self.task_chunk < T else T
        return [slice(c, min(c + step, T)) for c in range(0, T, step)]

    def train_step(self, batch: TaskBatch):
        """One meta-step on a batch of T tasks. Returns device tensors
        {"meta_loss", "accs" (update_step+1,), "nan_skip"} without waiting
        for the device (with a mesh, the collectives may wait). A host
        batch (numpy) runs repacked on the CSR path (`_decode`); a batch of
        tensors runs in the layout it has."""
        return self._step(lambda: (batch, _host_fills(batch)))

    def _step(self, make, *args):
        """One meta-step on the batch and host bin fills `make(*args)`
        gives, made and decoded in the span `decode`."""
        with span("step"):
            with span("decode"):
                batch, segs = self._decode(*make(*args))
            return self._train_step(batch, segs)

    def _decode(self, batch: TaskBatch, fills, shard: bool = True):
        """(batch, segments): the batch as the model runs it: with a mesh
        and `shard`, this rank's tasks; on the device; and on the CSR path,
        where `fills` (the tasks' support and query bin fills) are known on
        the host, repacked into one bin per task (data/repack.py). M is the
        whole batch's, so every rank and every task chunk takes the same.
        For a GAT on repacked sets, `segments` are their (support, query)
        data/repack.py `Segments`, else None. Every entry point gives
        `fills`; a batch of tensors passed to `train_step` has none and
        runs in its slot layout, which only the tests that hold the two
        layouts to each other and bench.py's FLOP count (the slot layout's
        work) use."""
        rows = None
        if fills is not None and self._repacks:
            rows = tuple(bin_rows(live_counts(f)) for f in fills)
        if shard and self.mesh is not None:
            sl = local_tasks(batch.spt.node_gid.shape[0], self.mesh.task,
                             self.mesh.t)
            batch, fills = take_tasks(batch, sl), _take_tasks_of(fills, sl)
        batch = batch_to(batch, self.device)
        if rows is None:
            return batch, None
        segs = None
        if self._segments:
            segs = tuple(segments(sg.bin_fill, m, f)
                         for sg, m, f in zip(batch, rows, fills))
        live = tuple(live_counts(f) for f in fills)
        return repack_batch(batch, rows, live), segs

    def _train_step(self, batch: TaskBatch, segs=None):
        """The meta-step on a decoded batch (and its segments, `_decode`):
        the inner loop, then the meta-gradient and the update."""
        T = batch.spt.node_gid.shape[0]
        if self.mesh is not None:
            T *= self.mesh.task      # the losses are divided by the global T
        params = self.params
        grads = [torch.zeros_like(p) for p in params]
        loss = torch.zeros((), device=self.device)
        accs = 0.0
        chunks = self._chunks(batch.spt.node_gid.shape[0])
        for i, sl in enumerate(chunks):
            losses, aux = self._train_inner(params, take_tasks(batch, sl),
                                            self._feats,
                                            _take_tasks_of(segs, sl))
            with span("outer"):
                part = losses.sum() / T
                for acc, g in zip(grads, grad(part, params)):
                    acc.add_(g)
                loss = loss + part.detach()
                accs = accs + aux.qry_accs.sum(dim=0)
                if i == len(chunks) - 1:
                    m = self._update(params, grads, loss, accs, T)
        return m

    def _update(self, params, grads, loss, accs, T: int):
        """The task-DP all-reduce, the NaN guard and Adam; the step's
        metrics."""
        if self.mesh is not None:
            *grads, loss, accs = all_reduce_flat(
                grads + [loss, accs], self.mesh.task_group)
        # NaN skip guard (meta.py:163-169), counted not silent
        ok = torch.isfinite(loss)
        with torch.no_grad():
            new_params, new = adam_update(grads, self.opt_state, params,
                                          self.meta_lr)
            for p, n in zip(params, new_params):
                p.copy_(torch.where(ok, n, p))
            old = self.opt_state
            self.opt_state = AdamState(
                count=torch.where(ok, new.count, old.count),
                mu=tuple(torch.where(ok, n, o) for n, o in zip(new.mu, old.mu)),
                nu=tuple(torch.where(ok, n, o) for n, o in zip(new.nu, old.nu)))
        return {"meta_loss": loss, "accs": accs / T,
                "nan_skip": (~ok).to(torch.int32)}

    def _train_steps(self, make, items) -> dict:
        """One meta-step per item of the iterable, in order, on the batch
        and host bin fills `make(item)` gives. Returns the per-step
        metrics stacked along a leading axis (the JAX package's scanned
        `ms`), without waiting for the device."""
        ms = [self._step(make, item) for item in items]
        return {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    # -- window wire format --------------------------------------------------
    #
    # The JAX package's format, bit for bit, so that either package's
    # encoder output decodes in the other. Three lossless reductions:
    #   1. ONE contiguous int32 buffer per window (one transfer, not one
    #      per field).
    #   2. masks are never shipped: pack_set places live node rows at
    #      [0, bin_fill) and real edges at [0, n_edges), so node_mask =
    #      arange(P) < bin_fill and edge_mask = arange(E) < n_edges, rebuilt
    #      on the device.
    #   3. edge endpoints pack into ONE int32. Edges never cross bins, so
    #      (bin, src_local, dst_local) pins both flat endpoints; it fits
    #      whenever 2*ceil(log2 P) + ceil(log2 B) <= 31, which leaves bit 31
    #      unused, so every field unpacks non-negative in int32. Pad edges
    #      (mask 0) get src := their dst's bin base, which keeps decoded
    #      indices in range.
    # The compact pool holds the same leaves as separate (N, ...) arrays.

    @staticmethod
    def _edge_bits(B: int, P: int) -> int:
        """Bits per local endpoint, or 0 where the packed form does not
        fit (both endpoints are then shipped as they are)."""
        bits_p = max(int(np.ceil(np.log2(max(P, 2)))), 1)
        bits_b = max(int(np.ceil(np.log2(max(B, 2)))), 1)
        return bits_p if 2 * bits_p + bits_b <= 31 else 0

    @staticmethod
    def _encode_set_leaves(sg: SubgraphSet):
        """Host: numpy SubgraphSet with a leading task axis -> (compact int32
        leaves [node_gid, packed edges (or src, dst), centers, labels,
        bin_fill, n_edges], meta (B, P, E, S, bits_p))."""
        B, P = sg.node_gid.shape[-2:]
        E = sg.edge_src.shape[-1]
        bits_p = MetaLearner._edge_bits(B, P)
        n_edges = sg.edge_mask.sum(axis=-1).astype(np.int32)
        leaves = [sg.node_gid]
        if bits_p:
            dst = sg.edge_dst.astype(np.int32)
            bin_id = dst // P
            # real edges share the dst's bin; pad edges (src 0, dst V-1) do
            # not: the clip is exact for real edges, in range for pads
            src_l = np.clip(sg.edge_src.astype(np.int32) - bin_id * P,
                            0, P - 1)
            leaves.append(src_l | ((dst - bin_id * P) << bits_p)
                          | (bin_id << (2 * bits_p)))
        else:
            leaves += [sg.edge_src, sg.edge_dst]
        leaves += [sg.centers, sg.labels, sg.bin_fill, n_edges]
        S = sg.centers.shape[-2]
        return ([np.ascontiguousarray(l, np.int32) for l in leaves],
                (B, P, E, S, bits_p))

    @staticmethod
    def compact_pool_bytes(pool: TaskBatch) -> int:
        """Compact-form size of a stacked pool, without encoding it."""
        def one(sg):
            N, B, P = sg.node_gid.shape
            E = sg.edge_src.shape[-1]
            S = sg.centers.shape[-2]
            edge_words = E if MetaLearner._edge_bits(B, P) else 2 * E
            return N * 4 * (B * P + edge_words + 3 * S + B + 1)
        return one(pool.spt) + one(pool.qry)

    @staticmethod
    def encode_window(chunk: TaskBatch, task_num: int, out=None):
        """Host: a (K*task_num)-task window chunk -> (flat int32 buffer,
        codec (K, T, spt_meta, qry_meta)). Pure numpy, safe on a producer
        thread. `out`, a large enough int32 array (such as a pinned buffer's
        numpy view), receives the buffer, which is then a prefix of it."""
        K = chunk.spt.node_gid.shape[0] // task_num
        spt, m_spt = MetaLearner._encode_set_leaves(chunk.spt)
        qry, m_qry = MetaLearner._encode_set_leaves(chunk.qry)
        parts = [l.ravel() for l in spt + qry]
        if out is not None:
            out = out[:sum(p.size for p in parts)]
        buf = np.concatenate(parts, out=out)
        return buf, (K, task_num, m_spt, m_qry)

    @staticmethod
    def _build_set(leaves, meta) -> SubgraphSet:
        """Compact int32 leaves on the device, with any leading dims ->
        the SubgraphSet `batch_to` gives: edge endpoints unpacked and both
        masks rebuilt in int32, then index fields as int64. Shapes come
        from `meta` (host data), so nothing waits for the device."""
        B, P, E, S, bits_p = meta
        it = iter(leaves)
        node_gid = next(it)
        if bits_p:
            packed = next(it)
            mask_p = (1 << bits_p) - 1
            base = (packed >> (2 * bits_p)) * P     # bin * P, non-negative
            edge_src = base + (packed & mask_p)
            edge_dst = base + ((packed >> bits_p) & mask_p)
        else:
            edge_src, edge_dst = next(it), next(it)
        centers, labels, bin_fill, n_edges = it
        dev = node_gid.device
        node_mask = (torch.arange(P, device=dev, dtype=torch.int32)
                     < bin_fill[..., None]).to(torch.float32)
        edge_mask = (torch.arange(E, device=dev, dtype=torch.int32)
                     < n_edges[..., None]).to(torch.float32)
        return SubgraphSet(
            node_gid=node_gid.long(), node_mask=node_mask,
            edge_src=edge_src.long(), edge_dst=edge_dst.long(),
            edge_mask=edge_mask, centers=centers.long(),
            labels=labels.long(), bin_fill=bin_fill)

    @staticmethod
    def _split_set(buf, off, K, T, meta):
        """A set's leaves as (K, T, ...) views of a window buffer from
        offset `off`; returns (leaves, next offset)."""
        B, P, E, S, bits_p = meta
        shapes = [(B, P)] + [(E,)] * (1 if bits_p else 2) \
            + [(S, 2), (S,), (B,), ()]
        leaves = []
        for shape in shapes:
            n = K * T * int(np.prod(shape, dtype=np.int64))
            leaves.append(buf[off:off + n].reshape((K, T) + shape))
            off += n
        return leaves, off

    def _window_leaves(self, buf):
        K, T, m_spt, m_qry = self._codec
        spt, off = self._split_set(buf, 0, K, T, m_spt)
        qry, off = self._split_set(buf, off, K, T, m_qry)
        if off != buf.shape[0]:
            raise ValueError(f"window buffer of {buf.shape[0]} words, codec "
                             f"{self._codec} describes {off}")
        return spt, qry

    def _decode_window(self, buf) -> TaskBatch:
        """A whole window buffer (on its device) -> (K, T, ...) TaskBatch."""
        _, _, m_spt, m_qry = self._codec
        spt, qry = self._window_leaves(buf)
        return TaskBatch(spt=self._build_set(spt, m_spt),
                         qry=self._build_set(qry, m_qry))

    # -- compact resident pool -----------------------------------------------

    def set_task_pool_compact(self, pool: TaskBatch):
        """Place the pool on the device in compact form (no masks, one int32
        per edge): train_steps_from_compact then gathers and decodes each
        step's tasks on the device, and per window only the index matrix
        crosses from the host."""
        spt, m_spt = self._encode_set_leaves(pool.spt)
        qry, m_qry = self._encode_set_leaves(pool.qry)
        self._cmeta = (m_spt, m_qry)
        self._cfills = _host_fills(pool)
        self._cpool = tuple(tuple(torch.from_numpy(l).to(self.device)
                                  for l in leaves) for leaves in (spt, qry))

    def compact_pool_device_bytes(self) -> int:
        return sum(l.numel() * l.element_size()
                   for leaves in self._cpool for l in leaves)

    def train_steps_from_compact(self, idx_mat):
        """idx_mat.shape[0] meta-steps over the compact resident pool, one
        step's T tasks gathered and decoded at a time."""
        (spt, qry), (m_spt, m_qry) = self._cpool, self._cmeta
        idx = np.asarray(idx_mat, np.int64)
        rows = torch.as_tensor(idx).to(self.device, non_blocking=True)

        def batch(k):
            return TaskBatch(
                spt=self._build_set([l.index_select(0, rows[k])
                                     for l in spt], m_spt),
                qry=self._build_set([l.index_select(0, rows[k])
                                     for l in qry], m_qry)), \
                _take_tasks_of(self._cfills, idx[k])
        return self._train_steps(batch, range(idx.shape[0]))

    # -- host-windowed pool --------------------------------------------------

    def put_buffer(self, buf, codec):
        """Host->device copy of an encoded window buffer (numpy, or a torch
        tensor in pinned memory); returns (device buffer, event). A pinned
        buffer on a CUDA learner is copied without blocking the host, on the
        learner's copy stream: the compute stream waits for the copy through
        an event, and the returned event completes when the host buffer may
        be refilled. Otherwise the copy has finished on return and the event
        is None. The device buffer comes as a `Window`, with its steps'
        bin fills where the buffer is the host's (copied before the copy
        starts), so that train_steps_from_window repacks it."""
        self._codec = codec
        src = torch.as_tensor(buf)
        fills = None
        if src.device.type == "cpu":
            fills = tuple(np.array(leaves[-2])
                          for leaves in self._window_leaves(src))
        if self.device.type != "cuda" or not src.is_pinned():
            return Window(src.to(self.device), fills), None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = torch.empty(src.shape, dtype=src.dtype, device=self.device)
            dev.copy_(src, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        compute.wait_event(done)
        # allocated on the copy stream, read on the compute stream: keep the
        # allocator from reusing it before the compute stream is done
        dev.record_stream(compute)
        return Window(dev, fills), done

    def put_window(self, chunk: TaskBatch, task_num: int):
        """encode_window + put_buffer in one call (inline path)."""
        return self.put_buffer(*self.encode_window(chunk, task_num))[0]

    def train_steps_from_window(self, window: Window, task_num: int):
        """The K meta-steps of a window buffer already on the device
        (put_buffer's `Window`), decoded one step at a time."""
        _, _, m_spt, m_qry = self._codec
        spt, qry = self._window_leaves(window.words)

        def batch(k):
            return TaskBatch(
                spt=self._build_set([l[k] for l in spt], m_spt),
                qry=self._build_set([l[k] for l in qry], m_qry)), \
                _take_tasks_of(window.fills, k)
        return self._train_steps(batch, range(spt[0].shape[0]))

    def finetune_batch(self, batch: TaskBatch, params=None) -> torch.Tensor:
        """(T, update_step_test+1) accuracy curves for a batch of tasks,
        finetuned from `params` (default: current theta)."""
        batch, segs = self._decode(batch, _host_fills(batch), shard=False)
        p = tuple(x.detach() for x in
                  (self.params if params is None else params))
        curves = [self._test_inner(p, take_tasks(batch, sl), self._feats,
                                   _take_tasks_of(segs, sl))[1]
                  .qry_accs for sl in self._chunks(
                      batch.spt.node_gid.shape[0])]
        return torch.cat(curves, dim=0)

    def finetune(self, task: TaskBatch) -> torch.Tensor:
        """Single task (no task axis), update_step_test steps; the accuracy
        curve (update_step_test+1,) (meta.py:232-234)."""
        return self.finetune_batch(_add_task_axis(task))[0]

    def finetune_with(self, params, task: TaskBatch) -> torch.Tensor:
        """Finetune from an explicit parameter snapshot (best-model eval,
        train.py:139-141)."""
        return self.finetune_batch(_add_task_axis(task), params=params)[0]

    def snapshot(self):
        """A copy of theta (the reference's deepcopy early-stopping snapshot,
        train.py:127); theta is updated in place, so this copies."""
        return tuple(p.detach().clone() for p in self.params)
