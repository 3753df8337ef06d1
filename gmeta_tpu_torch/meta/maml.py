"""ProtoMAML in PyTorch, batched over tasks.

Counterpart of gmeta_tpu/meta/maml.py:38-224,319-320,542-566 (the streaming
path; the pool and window modes come in a later slice):

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
- `task_chunk` > 0 runs the tasks in chunks; each chunk adds sum/T of its
  losses to the gradient, so the step equals the unchunked one while only
  one chunk's adjacencies and graphs are live.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from gmeta_tpu_torch.data.pack import SubgraphSet, TaskBatch
from gmeta_tpu_torch.meta.protonet import proto_loss_qry, proto_loss_spt
from gmeta_tpu_torch.models.gcn import GCN, forward, init_params, precompute
from gmeta_tpu_torch.utils.device import resolve_device


class InnerAux(NamedTuple):
    qry_accs: torch.Tensor    # (T, num_steps + 1) accuracy curve
    qry_losses: torch.Tensor  # (T, num_steps + 1)
    spt_losses: torch.Tensor  # (T, num_steps)


def make_inner_loop(layer_spec: Sequence[Tuple[str, tuple]],
                    proto_classes: int, update_lr: float,
                    num_steps: int, first_order: bool = True,
                    compute_dtype=torch.float32,
                    track_curve: bool = True, agg: str = "dense"):
    """Returns inner_loop(params, task: TaskBatch, feats) ->
    (meta_losses (T,), InnerAux). `params` is theta, shared by the T tasks
    of `task` (fields with a leading task axis, on the device). meta_losses
    are the LAST-step query losses (meta.py:161); the accuracy curve has
    num_steps+1 entries with entry 0 the pre-update evaluation
    (meta.py:129-134).

    When grad mode is on and theta requires grad, meta_losses carry the
    meta-gradient's graph back to theta. Otherwise the loop only evaluates
    (finetuning): fast weights are re-leafed every step and nothing is kept.

    track_curve=False skips the per-step query evaluations (telemetry
    only); the curve then holds the final eval in every slot."""

    def inner_loop(params, task: TaskBatch, feats: torch.Tensor):
        T = task.spt.node_gid.shape[0]
        meta = torch.is_grad_enabled() and any(p.requires_grad
                                               for p in params)
        # Adjacency (or edge lists) + norm + the input-feature gather are
        # constant across inner steps: built ONCE here.
        graph_spt = precompute(task.spt, compute_dtype, feats=feats, agg=agg)
        graph_qry = precompute(task.qry, compute_dtype, feats=feats, agg=agg)

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
            with torch.no_grad():
                ql, qa = qry(w, spt(w)[1])
            q_losses.append(ql)
            q_accs.append(qa)

        protos = None
        for k in range(num_steps):
            last = k == num_steps - 1
            with torch.enable_grad():
                loss_s, protos = spt(w)
                g = torch.autograd.grad(
                    loss_s.sum(), w,
                    retain_graph=meta and (last or not first_order),
                    create_graph=meta and not first_order)
            if meta:
                w = [p - update_lr * gi for p, gi in zip(w, g)]
            else:
                w = [(p - update_lr * gi).detach().requires_grad_()
                     for p, gi in zip(w, g)]
            s_losses.append(loss_s.detach())
            if track_curve:
                if meta and last:
                    ql, qa = qry(w, protos)
                else:
                    with torch.no_grad():
                        ql, qa = qry(w, protos)
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
        with torch.set_grad_enabled(meta):
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


def take_tasks(batch: TaskBatch, sl: slice) -> TaskBatch:
    def one(sg):
        return SubgraphSet(*(None if x is None else x[sl] for x in sg))
    return TaskBatch(spt=one(batch.spt), qry=one(batch.qry))


def _add_task_axis(task: TaskBatch) -> TaskBatch:
    def one(sg):
        return SubgraphSet(*(None if x is None else x[None] for x in sg))
    return TaskBatch(spt=one(task.spt), qry=one(task.qry))


class MetaLearner:
    """Owns theta (a GCN module), the Adam state and the train/eval steps.

    Runs on `device`: CUDA unless the caller names another; with no CUDA
    device and no explicit device it raises."""

    def __init__(self, layer_spec, proto_classes: int, *,
                 update_lr: float, meta_lr: float,
                 update_step: int, update_step_test: int,
                 first_order: bool = True, compute_dtype=torch.float32,
                 seed: int = 222, track_curve: bool = True,
                 agg: str = "dense", task_chunk: int = 0, device=None):
        self.device = resolve_device(device)
        self.layer_spec = layer_spec
        self.meta_lr = meta_lr
        self.task_chunk = task_chunk
        gen = torch.Generator().manual_seed(seed)
        self.model = GCN(init_params(gen, layer_spec)).to(self.device)
        self.opt_state = adam_init(self.params)
        self._train_inner = make_inner_loop(
            layer_spec, proto_classes, update_lr, update_step,
            first_order=first_order, compute_dtype=compute_dtype,
            track_curve=track_curve, agg=agg)
        self._test_inner = make_inner_loop(
            layer_spec, proto_classes, update_lr, update_step_test,
            first_order=first_order, compute_dtype=compute_dtype, agg=agg)
        self._feats = None

    # -- host-facing API -----------------------------------------------------

    @property
    def params(self):
        return self.model.flat()

    def set_params(self, params):
        """Load theta (e.g. from convert.params_from_jax) and restart Adam."""
        with torch.no_grad():
            for p, v in zip(self.params, params):
                p.copy_(torch.as_tensor(v))
        self.opt_state = adam_init(self.params)

    def set_features(self, feats):
        self._feats = torch.as_tensor(np.asarray(feats, np.float32)).to(
            self.device)

    def _chunks(self, T: int):
        step = self.task_chunk if 0 < self.task_chunk < T else T
        return [slice(c, min(c + step, T)) for c in range(0, T, step)]

    def train_step(self, batch: TaskBatch):
        """One meta-step on a batch of T tasks. Returns device tensors
        {"meta_loss", "accs" (update_step+1,), "nan_skip"} without waiting
        for the device."""
        batch = batch_to(batch, self.device)
        T = batch.spt.node_gid.shape[0]
        params = self.params
        grads = [torch.zeros_like(p) for p in params]
        loss = torch.zeros((), device=self.device)
        accs = 0.0
        for sl in self._chunks(T):
            losses, aux = self._train_inner(params, take_tasks(batch, sl),
                                            self._feats)
            part = losses.sum() / T
            for acc, g in zip(grads, torch.autograd.grad(part, params)):
                acc.add_(g)
            loss = loss + part.detach()
            accs = accs + aux.qry_accs.sum(dim=0)
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

    def finetune_batch(self, batch: TaskBatch, params=None) -> torch.Tensor:
        """(T, update_step_test+1) accuracy curves for a batch of tasks,
        finetuned from `params` (default: current theta)."""
        batch = batch_to(batch, self.device)
        p = tuple(x.detach() for x in
                  (self.params if params is None else params))
        curves = [self._test_inner(p, take_tasks(batch, sl), self._feats)[1]
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
