"""Edge-partitioned META-TRAINING: the full ProtoMAML inner/outer loop over
a graph sharded across the mesh's 'edge' axis, with task data-parallelism
over its 'task' axis.

Counterpart of gmeta_tpu/parallel/edgepart_train.py:

- the graph (features, edge shards, halo plan) is sharded over the edge
  group and replicated over the task groups; each task group runs its
  contiguous share of the meta-batch; theta and the Adam state are
  replicated (drawn from the seed and broadcast from rank 0 once).
- each GCN layer ships only the boundary rows other shards' edges reference
  (OverlapPlan.send_idx) through one all-to-all, started asynchronously;
  the local edges are aggregated while it is in flight, then the engine
  waits and folds in the remote edges. Both aggregations are `csr_gather`
  over CSR pairs and their heavy-row plans, built once on the host (the
  CUDA kernels on the card, `csr_plain` on the CPU; autograd pair
  CsrAgg/CsrAggT).
- center readout: each shard contributes the embedding rows it owns (zero
  elsewhere) and an all-reduce over the edge group assembles the (S, H)
  center matrix (both endpoints, (S, 2H), for link prediction) on every
  shard.
- tasks run ONE AT A TIME within a rank, with the meta-gradient
  accumulated task by task, so only one task's full-graph activations are
  alive at once: the memory posture of the JAX engine's `lax.scan` over
  tasks.

Gradients under edge sharding. JAX's autodiff of `shard_map` makes every
replicated parameter's gradient whole on every shard by transposing the
collectives. PyTorch's autograd knows nothing of ranks, so this module
keeps one convention everywhere:
  1. each rank differentiates its copy of a replicated scalar (the support
     loss of every inner step, the query loss of the outer step) scaled by
     1/D, D the edge group's size;
  2. the readout goes through `all_reduce_sum` and the halo through
     `all_to_all`, whose backward rules (parallel/collectives.py) route
     every rank's cotangents to the ranks whose rows produced them;
  3. every gradient that leaves `torch.autograd.grad` is summed over the
     EDGE group before it is used. The head's gradient is then D x (1/D)
     of the whole; each GCN weight's is the sum of the shards' local
     contributions.
The inner-step sum covers the edge group only: summing across task groups
would mix different tasks' fast weights (the fault the JAX engine's
comment at :177-182 records). With first_order=False the inner sum is
`all_reduce_sum`, which stays in the graph. The meta-gradient is summed
over the world (every task group's share, every shard's contribution) and
divided by the number of task groups; each rank's part is the mean over
its own tasks of (query loss / D).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from gmeta_tpu_torch.data.graph import CSRGraph
from gmeta_tpu_torch.meta.maml import AdamState, adam_init, adam_update
from gmeta_tpu_torch.meta.protonet import proto_loss_qry, proto_loss_spt
from gmeta_tpu_torch.models.gcn import init_params
from gmeta_tpu_torch.ops.sized_spmm import CsrAgg, CsrPair
from gmeta_tpu_torch.parallel.collectives import (all_reduce_flat,
                                                  all_reduce_sum,
                                                  all_to_all_start,
                                                  broadcast_)
from gmeta_tpu_torch.parallel.dp import local_tasks
from gmeta_tpu_torch.parallel.edgepart import (OverlapPlan, ShardedGraph,
                                               _live_pair, _norm,
                                               build_overlap_plan,
                                               pad_features, shard_graph)


class EdgePartTask(NamedTuple):
    """A meta-batch of tasks over ONE partitioned graph. Centers are GLOBAL
    node ids; for link tasks the trailing axis holds both endpoints, for
    node tasks both columns carry the same id (pack.py convention)."""
    spt_centers: np.ndarray   # (T, S_spt, 2) int32
    spt_labels: np.ndarray    # (T, S_spt) int32
    qry_centers: np.ndarray   # (T, S_qry, 2) int32
    qry_labels: np.ndarray    # (T, S_qry) int32


class OverlapShard(NamedTuple):
    """Shard d's operands on its device: its feature rows h0 (Vb, F), norm
    (Vb, 1), the local and remote edges as CSR pairs with their heavy-row
    plans (local sources are its own rows, remote ones index the (D*M, H)
    receive table), and its send plan (D, M)."""
    h0: torch.Tensor
    norm: torch.Tensor
    local: CsrPair
    remote: CsrPair
    send_idx: torch.Tensor
    send_mask: torch.Tensor


def overlap_shard(sg: ShardedGraph, plan: OverlapPlan, h0: np.ndarray,
                  d: int, n_shards: int, device) -> OverlapShard:
    """Host: shard d's operands, moved to `device`; h0 is the padded
    (D*Vb, F) feature table, of which only shard d's rows move."""
    Vb = sg.Vb
    local = _live_pair(plan.local_src[d], plan.local_dst[d],
                       plan.local_mask[d], Vb, Vb)
    remote = _live_pair(plan.remote_src[d], plan.remote_dst[d],
                        plan.remote_mask[d], n_shards * plan.M, Vb)
    return OverlapShard(
        torch.from_numpy(h0[d * Vb:(d + 1) * Vb]).to(device),
        _norm(sg, d).to(device), local.to(device), remote.to(device),
        torch.from_numpy(plan.send_idx[d].astype(np.int64)).to(device),
        torch.from_numpy(plan.send_mask[d]).to(device))


class EdgePartMetaTrainer:
    """Owns theta, the Adam state and the sharded meta-train and finetune
    steps of one rank. Every rank of the mesh constructs it and calls each
    step together."""

    def __init__(self, layer_dims: Sequence[Tuple[int, int]],
                 head: Tuple[int, int], n_classes: int, *,
                 g: CSRGraph, feats: np.ndarray, mesh,
                 link_pred: bool = False,
                 update_lr: float = 0.01, meta_lr: float = 1e-3,
                 update_step: int = 5, update_step_test: int = None,
                 first_order: bool = True,
                 seed: int = 222):
        self.mesh = mesh
        self.device = mesh.device
        self.n_tasks_axis = mesh.task
        D = mesh.edge
        self.n_layers = len(layer_dims)
        self.n_classes = n_classes
        self.link_pred = link_pred
        self.update_lr, self.meta_lr = update_lr, meta_lr
        self.update_step = update_step
        self.update_step_test = (update_step if update_step_test is None
                                 else update_step_test)
        self.first_order = first_order
        spec = [("GraphConv", d) for d in layer_dims] + [("Linear", head)]
        if link_pred:
            spec += [("LinkPred", (True,))]
        gen = torch.Generator().manual_seed(seed)
        self.params = tuple(p.to(self.device)
                            for p in init_params(gen, tuple(spec)))
        broadcast_(self.params, mesh.world)
        self.opt_state = adam_init(self.params)

        sg = shard_graph(g, D)
        plan = build_overlap_plan(sg, D)
        self.sg, self.plan = sg, plan
        self.comm_rows_per_layer = plan.comm_rows
        h0 = pad_features(np.asarray(feats, np.float32), sg, D)
        self._shard = overlap_shard(sg, plan, h0, mesh.e, D, self.device)

    # ---- the sharded model ---------------------------------------------------

    def _embed(self, w) -> torch.Tensor:
        """(Vb, H) embeddings of this shard's rows at weights w."""
        sh, D, M = self._shard, self.mesh.edge, self.plan.M
        h = sh.h0
        for i in range(self.n_layers):
            W, b = w[2 * i], w[2 * i + 1]
            h = h * sh.norm
            if D > 1:
                # start the boundary exchange first...
                send = h[sh.send_idx] * sh.send_mask[..., None]   # (D, M, H)
                recv, wait = all_to_all_start(send, self.mesh.edge_group)
            # ...aggregate the local edges while it is in flight...
            agg = CsrAgg.apply(sh.local, h)
            if D > 1:
                # ...then fold in the remote contribution. One shard has no
                # remote edges, and its empty exchange is skipped.
                wait()
                agg = agg + CsrAgg.apply(sh.remote, recv.reshape(D * M, -1))
            h = torch.relu((agg @ W) * sh.norm + b)
        return h

    def _readout(self, emb, centers) -> torch.Tensor:
        """(S, H), or (S, 2H) for link prediction, of the GLOBAL center ids
        (S, 2): owned rows from this shard, zeros elsewhere, summed over
        the edge group."""
        Vb = self.sg.Vb
        cols = centers if self.link_pred else centers[:, :1]
        local = cols - self.mesh.e * Vb
        owned = (local >= 0) & (local < Vb)
        rows = torch.where(owned[..., None], emb[local.clamp(0, Vb - 1)],
                           0.0)
        return all_reduce_sum(rows.reshape(rows.shape[0], -1),
                              self.mesh.edge_group)

    def _logits(self, w, centers) -> torch.Tensor:
        x = self._readout(self._embed(w), centers)
        W, b = w[2 * self.n_layers], w[2 * self.n_layers + 1]
        return x @ W.T + b

    def _task_tensors(self, task: EdgePartTask, t: int):
        return tuple(torch.from_numpy(np.asarray(a[t], np.int64)).to(
            self.device) for a in task)

    def _inner_grad(self, w, centers, labels, create_graph: bool,
                    retain_graph: bool):
        """(edge-summed gradient of the support loss at w, prototypes)."""
        loss, _, protos = proto_loss_spt(self._logits(w, centers), labels,
                                         self.n_classes)
        g = torch.autograd.grad(loss / self.mesh.edge, w,
                                create_graph=create_graph,
                                retain_graph=retain_graph)
        return all_reduce_flat(g, self.mesh.edge_group,
                               differentiable=create_graph), protos

    # ---- training ------------------------------------------------------------

    def _task_loss(self, theta, spt_c, spt_y, qry_c, qry_y):
        """One task's query (loss, acc) after update_step inner steps from
        theta; carries the meta-gradient's graph. First order: the inner
        gradients are detached, but the last step's prototypes keep their
        graph (its grad is taken with retain_graph)."""
        w = list(theta)
        protos = None
        for k in range(self.update_step):
            last = k == self.update_step - 1
            g, protos = self._inner_grad(
                w, spt_c, spt_y, create_graph=not self.first_order,
                retain_graph=last or not self.first_order)
            w = [p - self.update_lr * gi for p, gi in zip(w, g)]
        return proto_loss_qry(self._logits(w, qry_c), qry_y, protos)

    def train_step(self, task: EdgePartTask):
        """One meta-step on the (T, ...) meta-batch, T a multiple of the
        task groups. Returns {"meta_loss", "qry_acc", "nan_skip"} as device
        tensors, equal on every rank."""
        T = task.spt_centers.shape[0]
        sl = local_tasks(T, self.n_tasks_axis, self.mesh.t)
        n_local, D = sl.stop - sl.start, self.mesh.edge
        theta = [p.detach().requires_grad_() for p in self.params]
        grads = [torch.zeros_like(p) for p in self.params]
        loss = torch.zeros((), device=self.device)
        acc = torch.zeros((), device=self.device)
        for t in range(sl.start, sl.stop):
            q_loss, q_acc = self._task_loss(theta,
                                            *self._task_tensors(task, t))
            for a, g in zip(grads, torch.autograd.grad(
                    q_loss / (D * n_local), theta)):
                a.add_(g)
            loss = loss + q_loss.detach() / D
            acc = acc + q_acc / D
        *grads, loss, acc = all_reduce_flat(grads + [loss, acc],
                                            self.mesh.world)
        grads = [g / self.n_tasks_axis for g in grads]
        loss, acc = loss / T, acc / T
        ok = torch.isfinite(loss)               # NaN skip (meta.py:163)
        with torch.no_grad():
            new_params, new = adam_update(grads, self.opt_state, self.params,
                                          self.meta_lr)
            self.params = tuple(torch.where(ok, n, p)
                                for n, p in zip(new_params, self.params))
            old = self.opt_state
            self.opt_state = AdamState(
                count=torch.where(ok, new.count, old.count),
                mu=tuple(torch.where(ok, n, o) for n, o in zip(new.mu, old.mu)),
                nu=tuple(torch.where(ok, n, o) for n, o in zip(new.nu, old.nu)))
        return {"meta_loss": loss, "qry_acc": acc,
                "nan_skip": (~ok).to(torch.int32)}

    # ---- evaluation: the reference finetune curve, sharded -------------------

    def _finetune_one(self, params, spt_c, spt_y, qry_c, qry_y):
        """(update_step_test+1,) query accuracies: before the first step
        (theta and theta's prototypes), then after each step (prototypes
        of the pre-update weights, query at the post-update weights),
        meta.py:129-157."""
        def qry_acc(w, protos):
            with torch.no_grad():
                return proto_loss_qry(self._logits(w, qry_c), qry_y,
                                      protos)[1]
        w = [p.detach().requires_grad_() for p in params]
        with torch.no_grad():
            protos = proto_loss_spt(self._logits(w, spt_c), spt_y,
                                    self.n_classes)[2]
        accs = [qry_acc(w, protos)]
        for _ in range(self.update_step_test):
            with torch.enable_grad():
                g, protos = self._inner_grad(w, spt_c, spt_y,
                                             create_graph=False,
                                             retain_graph=False)
            w = [(p - self.update_lr * gi).detach().requires_grad_()
                 for p, gi in zip(w, g)]
            accs.append(qry_acc(w, protos.detach()))
        return torch.stack(accs)

    def finetune_batch(self, task: EdgePartTask, params=None) -> np.ndarray:
        """(T, update_step_test+1) query-accuracy curves, the sharded
        counterpart of MetaLearner.finetune_batch. Each task group finetunes
        its share of the tasks; an all-reduce over the task group of the
        zero-padded curves gives every rank all of them. `params` evaluates
        a snapshot (the best model)."""
        T = task.spt_centers.shape[0]
        sl = local_tasks(T, self.n_tasks_axis, self.mesh.t)
        p = self.params if params is None else params
        curves = torch.zeros((T, self.update_step_test + 1),
                             device=self.device)
        for t in range(sl.start, sl.stop):
            curves[t] = self._finetune_one(p, *self._task_tensors(task, t))
        curves = all_reduce_sum(curves, self.mesh.task_group)
        return curves.cpu().numpy()

    # ---- state ---------------------------------------------------------------

    def set_params(self, params, opt_state=None):
        """Load theta (e.g. from convert.params_from_jax or a checkpoint)
        and either restart Adam or load `opt_state`, a mapping of
        AdamState's fields."""
        self.params = tuple(torch.as_tensor(p).to(self.device, torch.float32)
                            for p in params)
        if opt_state is None:
            self.opt_state = adam_init(self.params)
            return

        def dev(x, dtype=torch.float32):
            return torch.as_tensor(x).to(self.device, dtype)
        self.opt_state = AdamState(
            count=dev(opt_state["count"], torch.int32),
            mu=tuple(dev(m) for m in opt_state["mu"]),
            nu=tuple(dev(v) for v in opt_state["nu"]))
