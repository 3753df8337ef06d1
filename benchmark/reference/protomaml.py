"""Plain reference of the meta-training step: a GCN trained by first-order
ProtoMAML with Adam, task by task, in plain PyTorch.

It follows the published model and algorithm (G-Meta: learner.py, meta.py)
and reads nothing of the program: it is given the inputs the benchmark drew
(theta, the feature table, each task's packed sets as arrays of the
packed layout's fields) and works out the rest itself.

- The graph of a packed set: the real edges (mask 1) of its flat B*P slots;
  the symmetric norm is clamp(in-degree, 1)^-1/2, applied before and after
  each aggregation, with no self-loop (learner.py:28-54). An aggregation
  sums each real edge's source row into its destination row.
- A GraphConv projects first where that shrinks the rows, and adds its
  bias before the ReLU; the readout takes each centre's row (both
  endpoints joined under link prediction), and the head is z W^T + b.
- Prototypes are the per-class means of the support logits; a sample's
  loss is the NLL of the softmax over minus its squared distances to them
  (meta.py:14-79).
- The inner loop takes update_step SGD steps on the support loss from
  theta, without second-order terms; the meta-loss is the query loss of
  the last fast weights against the prototypes of the last step's support
  pass (before its update), and its gradient reaches theta through both
  (meta.py:143-161). The meta-gradient is the mean over tasks; Adam
  (torch.optim.Adam's defaults) steps theta unless the mean loss is not
  finite (meta.py:161-169).

`dtype` is the arithmetic of the whole step: float32, as the configuration
states, judges the program, with TF32 off for the run (a float32 product
then stays float32 on the card); `tf32=True` rounds both operands of every
matrix product, forward and backward, to TF32's 10-bit mantissa, as the
card's tensor cores do with TF32 on: the control of a float32
configuration.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest TF32 value (ties to even)."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x0FFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).T, round_tf32(a).T @ g


class Reference:
    """The step of one configuration (a dict of its file's numbers)."""

    def __init__(self, cfg: dict, dtype=torch.float32, tf32: bool = False):
        self.cfg = cfg
        self.dtype = torch.float32 if tf32 else dtype
        self.tf32 = tf32
        self.n_gcn = cfg["h"]

    def mm(self, a, b):
        if self.tf32:
            return _TF32Product.apply(a, b)
        return a @ b

    # -- the model ---------------------------------------------------------

    def graph(self, s: dict, device):
        """(src, dst, norm) of one task's set: its real edges and the
        (B*P, 1) norm."""
        live = torch.as_tensor(s["edge_mask"], device=device) != 0
        src = torch.as_tensor(s["edge_src"], device=device).long()[live]
        dst = torch.as_tensor(s["edge_dst"], device=device).long()[live]
        N = int(torch.as_tensor(s["node_gid"]).numel())
        deg = torch.bincount(dst, minlength=N).to(self.dtype)
        return src, dst, deg.clamp(min=1.0).rsqrt()[:, None]

    def logits(self, w: Sequence[torch.Tensor], s: dict, feats, g):
        """(S, labels_num) logits of one task's set."""
        src, dst, norm = g
        device = feats.device
        gid = torch.as_tensor(s["node_gid"], device=device).long().reshape(-1)
        mask = torch.as_tensor(s["node_mask"], device=device).reshape(-1, 1)
        h = feats[gid].to(self.dtype) * mask.to(self.dtype)

        def aggregate(x):
            return torch.zeros_like(x).index_add_(0, dst, x[src])

        for li in range(self.n_gcn):
            W, b = w[2 * li], w[2 * li + 1]
            h = h * norm
            if W.shape[0] > W.shape[1]:
                h = aggregate(self.mm(h, W))
            else:
                h = self.mm(aggregate(h), W)
            h = torch.relu(h * norm + b)
        c = torch.as_tensor(s["centers"], device=device).long()
        z = h[c[:, 0]]
        if self.cfg["link_pred_mode"]:
            z = torch.cat([z, h[c[:, 1]]], dim=-1)
        return self.mm(z, w[-2].T) + w[-1]

    def prototypes(self, logits, y):
        C = self.cfg["labels_num"]
        return torch.stack([
            logits[y == c].sum(0) / max(int((y == c).sum()), 1)
            for c in range(C)])

    @staticmethod
    def proto_loss(logits, y, protos):
        d = ((logits[:, None, :] - protos[None, :, :]) ** 2).sum(-1)
        logp = torch.log_softmax(-d, dim=-1)
        return -logp[torch.arange(len(y), device=y.device), y].mean()

    # -- one task ------------------------------------------------------------

    def task(self, theta, spt: dict, qry: dict, feats):
        """(meta-loss, meta-gradient) of one task at theta."""
        device = feats.device
        g_s, g_q = self.graph(spt, device), self.graph(qry, device)
        y_s = torch.as_tensor(spt["labels"], device=device).long()
        y_q = torch.as_tensor(qry["labels"], device=device).long()
        lr, K = self.cfg["update_lr"], self.cfg["update_step"]
        w = [p.detach() for p in theta]
        for _ in range(K - 1):
            w = [x.requires_grad_() for x in w]
            out = self.logits(w, spt, feats, g_s)
            loss = self.proto_loss(out, y_s, self.prototypes(out, y_s))
            grads = torch.autograd.grad(loss, w)
            w = [(x - lr * gx).detach() for x, gx in zip(w, grads)]
        w = [x.requires_grad_() for x in w]
        out = self.logits(w, spt, feats, g_s)
        protos = self.prototypes(out, y_s)
        loss = self.proto_loss(out, y_s, protos)
        grads = torch.autograd.grad(loss, w, retain_graph=True)
        fast = [x - lr * gx.detach() for x, gx in zip(w, grads)]
        meta = self.proto_loss(self.logits(fast, qry, feats, g_q), y_q,
                               protos)
        return meta.detach(), torch.autograd.grad(meta, w)

    # -- the meta-step -------------------------------------------------------

    def step(self, theta, adam, tasks: List[tuple], feats):
        """One meta-step over `tasks`, a list of (support, query) pairs.
        Returns (mean meta-loss, meta-gradient, new theta, new Adam state);
        adam is (count, mu, nu)."""
        loss = torch.zeros((), dtype=self.dtype, device=feats.device)
        grad = [torch.zeros_like(p) for p in theta]
        for spt, qry in tasks:
            l_t, g_t = self.task(theta, spt, qry, feats)
            loss = loss + l_t
            grad = [a + b for a, b in zip(grad, g_t)]
        n = len(tasks)
        loss, grad = loss / n, [g / n for g in grad]
        if not math.isfinite(float(loss)):
            return loss, grad, theta, adam
        count, mu, nu = adam
        b1, b2, eps = 0.9, 0.999, 1e-8
        count += 1
        mu = [b1 * m + (1 - b1) * g for m, g in zip(mu, grad)]
        nu = [b2 * v + (1 - b2) * g * g for v, g in zip(nu, grad)]
        lr = self.cfg["meta_lr"]
        theta = [p - lr * (m / (1 - b1 ** count))
                 / ((v / (1 - b2 ** count)).sqrt() + eps)
                 for p, m, v in zip(theta, mu, nu)]
        return loss, grad, theta, (count, mu, nu)

    def run(self, theta0, steps: List[List[tuple]], feats):
        """The first len(steps) meta-steps from theta0. Returns
        {"losses": [per step], "grad1": the first meta-gradient,
        "theta": theta after the last}."""
        theta = [p.detach().to(self.dtype) for p in theta0]
        feats = feats.to(self.dtype)
        adam = (0, [torch.zeros_like(p) for p in theta],
                [torch.zeros_like(p) for p in theta])
        losses, grad1 = [], None
        flags = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for tasks in steps:
                loss, grad, theta, adam = self.step(theta, adam, tasks,
                                                    feats)
                losses.append(float(loss))
                if grad1 is None:
                    grad1 = [g.detach() for g in grad]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = flags
        return {"losses": losses, "grad1": grad1,
                "theta": [p.detach() for p in theta]}
