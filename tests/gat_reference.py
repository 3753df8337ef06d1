"""Plain reference of the port's GAT (gmeta_tpu_torch/models/gat.py) and its
first-order ProtoMAML meta-step with Adam, task by task, in plain PyTorch:
the tests' copy of benchmark/reference/gat_protomaml.py (a test holds the
two to the same bits). It imports neither package.

- For head `k` of a layer: `z^k = h W^k`, `s_j^k = a_src^k · z_j^k`,
  `t_i^k = a_dst^k · z_i^k`.
- `e_ij^k = LeakyReLU_0.2(t_i^k + s_j^k)` over every real edge slot
  `j -> i` of the packed set, plus one self term `j = i` for every slot.
- `α^k` is the softmax of `e_i·^k` over those terms, and
  `o_i^k = Σ_j α_ij^k z_j^k`.
- Duplicate edge slots count once each, as the GCN counts them.
- Pad slots get only their self term. They are never a real edge's
  source, so they reach no real node.
- Layer 1 (50 -> 4x256): `h1 = ELU(concat_k o^k + b1)`.
- Layer 2 (1024 -> 4x256): `h2 = ELU(concat_k o^k + b2 + h1)`. This is an
  identity skip. The widths agree, and the ELU comes after the sum, as in
  the authors' `attn_head`.
- Layer 3 (1024 -> 6x121): `h3 = mean_k o^k + b3`, with no activation.
  PPI's 121 sigmoid outputs become the embedding that G-Meta's centre
  readout and Linear head (121 -> `labels_num`) take. The prototype loss
  is the GCN's.
- Init: each `W` Xavier-uniform over `(fan_in, K·F')`; `a_src` and `a_dst`
  Xavier-uniform over `(1, K, F')`, as PyG's `GATConv`; biases zero; the
  head Kaiming-normal, as G-Meta's.

(Widths at the published configuration; the configuration's keys set
them.)

The attention is dense within each bin, as the authors' `attn_head`
computes it: a (P, P) score matrix per head, masked to the bin's terms by
the log of each term's count, a softmax a row at a time and the weighted
sum one matrix product. Prototypes are the per-class means of the support
logits; a sample's loss is the NLL of the softmax over minus its squared
distances to them; the inner loop takes update_step SGD steps without
second-order terms; the meta-loss is the query loss of the last fast
weights against the last step's support prototypes; Adam
(torch.optim.Adam's defaults) steps theta with the mean meta-gradient
unless the mean loss is not finite.

A configuration is a dict: feat_dim, gat_heads, gat_hidden, gat_out_heads,
gat_out_dim, labels_num, update_lr, update_step, meta_lr. Theta is the
program's flat layout: (W, a_src, a_dst, b) per layer, then the head's
(W, b). A task's set is a dict of the packed layout's arrays (node_gid,
node_mask, edge_src, edge_dst, edge_mask, centers, labels).
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as nnf

SLOPE = 0.2


def layers(cfg: dict):
    """(fan_in, heads, width, concat, skip) of the three GAT layers."""
    K, F = cfg["gat_heads"], cfg["gat_hidden"]
    return [(cfg["feat_dim"], K, F, True, False), (K * F, K, F, True, True),
            (K * F, cfg["gat_out_heads"], cfg["gat_out_dim"], False, False)]


class Reference:
    def __init__(self, cfg: dict, dtype=torch.float32):
        self.cfg = cfg
        self.dtype = dtype

    # -- the model -----------------------------------------------------------

    def graph(self, s: dict, device):
        """(B, P) and the (B, 1, P, P) log-count of each bin's terms."""
        B, P = torch.as_tensor(s["node_gid"]).shape
        live = torch.as_tensor(s["edge_mask"], device=device) != 0
        src = torch.as_tensor(s["edge_src"], device=device).long()[live]
        dst = torch.as_tensor(s["edge_dst"], device=device).long()[live]
        if bool((src // P != dst // P).any()):
            raise ValueError("an edge leaves its bin")
        count = torch.eye(P, dtype=self.dtype, device=device).repeat(B, 1, 1)
        count.index_put_((dst // P, dst % P, src % P),
                         torch.ones_like(dst, dtype=self.dtype),
                         accumulate=True)
        return (B, P), torch.log(count)[:, None]

    def embed(self, w, s: dict, feats, g):
        """Each layer's (B*P, width) output of one task's set."""
        (B, P), log_count = g
        device = feats.device
        gid = torch.as_tensor(s["node_gid"], device=device).long().reshape(-1)
        mask = torch.as_tensor(s["node_mask"], device=device).reshape(-1, 1)
        h = feats[gid].to(self.dtype) * mask.to(self.dtype)
        spec, out = layers(self.cfg), []
        for li, (_, K, F, concat, skip) in enumerate(spec):
            W, a_src, a_dst, b = w[4 * li:4 * li + 4]
            z = (h @ W).reshape(B, P, K, F).transpose(1, 2)
            s_ = (z * a_src[None, :, None, :]).sum(-1)          # (B, K, P)
            t_ = (z * a_dst[None, :, None, :]).sum(-1)
            e = nnf.leaky_relu(t_[..., :, None] + s_[..., None, :], SLOPE)
            alpha = torch.softmax(e + log_count, dim=-1)        # (B, K, P, P)
            o = (alpha @ z).transpose(1, 2)                     # (B, P, K, F)
            o = o.reshape(B * P, K * F) if concat \
                else o.mean(dim=2).reshape(B * P, F)
            o = o + b
            if skip:
                o = o + h
            h = o if li == len(spec) - 1 else nnf.elu(o)
            out.append(h)
        return out

    def logits(self, w, s: dict, feats, g):
        """(S, labels_num) logits of one task's set."""
        h = self.embed(w, s, feats, g)[-1]
        c = torch.as_tensor(s["centers"], device=feats.device).long()
        return h[c[:, 0]] @ w[-2].T + w[-1]

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
        """The first len(steps) meta-steps from theta0: {"losses",
        "grad1", "theta"}."""
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
