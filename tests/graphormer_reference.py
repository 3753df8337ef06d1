"""Plain reference of the port's Graphormer (gmeta_tpu_torch/models/
graphormer.py) and its first-order ProtoMAML meta-step with Adam, task by
task, in plain PyTorch: the tests' copy of
benchmark/reference/graphormer_protomaml.py (a test holds the two to the
same bits). It imports neither package.

A graph is one bin of a packed set: its live slots are the nodes, its
real edges (mask 1) the edges; every other slot is left out. Per graph of
n nodes:

- Degrees: `deg_in(i)` the real edge slots into i, `deg_out(i)` those out
  of i, each duplicate counted.
- Distances: `phi(i, j)` the shortest path from i to j over the edges
  taken both ways, by breadth-first search (boolean products from every
  node at once); `phi(i, i) = 0`. The spatial table's row of a pair is
  min(phi, 254), or 511 where no path joins them.
- `h0 = x W_in + b_in + z_in[min(deg_in, 511)] + z_out[min(deg_out, 511)]`.
- Each of L pre-LN layers, K heads of D = H / K:
  `u = LN1(h)`, `q, k, v = u W_qkv + b_qkv`;
  `A^k = q^k k^k^T / sqrt(D) + b[row(phi), k]`, an n x n matrix per head;
  `h' = h + concat_k softmax(A^k) v^k W_o + b_o`;
  `h = h' + GELU(LN2(h') W_1 + b_1) W_2 + b_2` (GELU the erf form).
- `e = LN_f(h)`; the centres' rows of e, then `e W_head^T + b_head`.

Bins of the same number of nodes are computed together, one batch of
matrix products, which changes no sum: each bin's rows meet only its own.
Prototypes are the per-class means of the support logits; a sample's loss
is the NLL of the softmax over minus its squared distances to them; the
inner loop takes update_step SGD steps without second-order terms; the
meta-loss is the query loss of the last fast weights against the last
step's support prototypes; Adam (torch.optim.Adam's defaults) steps theta
with the mean meta-gradient unless the mean loss is not finite.

A configuration is a dict: feat_dim, graphormer_layers,
graphormer_hidden, graphormer_heads, graphormer_ffn, labels_num,
update_lr, update_step, meta_lr. Theta is the program's flat layout
(models/graphormer.py). A task's set is a dict of the packed layout's
arrays (node_gid, node_mask, edge_src, edge_dst, edge_mask, centers,
labels).
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as nnf

MAX_DEGREE = 511
MAX_DISTANCE = 254
NO_PATH_ROW = 511
LN_EPS = 1e-5
LAYER_PARAMS = 12


def lookup(table, index):
    """table[index], as the product of index's one-hot rows over the
    table's rows it names with those rows: a sum of one product and
    zeros, exact in float32, whose gradient is a product too (an indexed
    gradient adds up with atomics on the card, in an order that changes
    from run to run)."""
    rows, inverse = torch.unique(index, return_inverse=True)
    onehot = nnf.one_hot(inverse, rows.numel()).to(table.dtype)
    return onehot @ table[rows]


def graphs(s: dict, device):
    """The graphs of one task's set, grouped by size: a list of (their
    bins (G,), their live slots (G, n), table rows (G, n, n), deg_in and
    deg_out (G, n)), and each bin's live slot -> node map (B, P), -1 off
    the graph."""
    mask = torch.as_tensor(s["node_mask"], device=device) != 0
    B, P = mask.shape
    live = torch.as_tensor(s["edge_mask"], device=device) != 0
    src = torch.as_tensor(s["edge_src"], device=device).long()[live]
    dst = torch.as_tensor(s["edge_dst"], device=device).long()[live]
    if bool((src // P != dst // P).any()):
        raise ValueError("an edge leaves its bin")
    local = torch.full((B, P), -1, dtype=torch.long, device=device)
    by_size = {}
    for b in range(B):
        slots = torch.nonzero(mask[b]).flatten()
        n = slots.numel()
        local[b, slots] = torch.arange(n, device=device)
        on = dst // P == b
        i, j = local[b, dst[on] % P], local[b, src[on] % P]
        if bool((i < 0).any() or (j < 0).any()):
            raise ValueError("a real edge names a pad slot")
        d_in = torch.bincount(i, minlength=n).clamp(max=MAX_DEGREE)
        d_out = torch.bincount(j, minlength=n).clamp(max=MAX_DEGREE)
        adj = torch.zeros(n, n, dtype=torch.float32, device=device)
        adj[i, j] = 1.0
        adj = ((adj + adj.T) > 0).float()
        rows = torch.full((n, n), NO_PATH_ROW, dtype=torch.long,
                          device=device)
        reach = torch.eye(n, dtype=torch.bool, device=device)
        rows[reach] = 0
        frontier, d = reach.clone(), 0
        while bool(frontier.any()):
            d += 1
            frontier = ((frontier.float() @ adj) > 0) & ~reach
            rows[frontier] = min(d, MAX_DISTANCE)
            reach |= frontier
        by_size.setdefault(n, []).append((b, slots, rows, d_in, d_out))
    groups = [tuple(torch.stack(x) if i else torch.tensor(x, device=device)
                    for i, x in enumerate(zip(*g)))
              for _, g in sorted(by_size.items())]
    return groups, local


class Reference:
    def __init__(self, cfg: dict, dtype=torch.float32):
        self.cfg = cfg
        self.dtype = dtype

    def mm(self, a, b):
        return a @ b

    # -- the model -----------------------------------------------------------

    def graph(self, s: dict, device):
        return graphs(s, device)

    def _norm(self, h, w, b):
        return nnf.layer_norm(h, h.shape[-1:], w, b, eps=LN_EPS)

    def embed(self, w, s: dict, feats, g):
        """[(its bins (G,), the input embedding and each layer's output
        (G, n, H), each)] per group of bins of the same size."""
        groups, _ = g
        cfg = self.cfg
        H, K = cfg["graphormer_hidden"], cfg["graphormer_heads"]
        D = H // K
        gid = torch.as_tensor(s["node_gid"], device=feats.device).long()
        W_in, b_in, z_in, z_out, table = w[:5]
        out = []
        for bins, slots, rows, d_in, d_out in groups:
            G, n = slots.shape
            x = feats[gid[bins[:, None], slots]].to(self.dtype)
            h = self.mm(x, W_in) + b_in + lookup(z_in, d_in) \
                + lookup(z_out, d_out)
            bias = lookup(table, rows).permute(0, 3, 1, 2)      # (G, K, n, n)
            hs = [h]
            for li in range(cfg["graphormer_layers"]):
                (ln1_w, ln1_b, W_qkv, b_qkv, W_o, b_o, ln2_w, ln2_b, W_1,
                 b_1, W_2, b_2) = w[5 + LAYER_PARAMS * li:
                                    5 + LAYER_PARAMS * (li + 1)]
                qkv = self.mm(self._norm(h, ln1_w, ln1_b), W_qkv) + b_qkv
                q, k, v = (qkv[..., i * H:(i + 1) * H].reshape(
                    G, n, K, D).transpose(1, 2) for i in range(3))
                A = self.mm(q, k.transpose(-1, -2)) / math.sqrt(D) + bias
                o = self.mm(torch.softmax(A, dim=-1), v)        # (G, K, n, D)
                o = o.transpose(1, 2).reshape(G, n, H)
                h = h + self.mm(o, W_o) + b_o
                u = nnf.gelu(self.mm(self._norm(h, ln2_w, ln2_b), W_1) + b_1)
                h = h + self.mm(u, W_2) + b_2
                hs.append(h)
            out.append((bins, hs))
        return out

    def logits(self, w, s: dict, feats, g):
        """(S, labels_num) logits of one task's set: the centres' rows of
        LN_f of the last layer."""
        groups, local = g
        L = self.cfg["graphormer_layers"]
        idx = 5 + LAYER_PARAMS * L
        P = local.shape[1]
        c = torch.as_tensor(s["centers"], device=feats.device).long()[:, 0]
        node = local[c // P, c % P]
        rows, parts, base = torch.empty_like(c), [], 0
        for (bins, hs), (_, slots, *_) in zip(self.embed(w, s, feats, g),
                                              groups):
            G, n = slots.shape
            e = self._norm(hs[-1], w[idx], w[idx + 1])
            for gi in range(G):
                at = c // P == bins[gi]
                rows[at] = base + gi * n + node[at]
            parts.append(e.reshape(G * n, -1))
            base += G * n
        e = torch.cat(parts)[rows]
        return self.mm(e, w[idx + 2].T) + w[idx + 3]

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
