"""Plain reference of the Graphormer configurations' meta-training step: the
graph transformer of Ying et al. (NeurIPS 2021, arXiv:2106.05234,
sections 3.1-3.2, equations 5-9) trained by first-order ProtoMAML with
Adam, task by task, in plain PyTorch.

It reads nothing of the program: it is given theta, the feature table and
each task's packed sets as arrays, and works out the rest itself. The
meta-step (the inner loop, the prototypes, the loss, Adam and the NaN
skip) is reference/protomaml.py's, which this class inherits; only the
model differs.

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

(Graphormer-slim's widths at the published configuration: the
configuration's `graphormer_*` keys set them.)

Departures from the paper's model, as in the program: no graph token (the
centre is read out), no edge encoding, pre-LN and a final LN, no dropout,
phi over undirected edges, a Linear input of dense features, distances
above 254 sharing row 254.

Bins of the same number of nodes are computed together, one batch of
matrix products, which changes no sum: each bin's rows meet only its
own. Edges never leave a bin in a packed set, nor join a pad slot; a set
where one does is refused.

`dtype` and `tf32` as in reference/protomaml.py: float32 with TF32 off
judges the program; `tf32=True` rounds both operands of every matrix
product (the projections, both attention products, the FFN, the head) to
TF32, the control of a float32 configuration.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as nnf

from benchmark.reference.protomaml import Reference as ProtoMAML
from benchmark.reference.protomaml import round_tf32

MAX_DEGREE = 511
MAX_DISTANCE = 254
NO_PATH_ROW = 511
LN_EPS = 1e-5
LAYER_PARAMS = 12


class _TF32Product(torch.autograd.Function):
    """a @ b over the last two dims with both operands rounded to TF32,
    forward and backward."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return (g @ round_tf32(b).transpose(-1, -2),
                round_tf32(a).transpose(-1, -2) @ g)


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


class Reference(ProtoMAML):
    """The step of one Graphormer configuration (a dict of its file's
    numbers)."""

    def mm(self, a, b):
        if self.tf32:
            return _TF32Product.apply(a, b)
        return a @ b

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
