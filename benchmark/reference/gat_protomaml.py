"""Plain reference of the GAT configurations' meta-training step: the GAT of
Velickovic et al. (ICLR 2018, arXiv:1710.10903, inductive PPI form) trained
by first-order ProtoMAML with Adam, task by task, in plain PyTorch.

It reads nothing of the program: it is given theta, the feature table and
each task's packed sets as arrays, and works out the rest itself. The
meta-step (the inner loop, the prototypes, the loss, Adam and the NaN skip)
is reference/protomaml.py's, which this class inherits; only the model
differs.

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

(Widths at the published configuration; the configuration's `gat_*` keys
set them.)

Departures from the authors' code, as in the program: one identity skip
across the middle layer (the paper's words) where the authors' code and
PyG's PPI example put a learned linear skip on every layer; the depth is
GAT's 3, whatever the configuration's hop count.

How it computes the attention, independently of the program's CSR kernels:
as the authors' `attn_head` does, dense within each bin, a (P, P) score
matrix per head masked to the bin's terms, its softmax a row at a time and
the weighted sum one matrix product. A term's multiplicity enters as the
log of its count (log 2 for a duplicate edge, minus infinity for no term),
so that duplicates count once each. It adds no rows with index_add_, whose
atomics make reference/protomaml.py differ from run to run on the card:
its sums are reductions and matrix products. Edges never leave a bin in a
packed set; a set where one does is refused.

`dtype` and `tf32` as in reference/protomaml.py: float32 with TF32 off
judges the program; `tf32=True` rounds both operands of every matrix
product (the projections, the weighted sums, the head) to TF32, the
control of a float32 configuration.
"""

from __future__ import annotations

import torch
import torch.nn.functional as nnf

from benchmark.reference.protomaml import Reference as ProtoMAML
from benchmark.reference.protomaml import round_tf32

SLOPE = 0.2


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


def layers(cfg: dict):
    """(fan_in, heads, width, concat, skip) of the three GAT layers."""
    K, F = cfg["gat_heads"], cfg["gat_hidden"]
    return [(cfg["feat_dim"], K, F, True, False), (K * F, K, F, True, True),
            (K * F, cfg["gat_out_heads"], cfg["gat_out_dim"], False, False)]


class Reference(ProtoMAML):
    """The step of one GAT configuration (a dict of its file's numbers)."""

    def mm(self, a, b):
        if self.tf32:
            return _TF32Product.apply(a, b)
        return a @ b

    def graph(self, s: dict, device):
        """(B, P) and the (B, 1, P, P) log-count of each bin's terms: entry
        [b, 0, i, j] is the log of the number of terms j -> i."""
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

    def logits(self, w, s: dict, feats, g):
        """(S, labels_num) logits of one task's set."""
        (B, P), log_count = g
        device = feats.device
        gid = torch.as_tensor(s["node_gid"], device=device).long().reshape(-1)
        mask = torch.as_tensor(s["node_mask"], device=device).reshape(-1, 1)
        h = feats[gid].to(self.dtype) * mask.to(self.dtype)
        spec = layers(self.cfg)
        for li, (_, K, F, concat, skip) in enumerate(spec):
            W, a_src, a_dst, b = w[4 * li:4 * li + 4]
            z = self.mm(h, W).reshape(B, P, K, F).transpose(1, 2)
            s_ = (z * a_src[None, :, None, :]).sum(-1)          # (B, K, P)
            t_ = (z * a_dst[None, :, None, :]).sum(-1)
            e = nnf.leaky_relu(t_[..., :, None] + s_[..., None, :], SLOPE)
            alpha = torch.softmax(e + log_count, dim=-1)        # (B, K, P, P)
            o = self.mm(alpha, z).transpose(1, 2)               # (B, P, K, F)
            o = o.reshape(B * P, K * F) if concat \
                else o.mean(dim=2).reshape(B * P, F)
            o = o + b
            if skip:
                o = o + h
            h = o if li == len(spec) - 1 else nnf.elu(o)
        c = torch.as_tensor(s["centers"], device=device).long()
        return self.mm(h[c[:, 0]], w[-2].T) + w[-1]
