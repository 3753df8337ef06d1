"""Functional GAT classifier over packed subgraph batches: the Graph
Attention Network of Velickovic et al., "Graph Attention Networks", ICLR
2018 (arXiv:1710.10903), in its inductive PPI form (section 3.3), as the
embedding that G-Meta's centre readout and Linear head take.

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

(Widths at the published configuration; config.py's `gat_*` fields set
them. PyG's `glorot` draws a_src and a_dst within sqrt(6 / (K + F')).)

Departures: the authors' code and PyG's PPI example add a learned linear
skip to every layer; this model takes the paper's words instead, one
identity skip across the middle layer. The depth, 3, is GAT's; the
configuration's `h` stays the extraction's hop count. Float32 only, node
classification only, first-order only (config.py `validate`).

z, s and t come from one product: h @ [W | W a_src | W a_dst] gives each row
z and both scores (s = h (W a_src) = (h W) . a_src), so no pass over z is
spent on them; the attention runs in ops/gat_attention.py (its kernels on
CUDA, its plain version on the CPU). The layer spec entry is
("GATConv", (fan_in, heads, width, concat, skip)); the flat parameters are
(W, a_src, a_dst, b) per layer, W (fan_in, K*F), a_src and a_dst (K, F), b
(K*F) or, averaged, (F,), then the head's (W, b); in the inner loop each
has a leading task axis.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as nnf

from gmeta_tpu_torch.data.pack import SubgraphSet
from gmeta_tpu_torch.models.gcn import _bias, gather_features, head, readout
from gmeta_tpu_torch.ops.gat_attention import AttnGraph, attend, attn_graph


class GatOperands(NamedTuple):
    """Per-task-set operands, constant over the inner steps."""
    attn: AttnGraph          # the edges over the T*B*P flat rows and their
                             # segments
    h0: torch.Tensor = None  # (T, B, P, F) gathered, masked input features


def init_params(generator: torch.Generator,
                layer_spec: Sequence[Tuple[str, tuple]]):
    """Flat (W, a_src, a_dst, b, ..., W_head, b_head) tuple of float32 CPU
    tensors in spec order, with the inits of the module docstring."""
    params = []
    for name, dims in layer_spec:
        if name == "GATConv":
            fan_in, K, F, concat, _ = dims
            a = math.sqrt(6.0 / (fan_in + K * F))
            w = torch.empty(fan_in, K * F).uniform_(-a, a, generator=generator)
            a = math.sqrt(6.0 / (K + F))
            att = [torch.empty(K, F).uniform_(-a, a, generator=generator)
                   for _ in range(2)]
            params += [w, *att, torch.zeros(K * F if concat else F)]
        elif name == "Linear":
            fan_in, fan_out = dims
            std = math.sqrt(2.0 / fan_in)  # kaiming_normal_, fan_in mode
            params += [torch.randn(fan_out, fan_in, generator=generator) * std,
                       torch.zeros(fan_out)]
        else:
            raise ValueError(f"a GAT's layer spec has no {name!r} layer")
    return tuple(params)


def precompute(sg: SubgraphSet, compute_dtype=torch.float32,
               feats: torch.Tensor = None, agg: str = "sized",
               segments=None) -> GatOperands:
    """The attention's graph and, when `feats` is given, the gathered
    input features, once per task set. GAT runs on the CSRs only.
    `segments` (data/repack.py `Segments`) are a repacked set's; without
    them the attention's segments are the set's bins."""
    if agg != "sized":
        raise ValueError(f"GAT has no {agg!r} aggregation: it runs on the "
                         f"CSR path (agg='sized')")
    T, B, P = sg.node_gid.shape
    graph = attn_graph(sg.edge_src, sg.edge_dst, sg.edge_mask, B, P,
                       segments)
    h0 = None if feats is None else gather_features(sg, feats, compute_dtype)
    return GatOperands(attn=graph, h0=h0)


def score_weights(w: torch.Tensor, a_src: torch.Tensor, a_dst: torch.Tensor,
                  K: int, F: int) -> torch.Tensor:
    """[W | W a_src | W a_dst] (..., fan_in, K*F + 2K): the product of a row
    with it is the row's z, s and t."""
    wk = w.reshape(*w.shape[:-1], K, F)
    ws = torch.einsum("...ikf,...kf->...ik", wk, a_src)
    wt = torch.einsum("...ikf,...kf->...ik", wk, a_dst)
    return torch.cat([w, ws, wt], dim=-1)


def forward(params, sg: SubgraphSet, feats: torch.Tensor,
            layer_spec: Sequence[Tuple[str, tuple]],
            graph: GatOperands = None, compute_dtype=torch.float32,
            agg: str = "sized", collect: list = None) -> torch.Tensor:
    """Logits (T, S, out), float32, for a batch of packed subgraph sets, as
    models/gcn.py `forward` takes them (params shared or with a leading
    task axis; `graph` is `precompute(sg, ...)`). `collect`, a list,
    receives each GAT layer's (T, B, P, width) output."""
    T, B, P = sg.node_gid.shape
    if graph is None:
        graph = precompute(sg, compute_dtype, agg=agg)
    h = graph.h0 if graph.h0 is not None else gather_features(
        sg, feats, compute_dtype)
    h = h.reshape(T, B * P, -1)
    gat_layers = [d for n, d in layer_spec if n == "GATConv"]
    for li, (_, K, F, concat, skip) in enumerate(gat_layers):
        w, a_src, a_dst, b = params[4 * li:4 * li + 4]
        zst = torch.matmul(h, score_weights(w, a_src, a_dst, K, F))
        o = attend(graph.attn, zst.reshape(T * B * P, -1), K, F)
        o = o.reshape(T, B * P, K * F) if concat \
            else o.reshape(T, B * P, K, F).mean(dim=2)
        o = o + _bias(b, 3)
        if skip:
            o = o + h
        h = o if li == len(gat_layers) - 1 else nnf.elu(o)
        if collect is not None:
            collect.append(h.reshape(T, B, P, -1))
    idx = 4 * len(gat_layers)
    return head(readout(h, sg, link_pred=False), params[idx],
                params[idx + 1], compute_dtype)
