"""Functional Graphormer classifier over packed subgraph batches: the graph
transformer of Ying et al., "Do Transformers Really Perform Bad for Graph
Representation?", NeurIPS 2021 (arXiv:2106.05234), sections 3.1-3.2 and
equations 5-9, as the embedding that G-Meta's centre readout and Linear
head take. A graph is one bin's subgraph (data/pack.py places one a bin
for this model), its nodes the bin's live slots.

- Centrality encoding: `h0 = x W_in + b_in + z_in[min(deg_in, 511)]
  + z_out[min(deg_out, 511)]`, degrees over the set's real edge slots,
  each duplicate counted, as the GCN and the GAT count them.
- Each of L pre-LN layers: `u = LN1(h)`, `q, k, v = u W_qkv + b_qkv`
  split into K heads of D = H / K; `A_ij = q_i . k_j / sqrt(D)
  + b[phi(i, j)]` over the live nodes of i's graph, with phi the
  shortest-path distance over the graph's edges taken both ways
  (ops/spatial_attention.py: phi(i, i) = 0, row 511 where no path joins
  them); `h' = h + concat_k softmax(A^k) v^k W_o + b_o`;
  `h = h' + GELU(LN2(h') W_1 + b_1) W_2 + b_2`, GELU the exact erf form.
  The spatial table b (512 x K) is shared by all layers, as the paper
  has it.
- Pad slots attend only to themselves and are no live node's key, so
  they reach no live node.
- Output: `e = LN_f(h)`, then G-Meta's centre readout and Linear head
  (H -> labels_num) and the prototype loss, as the GCN's.
- Init, as Graphormer's `init_graphormer_params`: every Linear weight and
  embedding table N(0, 0.02), biases 0, LayerNorms (1, 0); the head
  Kaiming-normal, as G-Meta's.

Departures from the paper's model (Graphormer-slim's widths are the
configuration's defaults, config.py): no graph token (G-Meta reads out
the centre); no edge encoding (PPI's subgraphs have no edge features);
the paper's pre-LN, not the released code's default post-LN with an LN on
the input embedding; a final LN_f; no dropout; phi over undirected edges;
a Linear input of the dense features in place of the atom-type embedding;
distances above 254 share the table's row 254 (phi is a byte).

The layer spec: ("GraphormerEmbed", (fan_in, H, K)), then L
("GraphormerLayer", (H, K, ffn)), then ("LayerNorm", (H,)) and ("Linear",
(H, labels_num)). The flat parameters: W_in (fan_in, H), b_in (H), z_in,
z_out (512, H), the spatial table (512, K); per layer LN1's (w, b),
W_qkv (H, 3H), b_qkv (3H), W_o (H, H), b_o (H), LN2's (w, b), W_1
(H, ffn), b_1, W_2 (ffn, H), b_2; LN_f's (w, b); the head's W (out, H)
and b. In the inner loop each has a leading task axis. Float32 only,
node classification only, first order only (config.py `validate`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as nnf

from gmeta_tpu_torch.data.pack import SubgraphSet
from gmeta_tpu_torch.models.gcn import _bias, gather_features, head, readout
from gmeta_tpu_torch.ops.spatial_attention import (TABLE_ROWS, SpatialGraph,
                                                   attend, spatial_graph)
from gmeta_tpu_torch.utils.metrics import span

INIT_STD = 0.02      # init_graphormer_params' normal std
LN_EPS = 1e-5        # torch.nn.LayerNorm's default, as the released code
LAYER_PARAMS = 12    # flat parameters a layer


class GraphormerOperands(NamedTuple):
    """Per-task-set operands, constant over the inner steps."""
    spatial: SpatialGraph    # segments, distances, liveness and degrees
    h0: torch.Tensor = None  # (T, B, P, F) gathered, masked input features


def init_params(generator: torch.Generator,
                layer_spec: Sequence[Tuple[str, tuple]]):
    """The flat parameters of the module docstring as float32 CPU tensors,
    with its inits."""
    def normal(*shape):
        return torch.randn(*shape, generator=generator) * INIT_STD

    params = []
    for name, dims in layer_spec:
        if name == "GraphormerEmbed":
            fan_in, H, K = dims
            params += [normal(fan_in, H), torch.zeros(H),
                       normal(TABLE_ROWS, H), normal(TABLE_ROWS, H),
                       normal(TABLE_ROWS, K)]
        elif name == "GraphormerLayer":
            H, K, ffn = dims
            params += [torch.ones(H), torch.zeros(H),
                       normal(H, 3 * H), torch.zeros(3 * H),
                       normal(H, H), torch.zeros(H),
                       torch.ones(H), torch.zeros(H),
                       normal(H, ffn), torch.zeros(ffn),
                       normal(ffn, H), torch.zeros(H)]
        elif name == "LayerNorm":
            (H,) = dims
            params += [torch.ones(H), torch.zeros(H)]
        elif name == "Linear":
            fan_in, fan_out = dims
            std = math.sqrt(2.0 / fan_in)  # kaiming_normal_, fan_in mode
            params += [torch.randn(fan_out, fan_in, generator=generator) * std,
                       torch.zeros(fan_out)]
        else:
            raise ValueError(f"a Graphormer's layer spec has no {name!r} "
                             f"layer")
    return tuple(params)


def precompute(sg: SubgraphSet, compute_dtype=torch.float32,
               feats: torch.Tensor = None, agg: str = "sized",
               segments=None) -> GraphormerOperands:
    """The graphs' distances, liveness and degrees (span `spd`) and, when
    `feats` is given, the gathered input features, once per task set.
    Graphormer runs on the CSR path only. `segments` (data/repack.py
    `Segments`) are a repacked set's; without them each bin is a
    segment."""
    if agg != "sized":
        raise ValueError(f"Graphormer has no {agg!r} aggregation: it runs "
                         f"on the CSR path (agg='sized')")
    T, B, P = sg.node_gid.shape
    with span("spd"):
        spatial = spatial_graph(sg.edge_src, sg.edge_dst, sg.edge_mask,
                                sg.node_mask, B, P, segments)
    h0 = None if feats is None else gather_features(sg, feats, compute_dtype)
    return GraphormerOperands(spatial=spatial, h0=h0)


def _linear(h, w, b):
    """h (T, N, in) @ w + b, w (in, out) shared or (T, in, out) per task."""
    return torch.matmul(h, w) + _bias(b, 3)


def _norm(h, w, b):
    """LayerNorm over the last axis with a shared or per-task affine."""
    return nnf.layer_norm(h, h.shape[-1:], eps=LN_EPS) * _bias(w, 3) \
        + _bias(b, 3)


def _embed(table, index):
    """Rows `index` (T, N) of a table (R, H) shared or (T, R, H) per
    task: (T, N, H)."""
    if table.dim() == 2:
        return table[index]
    return torch.gather(table, 1, index[..., None].expand(
        -1, -1, table.shape[-1]))


def forward(params, sg: SubgraphSet, feats: torch.Tensor,
            layer_spec: Sequence[Tuple[str, tuple]],
            graph: GraphormerOperands = None, compute_dtype=torch.float32,
            agg: str = "sized", collect: list = None) -> torch.Tensor:
    """Logits (T, S, out), float32, for a batch of packed subgraph sets, as
    models/gcn.py `forward` takes them (params shared or with a leading
    task axis; `graph` is `precompute(sg, ...)`). `collect`, a list,
    receives the input embedding's and each layer's (T, B, P, H)
    output."""
    T, B, P = sg.node_gid.shape
    N = B * P
    if graph is None:
        graph = precompute(sg, compute_dtype, agg=agg)
    sp = graph.spatial
    x = graph.h0 if graph.h0 is not None else gather_features(
        sg, feats, compute_dtype)
    (_, H, K), = [d for n, d in layer_spec if n == "GraphormerEmbed"]
    w_in, b_in, z_in, z_out, table = params[:5]
    h = (_linear(x.reshape(T, N, -1), w_in, b_in)
         + _embed(z_in, sp.deg_in.view(T, N))
         + _embed(z_out, sp.deg_out.view(T, N)))
    if collect is not None:
        collect.append(h.reshape(T, B, P, H))
    if table.dim() == 2:
        table = table.expand(T, *table.shape)
    D = H // K
    layers = [d for n, d in layer_spec if n == "GraphormerLayer"]
    for li in range(len(layers)):
        (ln1_w, ln1_b, w_qkv, b_qkv, w_o, b_o, ln2_w, ln2_b, w_1, b_1, w_2,
         b_2) = params[5 + LAYER_PARAMS * li:5 + LAYER_PARAMS * (li + 1)]
        qkv = _linear(_norm(h, ln1_w, ln1_b), w_qkv, b_qkv)
        o = attend(sp, qkv.reshape(T * N, 3 * H), table, K, D)
        h = h + _linear(o.reshape(T, N, H), w_o, b_o)
        u = nnf.gelu(_linear(_norm(h, ln2_w, ln2_b), w_1, b_1))
        h = h + _linear(u, w_2, b_2)
        if collect is not None:
            collect.append(h.reshape(T, B, P, H))
    idx = 5 + LAYER_PARAMS * len(layers)
    e = _norm(h, params[idx], params[idx + 1])
    return head(readout(e, sg, link_pred=False), params[idx + 2],
                params[idx + 3], compute_dtype)
