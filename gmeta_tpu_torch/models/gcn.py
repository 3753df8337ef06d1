"""Functional GCN classifier over packed subgraph batches.

Reproduces the reference's model math exactly (G-Meta/learner.py), as
gmeta_tpu/models/gcn.py does:

- symmetric normalization d^-1/2 with degree clamp(min=1), applied to the
  features before aggregation and to the result after (learner.py:28-32,49)
- aggregation over existing in-edges only; NO self-loop is added
  (learner.py:38-45)
- matmul-order switch: project first when in_feats > out_feats
  (learner.py:34-47) — numerically equivalent, kept as a FLOP optimization
- +bias then ReLU per GraphConv (learner.py:51-54)
- after the LAST GraphConv: center-node readout by flat slot index
  (learner.py:159-170); LinkPred concatenates both endpoints' embeddings
  (learner.py:165-168)
- Linear head h @ W.T + b with W of shape (out, in) — (out, 2*in) in
  LinkPred mode (learner.py:83-90,172-175)

Batched over tasks: every SubgraphSet field carries a leading task axis T,
and `forward` takes parameters either shared by all tasks (the JAX layout,
W of shape (in, out)) or one copy per task (W of shape (T, in, out)), which
is how the MAML inner loop runs all tasks' fast weights at once. The
parameter layout is the JAX package's flat tuple (W, b, W, b, ...), so
conversion between the two packages is the identity (convert.py).

`precompute` builds the aggregation operand (the dense adjacency, or for
agg="sized" the edge lists as CSRs), the norm and h0 once per task set; they
are constant across the MAML inner loop, so no scatter or gather runs inside
it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import torch
from torch import nn

from gmeta_tpu_torch.data.pack import SubgraphSet
from gmeta_tpu_torch.ops.sized_spmm import (SizedGraph, aggregate_sized,
                                            sized_graph)
from gmeta_tpu_torch.ops.spmm import (aggregate_dense, degrees_from_dense,
                                      densify)


class GraphOperands(NamedTuple):
    """Per-task-set precomputed aggregation operands (constant over inner
    steps): the dense adjacency for agg="dense" or the CSRs for
    agg="sized", never both."""
    norm: torch.Tensor   # (T, B, P, 1) clamp(deg,1)^-1/2
    h0: torch.Tensor = None  # (T, B, P, F) gathered+masked input features
    A: torch.Tensor = None   # (T*B, P, P) block-diagonal adjacency over bins
    sized: SizedGraph = None  # both CSRs over the T*B*P flat rows


def init_params(generator: torch.Generator,
                layer_spec: Sequence[Tuple[str, tuple]]):
    """Flat (W, b, W, b, ...) tuple of float32 CPU tensors in config order,
    with the reference inits: GraphConv W ~ xavier_uniform (in, out) with
    zero bias (learner.py:92-96); Linear W ~ kaiming_normal (out, in[*2])
    with zero bias (learner.py:83-90)."""
    link_pred = layer_spec[-1][0] == "LinkPred"
    params = []
    for name, dims in layer_spec:
        if name == "GraphConv":
            fan_in, fan_out = dims
            a = math.sqrt(6.0 / (fan_in + fan_out))
            w = torch.empty(fan_in, fan_out).uniform_(-a, a,
                                                      generator=generator)
            params += [w, torch.zeros(fan_out)]
        elif name == "Linear":
            fan_in, fan_out = dims
            in_eff = fan_in * 2 if link_pred else fan_in
            std = math.sqrt(2.0 / in_eff)  # kaiming_normal_, fan_in mode, a=0
            w = torch.randn(fan_out, in_eff, generator=generator) * std
            params += [w, torch.zeros(fan_out)]
        elif name == "LinkPred":
            pass
        else:
            raise ValueError(name)
    return tuple(params)


class GCN(nn.Module):
    """The classifier's parameters theta as a module: one Parameter per
    entry of the flat (W, b, W, b, ...) layout. The computation is the
    functional `forward`, called at theta or at the inner loop's fast
    weights."""

    def __init__(self, params):
        super().__init__()
        self.params = nn.ParameterList([nn.Parameter(p) for p in params])

    def flat(self):
        return tuple(self.params)


def _matmul(h, w, compute_dtype):
    """h @ w accumulated in float32, cast to the compute dtype (exact in
    float32; for bf16 the reference's f32-accumulate idiom)."""
    if compute_dtype == torch.float32:
        return torch.matmul(h, w)
    return torch.matmul(h.float(), w.float()).to(compute_dtype)


def _bias(b, ndim):
    """A bias (out,) or per-task (T, out), shaped to add to a rank-`ndim`
    activation whose first axis is the task axis."""
    if b.dim() == 1:
        return b
    return b.reshape(b.shape[0], *([1] * (ndim - 2)), b.shape[-1])


def gather_features(sg: SubgraphSet, feats: torch.Tensor,
                    compute_dtype=torch.float32) -> torch.Tensor:
    """(T, B, P, F) rows of the global feature table, pad slots zeroed."""
    h = feats[sg.node_gid.long()] * sg.node_mask[..., None]
    return h.to(compute_dtype)


def precompute(sg: SubgraphSet, compute_dtype=torch.float32,
               feats: torch.Tensor = None,
               agg: str = "dense") -> GraphOperands:
    """Build the aggregation operand + symmetric norm — and, when `feats` is
    given, the gathered input features — once per task set. agg="dense"
    builds the block-diagonal adjacency; agg="sized" builds the edge lists'
    CSRs and no adjacency, its degrees counted from the row pointers."""
    T, B, P = sg.node_gid.shape
    A = sized = None
    if agg == "sized":
        sized = sized_graph(sg.edge_src, sg.edge_dst, sg.edge_mask, B, P)
        deg = sized.degrees().view(T, B, P).to(compute_dtype)
    elif agg == "dense":
        A = densify(sg.edge_src, sg.edge_dst, sg.edge_mask, B, P,
                    dtype=compute_dtype)                   # (T, B, P, P)
        deg = degrees_from_dense(A)
        A = A.view(T * B, P, P)
    else:
        raise ValueError(f"agg must be 'dense' or 'sized', got {agg!r}")
    norm = torch.rsqrt(deg.clamp(min=1.0))[..., None]       # clamp(min=1)^-.5
    h0 = None if feats is None else gather_features(sg, feats, compute_dtype)
    return GraphOperands(norm=norm.to(compute_dtype), h0=h0, A=A, sized=sized)


def forward(params, sg: SubgraphSet, feats: torch.Tensor,
            layer_spec: Sequence[Tuple[str, tuple]],
            graph: GraphOperands = None,
            compute_dtype=torch.float32,
            agg: str = "dense", collect: list = None) -> torch.Tensor:
    """Logits (T, S, out), float32, for a batch of packed subgraph sets.

    `agg` selects the aggregation: "dense" is a batched matmul over full
    (P, P) blocks; "sized" is the size-aware aggregation over the edge lists
    (ops/sized_spmm), which on a CUDA tensor launches the hand-written
    kernel and on a CPU tensor runs its plain version — the tensor's device
    decides, nothing else. `graph` is `precompute(sg, ..., agg=agg)`.
    `collect`, a list, receives each GraphConv layer's (T, B, P, out)
    activations (the per-layer oracle check of run/parity.py)."""
    link_pred = layer_spec[-1][0] == "LinkPred"
    T, B, P = sg.node_gid.shape

    if graph is None:
        graph = precompute(sg, compute_dtype, agg=agg)
    norm = graph.norm

    if agg == "sized":
        def _aggregate(h_):
            return aggregate_sized(graph.sized, h_)
    elif agg == "dense":
        def _aggregate(h_):
            return aggregate_dense(graph.A, h_)
    else:
        raise ValueError(f"agg must be 'dense' or 'sized', got {agg!r}")

    h = graph.h0 if graph.h0 is not None else gather_features(
        sg, feats, compute_dtype)

    idx = 0
    gcn_layers = [d for n, d in layer_spec if n == "GraphConv"]
    for li, (fan_in, fan_out) in enumerate(gcn_layers):
        w = params[idx].to(compute_dtype)
        b = params[idx + 1].to(compute_dtype)
        idx += 2
        h = h * norm
        if fan_in > fan_out:
            h = _matmul(h.reshape(T, B * P, fan_in), w, compute_dtype)
            h = _aggregate(h.reshape(T * B, P, fan_out)).to(compute_dtype)
        else:
            h = _aggregate(h.reshape(T * B, P, fan_in)).to(compute_dtype)
            h = _matmul(h.reshape(T, B * P, fan_in), w, compute_dtype)
        h = torch.relu(h.reshape(T, B, P, fan_out) * norm + _bias(b, 4))
        if collect is not None:
            collect.append(h)
        if li == len(gcn_layers) - 1:
            # center readout: flat slots bin*P + i index each task's own
            # (B*P, H) rows
            h = h.reshape(T, B * P, fan_out)
            centers = sg.centers.long()

            def take(col):
                return torch.gather(
                    h, 1, centers[..., col:col + 1].expand(-1, -1, fan_out))
            h = torch.cat([take(0), take(1)], dim=-1) if link_pred \
                else take(0)

    w, b = params[idx], params[idx + 1]
    logits = torch.matmul(h.float(),
                          w.to(compute_dtype).float().transpose(-1, -2))
    return logits + _bias(b.float(), 3)


def count_params(params) -> int:
    return int(sum(p.numel() for p in params))
