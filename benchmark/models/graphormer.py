"""Graphormer (Ying et al., NeurIPS 2021, arXiv:2106.05234, sections 3.1-3.2,
equations 5-9, at Graphormer-slim's widths), the model of configurations
whose `model` is `graphormer` and whose `arch`, the program's
architecture, is `graphormer` too (`make_theta` refuses one without it,
so that the program cannot run a GCN here): a centrality encoding, L
pre-LN layers of multi-head attention over each graph with a
shortest-path bias and an FFN, a final LayerNorm, G-Meta's centre readout
and Linear head (benchmark/reference/graphormer_protomaml.py has the
equations).

- `make_theta`: the published initialisation from the run's seed;
- `Reference`: the plain first-order ProtoMAML step of this Graphormer;
- `step_flops`: the operations one meta-step requires;
- `attention_bound_ms(cfg, direction)`: the least time the meta-step's
  attention calls take, forward or backward (the rooflines
  `sattn_fwd_roofline` and `sattn_bwd_roofline`);
- `aggregation_bound_ms`: the same for both directions, the model's
  mixing of rows.

What is counted follows counts/model.py's rules, as models/gat.py does:
what the model needs over the REAL nodes of each packed set (a graph is a
bin's live slots; pad slots and pad bins left out), for every pass the
configuration asks for (`counts.model.passes`), no recomputation,
elementwise passes (LayerNorm, GELU, the residuals, the softmax's
exponentials, the embeddings' gathers) left out. A set of B graphs of n
nodes (N = B n):

A forward: the input Linear, 2 N F H; per layer the projections,
2 N H (3H) + 2 N H H + 2 N H ffn + 2 N ffn H, and the attention, 4 n^2 D a
head and graph (both products: q k^T and the weighted sum of v), K heads
of D = H / K. A backward: the input Linear's weight gradient, 2 N F H
(the features are not trained); each projection's weight and input
gradients, twice its forward; the attention's, 8 n^2 D a head and graph.
The head as counts/model.py counts it.

An attention call's bound, in bytes and operations at counts/peaks.py's
rates, counts its own traffic once: forward, q, k and v read, o and the
log-sum-exp written, phi's n^2 bytes a graph read; backward, the same and
the gradient of o read, the gradients of q, k and v written. Its
operations: 4 n^2 D forward, 8 n^2 D backward, a head and graph.
"""

from __future__ import annotations

import math

import torch

from benchmark.counts.model import passes, set_shapes
from benchmark.counts.peaks import FP32_PEAK, HBM_BYTES_S
from benchmark.generate import generator
from benchmark.reference.graphormer_protomaml import Reference

__all__ = ["make_theta", "Reference", "step_flops", "aggregation_bound_ms",
           "attention_bound_ms"]

INIT_STD = 0.02       # init_graphormer_params' normal std
TABLE_ROWS = 512


def make_theta(cfg: dict, seed: int, device) -> list:
    """The flat parameters of models/graphormer.py: W_in (F, H), b_in;
    z_in, z_out (512, H); the spatial table (512, K); per layer LN1's
    (1, 0), W_qkv (H, 3H), b_qkv, W_o (H, H), b_o, LN2's (1, 0), W_1
    (H, ffn), b_1, W_2 (ffn, H), b_2; LN_f's (1, 0); the head's W (out, H)
    Kaiming-normal and b. Every other weight and table N(0, 0.02), biases
    zero."""
    if cfg.get("arch") != "graphormer":
        raise ValueError(f"{cfg['name']}: benchmark/models/graphormer.py "
                         f"measures the program's Graphormer; its "
                         f"configuration sets arch 'graphormer', not "
                         f"{cfg.get('arch')!r}")
    g = generator(seed, "theta", device)
    H, K = cfg["graphormer_hidden"], cfg["graphormer_heads"]
    ffn = cfg["graphormer_ffn"]

    def normal(*shape):
        return torch.randn(*shape, generator=g, device=device) * INIT_STD

    def zeros(n):
        return torch.zeros(n, device=device)

    def ones(n):
        return torch.ones(n, device=device)
    out = [normal(cfg["feat_dim"], H), zeros(H), normal(TABLE_ROWS, H),
           normal(TABLE_ROWS, H), normal(TABLE_ROWS, K)]
    for _ in range(cfg["graphormer_layers"]):
        out += [ones(H), zeros(H), normal(H, 3 * H), zeros(3 * H),
                normal(H, H), zeros(H), ones(H), zeros(H), normal(H, ffn),
                zeros(ffn), normal(ffn, H), zeros(H)]
    n_out = cfg["labels_num"]
    w = torch.randn(n_out, H, generator=g, device=device)
    return out + [ones(H), zeros(H), w * math.sqrt(2.0 / H), zeros(n_out)]


def _projections(N: int, cfg: dict) -> float:
    """A layer's projection operations forward over N rows."""
    H, ffn = cfg["graphormer_hidden"], cfg["graphormer_ffn"]
    return 2.0 * N * H * (3 * H + H + 2 * ffn)


def _attention(B: int, n: int, cfg: dict) -> float:
    """A layer's attention operations forward over B graphs of n nodes:
    4 n^2 D a head, K heads of D."""
    return 4.0 * B * n * n * cfg["graphormer_hidden"]


def step_flops(cfg: dict) -> float:
    """Operations one meta-step of task_num tasks requires."""
    p, L = passes(cfg), cfg["graphormer_layers"]
    H, n_out = cfg["graphormer_hidden"], cfg["labels_num"]
    per_task = 0.0
    for name, s in zip(("spt", "qry"), set_shapes(cfg)):
        N = s.B * s.live
        lin = 2.0 * N * cfg["feat_dim"] * H
        layer = _projections(N, cfg) + _attention(s.B, s.live, cfg)
        head = 2.0 * s.S * H * n_out
        per_task += p[f"{name}_fwd"] * (lin + L * layer + head)
        per_task += p[f"{name}_bwd"] * (lin + 2 * L * layer + 2 * head)
    return cfg["task_num"] * per_task


def attention_calls(cfg: dict, direction: str):
    """(calls, graphs, nodes a graph) per meta-step: each attention call of
    one set of all task_num tasks in one layer, forward ("fwd") or
    backward ("bwd")."""
    p, T, L = passes(cfg), cfg["task_num"], cfg["graphormer_layers"]
    return [(L * p[f"{name}_{direction}"], T * s.B, s.live)
            for name, s in zip(("spt", "qry"), set_shapes(cfg))]


def _bound_ms(direction: str, graphs: int, n: int, cfg: dict) -> float:
    H, K = cfg["graphormer_hidden"], cfg["graphormer_heads"]
    N = graphs * n
    nbytes = 4.0 * N * (4 * H + K) + float(graphs) * n * n
    ops = 4.0 * graphs * n * n * H
    if direction != "fwd":
        nbytes += 4.0 * N * 4 * H
        ops *= 2
    return 1e3 * max(nbytes / HBM_BYTES_S, ops / FP32_PEAK)


def attention_bound_ms(cfg: dict, direction: str) -> float:
    """The least time, in ms, one meta-step's attention calls in one
    direction can take on the card (module docstring)."""
    return sum(calls * _bound_ms(direction, graphs, n, cfg)
               for calls, graphs, n in attention_calls(cfg, direction))


def aggregation_bound_ms(cfg: dict, itemsize: int = 4) -> float:
    """The model's mixing of rows, its attention, both directions (float32:
    `itemsize` is the only width it takes)."""
    if itemsize != 4:
        raise ValueError("Graphormer's attention is float32")
    return attention_bound_ms(cfg, "fwd") + attention_bound_ms(cfg, "bwd")
