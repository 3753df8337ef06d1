"""The GAT of Velickovic et al. (ICLR 2018, arXiv:1710.10903, section 3.3,
inductive PPI form), the model of configurations whose `model` is `gat`
and whose `arch`, the program's architecture, is `gat` too (`make_theta`
refuses one without it, so that the program cannot run a GCN here):
three GAT layers (K heads of F features concatenated and ELU, twice, an
identity skip across the middle layer, then K' heads of F' averaged), G-Meta's
centre readout and Linear head (benchmark/reference/gat_protomaml.py has
the equations).

- `make_theta`: the published initialisation from the run's seed;
- `Reference`: the plain first-order ProtoMAML step of this GAT;
- `step_flops`: the operations one meta-step requires;
- `attention_bound_ms(cfg, direction)`: the least time the meta-step's
  attention calls take, forward or backward (the rooflines
  `attn_fwd_roofline` and `attn_bwd_roofline`);
- `aggregation_bound_ms`: the same for both directions, the model's
  aggregation.

What is counted follows counts/model.py's rules: what the model needs over
the REAL nodes and edges of each packed set (pad slots, pad bins and pad
edges left out), for every pass the configuration asks for
(`counts.model.passes`), no recomputation, elementwise passes (ELU, bias,
skip, the mean over heads, the softmax's exponentials) left out. A set of
n live nodes and E real edges has M = E + n attention terms a head (each
edge and each node's self term).

A layer's forward: the projection and both scores, 2 n fan_in K F and
2 * 2 n K F; the weighted sums, 2 M K F. Its backward: W's gradient,
2 n fan_in K F, and the input's past the first layer (the features are
not trained), the same again; both scores' vectors and their share of z's
gradient, 2 * 2 * 2 n K F; through the weighted sums, the gradient of z
(sum of alpha g) and of each weight (g . z), 2 * 2 M K F. The head as
counts/model.py counts it.

An attention call's bound, in bytes and operations at counts/peaks.py's
rates, counts the function's own traffic once: forward, zst (z, s, t) read,
o and the log-sum-exp written, the CSR (row pointers and sources) read;
backward, zst, o, the log-sum-exp and the gradient of o read, the gradient
of zst written, the CSR read. Its operations: 2 M K F forward, 4 M K F
backward. Rows are the real nodes', as counts/model.py's gather bound
takes them.
"""

from __future__ import annotations

import math

import torch

from benchmark.counts.model import passes, set_shapes
from benchmark.counts.peaks import FP32_PEAK, HBM_BYTES_S
from benchmark.generate import generator
from benchmark.reference.gat_protomaml import Reference, layers

__all__ = ["make_theta", "Reference", "step_flops", "aggregation_bound_ms",
           "attention_bound_ms"]


def make_theta(cfg: dict, seed: int, device) -> list:
    """The flat (W, a_src, a_dst, b) x 3, W_head, b_head float32
    parameters: W (fan_in, K*F) Xavier-uniform; a_src, a_dst (K, F)
    uniform within sqrt(6 / (K + F)) (PyG's glorot over (1, K, F)); b
    zero, (K*F) or, averaged, (F,); the head's W (out, F') Kaiming-normal,
    its b zero."""
    if cfg.get("arch") != "gat":
        raise ValueError(f"{cfg['name']}: benchmark/models/gat.py measures "
                         f"the program's GAT; its configuration sets "
                         f"arch 'gat', not {cfg.get('arch')!r}")
    g = generator(seed, "theta", device)

    def uniform(shape, a):
        return torch.rand(*shape, generator=g, device=device) * (2 * a) - a
    out = []
    for fan_in, K, F, concat, _ in layers(cfg):
        out.append(uniform((fan_in, K * F), math.sqrt(6.0 / (fan_in + K * F))))
        a = math.sqrt(6.0 / (K + F))
        out += [uniform((K, F), a), uniform((K, F), a),
                torch.zeros(K * F if concat else F, device=device)]
    F_out, n_out = cfg["gat_out_dim"], cfg["labels_num"]
    w = torch.randn(n_out, F_out, generator=g, device=device)
    return out + [w * math.sqrt(2.0 / F_out),
                  torch.zeros(n_out, device=device)]


def _forward_flops(n: int, E: int, cfg: dict) -> float:
    f = 0.0
    for fan_in, K, F, _, _ in layers(cfg):
        f += 2.0 * n * fan_in * K * F + 4.0 * n * K * F \
            + 2.0 * (E + n) * K * F
    return f


def _backward_flops(n: int, E: int, cfg: dict) -> float:
    f = 0.0
    for li, (fan_in, K, F, _, _) in enumerate(layers(cfg)):
        f += 2.0 * n * fan_in * K * F * (2 if li > 0 else 1) \
            + 8.0 * n * K * F + 4.0 * (E + n) * K * F
    return f


def step_flops(cfg: dict) -> float:
    """Operations one meta-step of task_num tasks requires."""
    p = passes(cfg)
    head = 2.0 * cfg["gat_out_dim"] * cfg["labels_num"]
    per_task = 0.0
    for name, s in zip(("spt", "qry"), set_shapes(cfg)):
        per_task += p[f"{name}_fwd"] * (_forward_flops(s.nodes, s.edges, cfg)
                                        + head * s.S)
        per_task += p[f"{name}_bwd"] * (_backward_flops(s.nodes, s.edges,
                                                        cfg) + 2 * head * s.S)
    return cfg["task_num"] * per_task


def attention_calls(cfg: dict, direction: str):
    """(calls, rows, edges, K, F) per meta-step: each attention call of
    one set of all task_num tasks in one layer, forward ("fwd") or
    backward ("bwd"), with its real rows and edges."""
    p, T = passes(cfg), cfg["task_num"]
    return [(p[f"{name}_{direction}"], T * s.nodes, T * s.edges, K, F)
            for name, s in zip(("spt", "qry"), set_shapes(cfg))
            for _, K, F, _, _ in layers(cfg)]


def _bound_ms(direction: str, n: int, E: int, K: int, F: int) -> float:
    ld, csr = K * F + 2 * K, 4.0 * (n + 1 + E)
    if direction == "fwd":
        nbytes = 4.0 * n * (ld + K * F + K) + csr
        ops = 2.0 * (E + n) * K * F
    else:
        nbytes = 4.0 * n * (2 * ld + 2 * K * F + K) + csr
        ops = 4.0 * (E + n) * K * F
    return 1e3 * max(nbytes / HBM_BYTES_S, ops / FP32_PEAK)


def attention_bound_ms(cfg: dict, direction: str) -> float:
    """The least time, in ms, one meta-step's attention calls in one
    direction can take on the card (module docstring)."""
    return sum(calls * _bound_ms(direction, n, E, K, F)
               for calls, n, E, K, F in attention_calls(cfg, direction))


def aggregation_bound_ms(cfg: dict, itemsize: int = 4) -> float:
    """The model's aggregation, its attention, both directions (float32:
    `itemsize` is the only width it takes)."""
    if itemsize != 4:
        raise ValueError("the GAT's attention is float32")
    return attention_bound_ms(cfg, "fwd") + attention_bound_ms(cfg, "bwd")
