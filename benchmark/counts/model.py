"""The work one meta-step requires, counted from a configuration's shapes.

What is counted is what the model needs, not what a program executes: the
products of the GCN's projections and the head, and the aggregations over
the REAL nodes and edges of each packed set (pad slots, pad bins and pad
edges are left out), for every pass that the configuration asks for. A
recomputation (`remat_inner`) is not counted, and an aggregation counts the
same whether a program runs it as a gather or as a dense product, so the
count stays put when the program changes. Elementwise passes, the losses
and Adam are left out: they are a vanishing share of the operations.

Passes per task and meta-step, for K = update_step (meta/maml.py's loop):
- support: K forwards and K backwards (the inner gradients), one more
  backward for the meta-gradient through the last prototypes, and with
  the training curve one more forward (the step-0 evaluation);
- query: one forward and one backward (the meta-loss), and with the
  training curve K more forwards (step 0's and each earlier step's
  evaluation).

A backward takes each weight's gradient (2 n fan_in fan_out for a
projection), each activation's gradient but the input's (the features are
not trained), and the transposed aggregation wherever the gradient has to
pass back through one.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

from benchmark.counts.peaks import gather_bound


class SetShape(NamedTuple):
    """One packed set of a task: B bins of P slots, `live` real nodes in
    every bin, E edge slots of which `edges` are real, S centres."""
    B: int
    P: int
    E: int
    S: int
    live: int
    edges: int

    @property
    def nodes(self) -> int:
        return self.B * self.live


def set_shapes(cfg: dict) -> Tuple[SetShape, SetShape]:
    """(support, query) shapes of a configuration: its record's buckets,
    bin fill and real edges a task, split between the two sets in
    proportion to their edge slots."""
    b = cfg["buckets"]
    e_tot = b["E_spt"] + b["E_qry"]
    out = []
    for s, k in (("spt", cfg["k_spt"]), ("qry", cfg["k_qry"])):
        P, E = b[f"P_{s}"], b[f"E_{s}"]
        live = min(max(int(round(cfg["mean_bin_fill"] * P)), 1), P)
        edges = min(int(round(cfg["mean_edges_per_task"] * E / e_tot)), E)
        out.append(SetShape(b[f"B_{s}"], P, E, cfg["n_way"] * k, live,
                            edges))
    return tuple(out)


def layers(cfg: dict) -> Tuple[List[Tuple[int, int]], Tuple[int, int]]:
    """The GCN's (fan_in, fan_out) per GraphConv layer, h of them, and the
    head's (input, output) width: twice the hidden width under link
    prediction, where both endpoints' embeddings are joined."""
    H = cfg["hidden_dim"]
    gcn = [(cfg["feat_dim"], H)] + [(H, H)] * (cfg["h"] - 1)
    head_in = 2 * H if cfg["link_pred_mode"] else H
    return gcn, (head_in, cfg["labels_num"])


def agg_width(fan_in: int, fan_out: int) -> int:
    """The width a layer aggregates at: it projects first where that
    shrinks the rows (the published model's order switch)."""
    return fan_out if fan_in > fan_out else fan_in


def _needs_transpose(li: int, fan_in: int, fan_out: int) -> bool:
    """Whether a backward passes through layer li's aggregation: always
    past the first layer, and in the first only where it projects first
    (otherwise the aggregation reads the untrained features)."""
    return li > 0 or fan_in > fan_out


def forward_flops(s: SetShape, cfg: dict) -> float:
    gcn, (head_in, n_out) = layers(cfg)
    f = sum(2.0 * s.nodes * fi * fo + 2.0 * s.edges * agg_width(fi, fo)
            for fi, fo in gcn)
    return f + 2.0 * s.S * head_in * n_out


def backward_flops(s: SetShape, cfg: dict) -> float:
    gcn, (head_in, n_out) = layers(cfg)
    f = 0.0
    for li, (fi, fo) in enumerate(gcn):
        f += 2.0 * s.nodes * fi * fo * (2 if li > 0 else 1)
        if _needs_transpose(li, fi, fo):
            f += 2.0 * s.edges * agg_width(fi, fo)
    return f + 4.0 * s.S * head_in * n_out


def passes(cfg: dict) -> dict:
    """Passes per task and meta-step (module docstring)."""
    K, curve = cfg["update_step"], bool(cfg["track_train_curve"])
    return {"spt_fwd": K + curve, "spt_bwd": K + 1,
            "qry_fwd": 1 + K * curve, "qry_bwd": 1}


def step_flops(cfg: dict) -> float:
    """Operations one meta-step of task_num tasks requires."""
    spt, qry = set_shapes(cfg)
    p = passes(cfg)
    per_task = (p["spt_fwd"] * forward_flops(spt, cfg)
                + p["spt_bwd"] * backward_flops(spt, cfg)
                + p["qry_fwd"] * forward_flops(qry, cfg)
                + p["qry_bwd"] * backward_flops(qry, cfg))
    return cfg["task_num"] * per_task


def aggregation_calls(cfg: dict) -> List[Tuple[int, int, int]]:
    """(calls, nnz, H, rows) per meta-step: each aggregation the model
    requires, over one set of all task_num tasks at once (as a program
    that batches tasks launches it), with its real edges and rows."""
    gcn, _ = layers(cfg)
    p = passes(cfg)
    T = cfg["task_num"]
    out = []
    for name, s in zip(("spt", "qry"), set_shapes(cfg)):
        for li, (fi, fo) in enumerate(gcn):
            calls = p[f"{name}_fwd"]
            if _needs_transpose(li, fi, fo):
                calls += p[f"{name}_bwd"]
            out.append((calls, T * s.edges, agg_width(fi, fo), T * s.nodes))
    return out


def aggregation_bound_ms(cfg: dict, itemsize: int = 4) -> float:
    """The least time, in ms, a meta-step's required aggregations can take
    on the card: each call's gather bound (peaks.gather_bound) over its
    real edges, rows read and rows written."""
    return sum(calls * gather_bound(nnz, H, rows, rows, itemsize)[0]
               for calls, nnz, H, rows in aggregation_calls(cfg))
