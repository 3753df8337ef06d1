"""Device time per meta-step of GAT's edge attention, forward and backward:
the program's `attn` spans (ops/gat_attention.py `attend` and its
backward), in any phase (benchmark/program_spans.py). Nothing to read
where the program recorded no `attn` span (a GCN, or a program without the
span)."""

from benchmark.program_spans import all_ms_per_step, window

UNIT = "ms"


def read(ctx):
    w = window(ctx)
    if w is None:
        return None
    spans, inside = w
    if not any(spans[i].name == "attn" for i in inside):
        return None
    return all_ms_per_step(ctx, "attn")
