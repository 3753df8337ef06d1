"""Inputs of a cell, made from its seed: theta, the feature table, the task
pool and the order the steps take its tasks in.

One general generator serves every configuration and traffic mix; what it
makes follows from their files' numbers alone. Everything is drawn on the
given device with `torch.Generator`s in a few large calls, each part from a
seed of its own derived from the run's, so the same seed gives the same
inputs whatever else the run draws.

The pool replays a run of record's packed geometry (the configuration's
`buckets`, `mean_bin_fill` and `mean_edges_per_task`), as the port's
bench.py `_synth_set` does: every bin holds the same `live` real nodes at
its first slots, the set's real edges join random live slots of one bin
and are sorted by destination, pad edges run from slot 0 to the last slot
with mask 0, and a real subgraph's neighbourhood is a narrow window of the
feature table (each bin's gids lie within 4P rows of a random base).
Unlike bench.py's, every live node has an in-edge, as in an h-hop
subgraph, where each node is reached from its centre: an isolated node's
last-layer pre-activation is its bias alone, zero at the initialisation,
and the side of the ReLU it then takes is decided by rounding-level
numbers (the prototype loss is blind to a shift of all centres alike),
which made the meta-step's gradient part from the float64 reference's by
up to 1e-4 on some seeds in float32 alike (PERF.md).
Every task of every seed has the same sizes; only the content differs, so
a step's work does not depend on the seed.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from benchmark.counts.model import SetShape, layers, set_shapes

SHARED = ("node_mask", "edge_mask", "labels", "bin_fill")   # alike in all


def sub_seed(seed: int, *keys) -> int:
    """A seed for one part of a run, from the run's seed (any integer)."""
    text = repr((int(seed),) + keys).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(seed: int, key: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, key))
    return g


def make_theta(cfg: dict, seed: int, device) -> list:
    """The flat (W, b, W, b, ..., W_head, b_head) float32 parameters with
    the published initialisation (G-Meta learner.py): GraphConv W (in, out)
    Xavier-uniform, the head's W (out, in) Kaiming-normal, biases zero."""
    g = generator(seed, "theta", device)
    gcn, (head_in, n_out) = layers(cfg)
    out = []
    for fi, fo in gcn:
        a = math.sqrt(6.0 / (fi + fo))
        w = torch.rand(fi, fo, generator=g, device=device) * (2 * a) - a
        out += [w, torch.zeros(fo, device=device)]
    w = torch.randn(n_out, head_in, generator=g, device=device)
    out += [w * math.sqrt(2.0 / head_in), torch.zeros(n_out, device=device)]
    return out


def make_features(cfg: dict, seed: int, device) -> torch.Tensor:
    """(feature_rows, feat_dim) float32, standard normal."""
    g = generator(seed, "features", device)
    return torch.randn(cfg["feature_rows"], cfg["feat_dim"], generator=g,
                       device=device)


def _draw_set(g, s: SetShape, n: int, cfg: dict, device) -> dict:
    """n tasks' packed set of shape s, as device tensors; the fields that
    every task shares (the masks, labels and bin fill) with a leading axis
    of 1."""
    B, P, E, S, L, e = s
    rows = cfg["feature_rows"]
    if rows <= 4 * P:
        raise ValueError(f"a feature table of {rows} rows cannot hold the "
                         f"gid windows of P = {P} (needs > {4 * P})")
    live = torch.arange(P, device=device) < L
    base = torch.randint(0, rows - 4 * P, (n, B, 1), generator=g,
                         device=device)
    off = torch.randint(0, 4 * P, (n, B, P), generator=g, device=device)
    node_gid = (base + off) * live
    if e < B * L:
        raise ValueError(f"{e} real edges cannot reach all {B * L} live "
                         f"nodes of a set")
    # every live node's first in-edge, then the rest between random slots
    slots = torch.arange(B * L, device=device)
    first = (slots // L * P + slots % L).expand(n, B * L)
    bins = torch.cat([first // P, torch.randint(
        0, B, (n, e - B * L), generator=g, device=device)], dim=1)
    src = bins * P + torch.randint(0, L, (n, e), generator=g, device=device)
    dst = torch.cat([first, bins[:, B * L:] * P + torch.randint(
        0, L, (n, e - B * L), generator=g, device=device)], dim=1)
    dst, order = torch.sort(dst, dim=1, stable=True)
    src = torch.gather(src, 1, order)
    edge_src = torch.zeros(n, E, dtype=torch.int64, device=device)
    edge_dst = torch.full((n, E), B * P - 1, dtype=torch.int64,
                          device=device)
    edge_src[:, :e], edge_dst[:, :e] = src, dst
    k = torch.arange(S, device=device)
    c0 = (k % B) * P + torch.randint(0, L, (n, S), generator=g,
                                     device=device)
    c1 = ((k % B) * P + torch.randint(0, L, (n, S), generator=g,
                                      device=device)
          if cfg["link_pred_mode"] else c0)
    return {"node_gid": node_gid.int(),
            "node_mask": live.float().expand(1, B, P),
            "edge_src": edge_src.int(), "edge_dst": edge_dst.int(),
            "edge_mask": (torch.arange(E, device=device) < e).float()[None],
            "centers": torch.stack([c0, c1], dim=-1).int(),
            "labels": (k % cfg["labels_num"]).int()[None],
            "bin_fill": torch.full((1, B), L, dtype=torch.int32,
                                   device=device)}


def make_pool(cfg: dict, n_tasks: int, seed: int, device,
              chunk: int = 256):
    """(support, query): dicts of the fields of the program's packed sets
    (data/pack.py `SubgraphSet`), numpy arrays with a leading axis of
    n_tasks, drawn on `device` `chunk` tasks at a time. The fields every
    task shares are one task's array broadcast (read-only views)."""
    g = generator(seed, "pool", device)
    out = []
    for s in set_shapes(cfg):
        host = None
        for lo in range(0, n_tasks, chunk):
            n = min(chunk, n_tasks - lo)
            part = _draw_set(g, s, n, cfg, device)
            if host is None:
                host = {k: (np.broadcast_to(v.cpu().numpy(),
                                            (n_tasks,) + tuple(v.shape[1:]))
                            if k in SHARED else
                            np.empty((n_tasks,) + tuple(v.shape[1:]),
                                     dtype=np.dtype(str(v.dtype)[6:])))
                        for k, v in part.items()}
            for k, v in part.items():
                if k not in SHARED:
                    torch.from_numpy(host[k][lo:lo + n]).copy_(v)
        out.append(host)
    return tuple(out)


def take(sets, rows) -> tuple:
    """The tasks `rows` of a (support, query) pool, as copies."""
    return tuple({k: np.ascontiguousarray(v[rows]) for k, v in s.items()}
                 for s in sets)


def task_order(n_tasks: int, task_num: int, seed: int):
    """Rows of task_num task indices, one per meta-step: each epoch a
    permutation of the pool drawn from the seed, cut into whole steps (the
    Trainer's `_epoch_steps`). No task repeats within an epoch."""
    steps = n_tasks // task_num
    epoch = 0
    while True:
        g = torch.Generator()
        g.manual_seed(sub_seed(seed, "order", epoch))
        perm = torch.randperm(n_tasks, generator=g).numpy()
        yield from perm[:steps * task_num].reshape(steps, task_num)
        epoch += 1
