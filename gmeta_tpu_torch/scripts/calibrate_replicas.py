"""Replica difficulty calibration: numpy proxies of few-shot accuracy, no
training, with the aggregation on the card.

Counterpart of scripts/calibrate_replicas.py. The replica generators
(data/replicas.py) have difficulty knobs (class-signal strength, label
noise, hub mix). Each proxy estimates the few-shot accuracy a trained
2-layer GCN with a prototype head can reach on a candidate replica, so
that the knobs can be tuned to the reference's accuracy band without a
training run:

- The ProtoMAML head classifies by log_softmax(-||q - c_k||^2) over the
  class prototypes. For n_way = 2 that is a linear classifier in logit
  space, for n_way = 3 a piecewise-linear one, so the learnable signal is
  the mean separation of the classes under a linear map of the embedding.
- A trained h-layer GCN embedding is a learned channel mixing of the
  symmetric-normalised h-hop aggregate A_hat^h X (plus ReLUs). Prototype
  accuracy in raw A_hat^h X space (no mixing) brackets it from below, and
  LDA accuracy in that space (the best linear mixing) roughly from above.

The graphs, labels, features and episodes are the JAX script's numpy
`RandomState` draws in its order, so both score the same episodes. Only
`agg_hops` differs: it runs on the device through the full-graph gather
(ops/sized_spmm.py `csr_gather`: `csr_slab_kernel`, and
`csr_combine_kernel` for rows of more than `CHUNK` edges, on the card;
`csr_plain` on the CPU), in float32, where numpy computes in float64
from the first hop on. The embedding comes back to the host once per
graph, as float64, and the episodes are scored there in numpy.

    python -m gmeta_tpu_torch.scripts.calibrate_replicas [recipe ...]
        [--device cpu] [--out PATH]

Runs on the card unless given `--device cpu`; `agg_hops` also takes
float64 on the CPU, where it reproduces numpy's arithmetic.
Writes parity_torch/cal/calibrate_replicas.json: per recipe both proxies,
the JAX script's values (`JAX_CPU`), seconds, and the graphs, edges and
split rows of its gathers.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from gmeta_tpu_torch.data.replicas import (block_labels, class_features,
                                           fold_graph, link_features,
                                           ring_actz_pairs, ring_hub_pairs,
                                           shared_subspace_centers,
                                           smooth_field)
from gmeta_tpu_torch.ops import sized_spmm as sp
from gmeta_tpu_torch.scripts.common import ROOT, finish, fmt, parser, start
from gmeta_tpu_torch.utils.device import resolve_device
from gmeta_tpu_torch.utils.metrics import counted

OUT = ROOT / "parity_torch" / "cal" / "calibrate_replicas.json"

# What the gathers of the proxies since the last `reset_hop_stats` saw.
hop_stats = {"graphs": 0, "edges": 0, "split_rows": 0}


def reset_hop_stats():
    for k in hop_stats:
        hop_stats[k] = 0


def hop_gather(pair: sp.CsrPair, h: torch.Tensor) -> torch.Tensor:
    """One hop's A @ h over the pair's destination CSR: the kernel on the
    card, `csr_plain` on the CPU."""
    return sp.csr_gather(pair.row_ptr, pair.col, h, "fwd", pair.split)


def agg_hops(pairs: np.ndarray, n: int, X: np.ndarray, hops: int = 2,
             device=None, dtype=torch.float32, gather=hop_gather):
    """A_hat^hops X with the reference's symmetric clamp-normalisation and
    no self-loop, on the bidirectionalised edge set, as (n, F) float64 on
    the host. The edges keep their duplicates, which count as often as
    the list holds them (np.add.at's sum). `gather(pair, h)` computes one
    hop's A @ h; on the card `h` is float32. `device` defaults to the card
    (utils/device.py `resolve_device`)."""
    device = resolve_device(device)
    src = np.concatenate([pairs[:, 0], pairs[:, 1]])
    dst = np.concatenate([pairs[:, 1], pairs[:, 0]])
    pair = sp.csr_pair(src, dst, n, n).to(device)
    deg = (pair.row_ptr[1:] - pair.row_ptr[:-1]).to(dtype)
    norm = deg.clamp(min=1.0).rsqrt()[:, None]
    h = torch.from_numpy(np.asarray(X, np.float32)).to(device, dtype)
    for _ in range(hops):
        h = gather(pair, h * norm) * norm
    hop_stats["graphs"] += 1
    hop_stats["edges"] += int(src.size)
    hop_stats["split_rows"] += int(pair.split.rows.numel())
    return h.cpu().numpy().astype(np.float64)


def proto_acc(emb_by_class, k_spt, k_qry, episodes, rng, lda=False):
    """Mean episodic prototype accuracy. emb_by_class: list of (N_c, F)
    embeddings, one per class of the episode universe (classes are sampled
    n_way at a time when more than n_way given)."""
    n_way = len(emb_by_class)
    accs = []
    for _ in range(episodes):
        spt, qry, qy = [], [], []
        for c, E in enumerate(emb_by_class):
            idx = rng.choice(len(E), k_spt + k_qry, replace=False)
            spt.append(E[idx[:k_spt]])
            qry.append(E[idx[k_spt:]])
            qy.append(np.full(k_qry, c))
        qry = np.concatenate(qry)
        qy = np.concatenate(qy)
        if lda:
            # whiten by pooled within-class covariance (diagonal, shrunk)
            pooled = np.concatenate([s - s.mean(0) for s in spt])
            var = pooled.var(0) + 1e-3 * pooled.var() + 1e-12
            w = var ** -0.5
            protos = np.stack([(s * w).mean(0) for s in spt])
            qw = qry * w
        else:
            protos = np.stack([s.mean(0) for s in spt])
            qw = qry
        d2 = ((qw[:, None, :] - protos[None]) ** 2).sum(-1)
        accs.append((d2.argmin(1) == qy).mean())
    return float(np.mean(accs))


def _episode_pairs(emb, y, classes, n_way, k_spt, k_qry, episodes, rng):
    lo, hi = [], []
    for _ in range(episodes // 50):
        cls = rng.choice(classes, n_way, replace=False)
        by = [emb[y == c] for c in cls]
        lo.append(proto_acc(by, k_spt, k_qry, 50, rng, lda=False))
        hi.append(proto_acc(by, k_spt, k_qry, 50, rng, lda=True))
    return np.mean(lo), np.mean(hi)


# ---- node recipes -----------------------------------------------------------

def proxy_node(n, feat_dim, classes, n_way, k_spt, k_qry, local_k, hub_deg,
               hub_alpha, noise, signal, episodes=300, seed=0, rank=0,
               **hop):
    """One big graph, ring-block labels; `hop` goes to `agg_hops`."""
    rng = np.random.RandomState(seed)
    pairs = ring_hub_pairs(n, local_k, hub_deg, hub_alpha, rng)
    y = block_labels(n, classes, noise, rng)
    centers = (shared_subspace_centers(classes, feat_dim, rank, rng)
               if rank else rng.randn(classes, feat_dim).astype(np.float32))
    X = class_features(y, feat_dim, signal, centers, rng)
    emb = agg_hops(pairs, n, X, 2, **hop)
    return _episode_pairs(emb, y, classes, n_way, k_spt, k_qry, episodes,
                          rng)


def proxy_tissue(n, feat_dim, local_k, hub_deg, base_win, feat_noise,
                 spike_dim=6, spike=3.0, k_spt=3, k_qry=10, episodes=300,
                 seed=0, **hop):
    """Binary tasks on a smooth field's spiked directions."""
    rng = np.random.RandomState(seed)
    pairs = ring_hub_pairs(n, local_k, hub_deg, 0.75, rng)
    base = smooth_field(n, feat_dim, base_win, rng)
    base[:, :spike_dim] *= spike
    X = (base + feat_noise * rng.randn(n, feat_dim)).astype(np.float32)
    emb = agg_hops(pairs, n, X, 2, **hop)
    lo, hi = [], []
    for _ in range(episodes // 50):
        w = np.zeros(feat_dim)
        w[:spike_dim] = rng.randn(spike_dim)
        w /= np.linalg.norm(w)
        yt = (base @ w > 0)
        by = [emb[~yt], emb[yt]]
        lo.append(proto_acc(by, k_spt, k_qry, 50, rng, lda=False))
        hi.append(proto_acc(by, k_spt, k_qry, 50, rng, lda=True))
    return np.mean(lo), np.mean(hi)


def proxy_fold(n_graphs, n, feat_dim, classes, local_k, hub_deg, hub_alpha,
               noise, signal, assort, n_way=3, k_spt=3, k_qry=24,
               episodes=200, seed=0, rank=0, **hop):
    """Fold geometry: many small graphs (a 2-hop neighbourhood spans about
    half a graph), class-assortative hubs, episodes drawn across graphs;
    one `agg_hops` per graph."""
    rng = np.random.RandomState(seed)
    centers = (shared_subspace_centers(classes, feat_dim, rank, rng)
               if rank else rng.randn(classes, feat_dim).astype(np.float32))
    embs, ys = [], []
    for _ in range(n_graphs):
        pairs, y = fold_graph(n, classes, local_k, hub_deg, hub_alpha,
                              noise, assort, rng)
        X = class_features(y, feat_dim, signal, centers, rng)
        embs.append(agg_hops(pairs, n, X, 2, **hop))
        ys.append(y)
    emb = np.concatenate(embs)
    y = np.concatenate(ys)
    return _episode_pairs(emb, y, classes, n_way, k_spt, k_qry, episodes,
                          rng)


# ---- link recipes -----------------------------------------------------------

def proxy_link(n, feat_dim, local_k, hub_deg, feature_kind, k_spt=16,
               k_qry=16, episodes=200, seed=0, noise=0.3, beta=2.0,
               z_win=16, **hop):
    """Endpoint-concat prototype accuracy for the link replicas: positives
    are graph edges (hub endpoints drawn by the smooth activity field),
    negatives sampled uniformly."""
    rng = np.random.RandomState(seed)
    pairs, z = ring_actz_pairs(n, local_k, hub_deg, beta, z_win, rng)
    deg = np.zeros(n)
    np.add.at(deg, pairs[:, 0], 1.0)
    np.add.at(deg, pairs[:, 1], 1.0)
    X = link_features(n, deg, z, feature_kind, rng, noise=noise)
    emb = agg_hops(pairs, n, X, 2, **hop)

    m = len(pairs)
    a = rng.randint(0, n, 4 * m)
    b = rng.randint(0, n - 1, 4 * m)
    b = np.where(b >= a, b + 1, b)
    negs = np.stack([a, b], 1)

    pos_emb = np.concatenate([emb[pairs[:, 0]], emb[pairs[:, 1]]], 1)
    neg_emb = np.concatenate([emb[negs[:, 0]], emb[negs[:, 1]]], 1)
    lo = proto_acc([neg_emb, pos_emb], k_spt, k_qry, episodes, rng, lda=False)
    hi = proto_acc([neg_emb, pos_emb], k_spt, k_qry, episodes, rng, lda=True)
    return lo, hi


RECIPE_PROXIES = {
    # the JAX script's: scale-reduced graphs with the replicas' per-node
    # statistics; targets (final / early-stopped test accuracy) from the
    # reference (test.ipynb); each function takes `agg_hops`' keywords
    "arxiv": (lambda **hop: proxy_node(
        40_000, 128, 40, 3, 3, 24, local_k=5, hub_deg=3.6, hub_alpha=0.85,
        noise=0.65, signal=0.15, rank=16, **hop), (0.421, 0.436)),
    "tissue_ppi": (lambda **hop: proxy_tissue(
        4_000, 50, local_k=10, hub_deg=8.0, base_win=24, feat_noise=0.6,
        spike_dim=2, spike=3.0, **hop), (0.780, 0.774)),
    "fold_ppi": (lambda **hop: proxy_fold(
        16, 1_200, 512, 29, local_k=4, hub_deg=4.0, hub_alpha=0.8,
        noise=0.50, signal=0.18, assort=0.5, rank=6, **hop), (0.578, 0.656)),
    "firstmm_db": (lambda **hop: proxy_link(
        1_350, 5, local_k=1, hub_deg=4.0, feature_kind="structural",
        noise=0.3, beta=2.5, z_win=32, **hop), (0.769, 0.756)),
    "tree_of_life": (lambda **hop: proxy_link(
        2_900, 1, local_k=3, hub_deg=7.5, feature_kind="degree",
        noise=0.4, beta=2.5, z_win=32, **hop), (0.694, 0.723)),
}

# The JAX script's (proto, lda) at these sizes, numpy float64 on the CPU
# (tests/test_torch_calibrate.py recomputes them).
JAX_CPU = {
    "arxiv": (0.4085185185185185, 0.4015277777777777),
    "tissue_ppi": (0.7275, 0.5733333333333334),
    "fold_ppi": (0.6883333333333332, 0.6665277777777778),
    "firstmm_db": (0.7640625, 0.74484375),
    "tree_of_life": (0.67796875, 0.67140625),
}


def run(names, device, gather=hop_gather) -> dict:
    """Each recipe's proxies on `device`, float32: {name: row}."""
    rows = {}
    for name in names:
        fn, (tgt_final, tgt_early) = RECIPE_PROXIES[name]
        reset_hop_stats()
        t0 = time.time()
        lo, hi = fn(device=device, gather=gather)
        rows[name] = {"proto": float(lo), "lda": float(hi),
                      "jax_cpu": list(JAX_CPU[name]),
                      "target": [tgt_final, tgt_early],
                      "seconds": time.time() - t0, **hop_stats}
        print(f"{name}: proto(A^2X)={lo:.3f}  lda(A^2X)={hi:.3f}  "
              f"target={tgt_final:.3f}/{tgt_early:.3f}", flush=True)
    return rows


def main(argv=None):
    ap = parser("calibrate_replicas", __doc__)
    ap.set_defaults(out=str(OUT))
    ap.add_argument("recipes", nargs="*", choices=list(RECIPE_PROXIES) + [[]])
    args = ap.parse_args(argv)
    device, head = start(args.device)
    with counted() as c:
        rows = run(args.recipes or list(RECIPE_PROXIES), device)
    result = dict(head, dtype="float32", recipes=rows, launches={
        "csr_gather": c[sp.CSR_LAUNCHES["fwd"]],
        "combine": c[sp.COMBINE_LAUNCHES["fwd"]]})
    lines = ["| recipe | proto | lda | JAX proto | JAX lda | target | s "
             "| graphs | edges | split rows |", "|---" * 10 + "|"]
    for name, r in rows.items():
        lines.append("| " + " | ".join(
            [name] + [fmt(r[k], 4) for k in ("proto", "lda")]
            + [fmt(x, 4) for x in r["jax_cpu"]]
            + ["/".join(f"{x:.3f}" for x in r["target"]), fmt(r["seconds"], 2),
               str(r["graphs"]), str(r["edges"]), str(r["split_rows"])])
            + " |")
    return finish(result, args.out, lines)


if __name__ == "__main__":
    main()
