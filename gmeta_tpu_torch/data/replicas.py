"""Scale-faithful replica datasets of the five reference recipes.

Counterpart of scripts/make_replicas.py: the same generators, recipes,
seeds and calibrated knobs, written through the port's own data prep
(gmeta_tpu_torch/data/prepare.py, a copy of the JAX package's), so that
for every recipe and seed it writes the same files, byte for byte. The
accuracy-parity runner (run/parity.py) evaluates and trains on them, and
the `DATASET` marker of a run-of-record checkpoint (parity/<recipe>.ckpt)
holds its replica's graphs.npz size.

The real downloads (G-Meta/README.md:183-186, a Google Drive folder) are
not part of the repository. Each replica matches the reference dataset's
published scale:

| recipe       | graphs x nodes   | feat | classes | calibration source          |
|--------------|------------------|------|---------|------------------------------|
| arxiv        | 1 x 169,343      | 128  | 40      | ogbn-arxiv stats; params 99,587 => input_dim 128 |
| tissue_ppi   | 24 x ~4,000      | 50   | 2 x 10 tasks | params 23,298 => input_dim 50, total_class 2 |
| fold_ppi     | 144 x ~1,200     | 512  | 29      | params 82,563 => input_dim 512 |
| firstmm_db   | 41 x ~1,350      | 5    | 2 (link)| params 17,794 => input_dim 5 |
| tree_of_life | 1,840 x ~2,900   | 1    | 2 (link)| params 67,330 => input_dim 1 |

input_dim values are solved from the reference's printed trainable-
parameter counts given the recipe's hidden_dim, so every replica
reproduces the reference model's parameter count.

Graph generator: ring locality + power-law hubs. Local edges give the
clustering/homophily real citation and PPI graphs have; hub edges with a
zipf-weighted endpoint give the heavy degree tail that makes 2-hop
neighborhoods reach the `sample_nodes`=1000 cap. Difficulty knobs are the
ones scripts/make_replicas.py documents and calibrated.

Usage: python -m gmeta_tpu_torch.data.replicas [recipe ...] [--out DIR]
(each recipe is written to DIR/<recipe>; DIR defaults to `replicas`).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from gmeta_tpu_torch.data.graph import CSRGraph
from gmeta_tpu_torch.data.prepare import (prepare_link,
                                          prepare_node_disjoint,
                                          prepare_node_shared_tasks)


# ---- graph generator --------------------------------------------------------

def ring_hub_pairs(n: int, local_k: int, hub_deg: float, hub_alpha: float,
                   rng: np.random.RandomState, max_hub_w: float = 0.02,
                   return_hub_w: bool = False):
    """Undirected edge pairs (E, 2): ring-local (i, i+d) for d in 1..local_k
    plus n*hub_deg/2 hub pairs whose second endpoint is drawn from a zipf
    distribution over a random node permutation (capped at max_hub_w mass per
    node so no single hub's 2-hop collection cost explodes extraction).

    `return_hub_w` also returns each node's normalized hub weight (the
    latent attachment propensity) — the link replicas expose it as a
    feature channel, because the REALIZED degree of most nodes is dominated
    by the constant ring degree, which hides the propensity the positive
    endpoints are actually biased by (see link_features)."""
    i = np.arange(n, dtype=np.int64)
    local = [np.stack([i, (i + d) % n], 1) for d in range(1, local_k + 1)]
    pairs = np.concatenate(local, 0)
    m_hub = int(n * hub_deg / 2)
    hub_w = np.zeros(n)
    if m_hub:
        w = (np.arange(n, dtype=np.float64) + 1.0) ** (-hub_alpha)
        w = np.minimum(w / w.sum(), max_hub_w)
        w /= w.sum()
        perm = rng.permutation(n)
        hub_w[perm] = w
        src = rng.randint(0, n, size=m_hub)
        dst = perm[rng.choice(n, size=m_hub, p=w)]
        keep = src != dst
        pairs = np.concatenate([pairs, np.stack([src[keep], dst[keep]], 1)], 0)
    lo = np.minimum(pairs[:, 0], pairs[:, 1])
    hi = np.maximum(pairs[:, 0], pairs[:, 1])
    uniq = np.unique(lo * n + hi)
    out = np.stack([uniq // n, uniq % n], 1)
    return (out, hub_w) if return_hub_w else out


def assort_hub_pairs(n: int, hub_deg: float, hub_alpha: float,
                     labels: np.ndarray, assort: float,
                     rng: np.random.RandomState, max_hub_w: float = 0.02):
    """Hub pairs whose dst is, with probability `assort`, a random SAME-CLASS
    node instead of the zipf-permuted draw. Small multi-class graphs (fold:
    1,200 nodes, 29 classes -> ~41-node blocks) need this: a 2-hop
    neighborhood spans ~half such a graph, so with uniform hub wiring the
    no-self-loop aggregation averages over ~all classes and the center's
    class signal washes out (measured 0.345 test acc ~= chance vs the 0.578
    target before this fix); class-assortative hubs keep neighborhoods
    class-informative at 2-hop scale, like real PPI homophily."""
    m_hub = int(n * hub_deg / 2)
    if not m_hub:
        return np.zeros((0, 2), dtype=np.int64)
    w = (np.arange(n, dtype=np.float64) + 1.0) ** (-hub_alpha)
    w = np.minimum(w / w.sum(), max_hub_w)
    w /= w.sum()
    perm = rng.permutation(n)
    src = rng.randint(0, n, size=m_hub)
    dst = perm[rng.choice(n, size=m_hub, p=w)]
    # same-class replacement draw, vectorized over classes
    order = np.argsort(labels, kind="stable")
    starts = np.searchsorted(labels[order], np.arange(labels.max() + 1))
    counts = np.diff(np.append(starts, n))
    cls = labels[src]
    same = order[starts[cls] + (rng.rand(m_hub) * counts[cls]).astype(np.int64)]
    dst = np.where(rng.rand(m_hub) < assort, same, dst)
    keep = src != dst
    return np.stack([src[keep], dst[keep]], 1)


def block_labels(n: int, num_classes: int, noise: float,
                 rng: np.random.RandomState) -> np.ndarray:
    """Contiguous ring blocks => homophilous classes; `noise` fraction of
    nodes flipped to a random class (difficulty knob)."""
    y = (np.arange(n) * num_classes // n).astype(np.int64)
    flip = rng.rand(n) < noise
    y[flip] = rng.randint(0, num_classes, size=int(flip.sum()))
    return y


def class_features(y: np.ndarray, feat_dim: int, signal: float,
                   centers: np.ndarray, rng) -> np.ndarray:
    return (centers[y] * signal
            + rng.randn(len(y), feat_dim)).astype(np.float32)


def shared_subspace_centers(classes: int, feat_dim: int, rank: float,
                            rng) -> np.ndarray:
    """Class centers drawn from a SHARED rank-`rank` subspace (unit-variance
    entries). With isotropic full-rank centers, a model trained on the
    train-label split amplifies only the train-center span, and UNSEEN
    val/test class centers lose most of their energy under it — measured:
    train-class acc 0.455 while val held at chance 0.334 on the arxiv
    replica. Real features (e.g. arxiv's abstract embeddings) put all
    classes in one informative subspace, which is what makes Disjoint
    meta-learning transfer; rank-sharing reproduces that.

    A FRACTIONAL rank r0 + f draws ceil(r) directions with the last one's
    coefficient scaled by f — the one-step-transfer number moves ~0.07 per
    integer rank (make_arxiv note), so the fraction is the fine knob when
    the target falls between integers."""
    r0 = int(rank)
    frac = float(rank) - r0
    r = r0 + (1 if frac > 0 else 0)
    U = rng.randn(r, feat_dim).astype(np.float32) / np.sqrt(max(rank, 1.0))
    coef = rng.randn(classes, r).astype(np.float32)
    if frac > 0:
        coef[:, -1] *= frac
    return coef @ U


def smooth_field(n: int, feat_dim: int, win: int,
                 rng: np.random.RandomState) -> np.ndarray:
    """Ring-smooth random field: white noise moving-averaged over `win`
    positions, so neighbors share features (what GCN aggregation denoises)."""
    x = rng.randn(n + win, feat_dim)
    c = np.cumsum(x, axis=0)
    out = (c[win:] - c[:-win]) / np.sqrt(win)
    return out[:n].astype(np.float32)


# ---- recipes ----------------------------------------------------------------

def make_arxiv(out: str, seed=0, noise=0.65, signal=0.27, rank=6.5):
    # signal=0.27 chosen by TRAIN-IN-THE-LOOP calibration (round 4, same
    # method as fold_ppi): full-preset training at signal=0.15 plateaued at
    # 0.374/0.387 vs the 0.421 reference; production-driver probes
    # measured 0.18->0.393, 0.22->0.406, 0.27->0.429/0.423 (parity_cal/).
    # rank chosen in round 5 after the fold recalibration showed the
    # shared-subspace rank is the ONE-STEP-TRANSFER lever (the reference
    # prints accs[1] as "Test acc"): at rank=16 the full run scored
    # ref-style 0.373 / final 0.434 vs the reference's 0.421 / 0.436 —
    # final in band but the one-step number 0.05 low. Probes: rank 6 ->
    # 0.457 flat, rank 10 -> 0.406, rank 16 -> ~0.37. Full runs: rank 7
    # -> ref-style 0.386 / final 0.449; rank 6.5 (fractional, last
    # direction at half coefficient) -> 0.385 / 0.4349 — final-step now
    # matches the reference's 0.436 to 0.001 while ref-style saturates
    # ~0.385 across 6.5-7 (run-to-run variance dominates the residual
    # -0.036; the knob's integer steps move it ~0.07).
    n, feat_dim, classes = 169_343, 128, 40
    rng = np.random.RandomState(seed)
    # ogbn-arxiv: 1.17M undirected edges (avg deg ~13.7), heavy hub tail
    pairs = ring_hub_pairs(n, local_k=5, hub_deg=3.6, hub_alpha=0.85, rng=rng)
    g = CSRGraph.from_edges(pairs[:, 0], pairs[:, 1], n,
                            make_bidirectional=True)
    y = block_labels(n, classes, noise=noise, rng=rng)
    centers = shared_subspace_centers(classes, feat_dim, rank, rng)
    x = class_features(y, feat_dim, signal=signal, centers=centers, rng=rng)
    prepare_node_disjoint(out, [g], [x], [y], num_label_set=8, seed=seed)
    return dict(nodes=n, edges=g.num_edges, classes=classes)


def fold_graph(n, classes, local_k, hub_deg, hub_alpha, noise, assort, rng):
    """One fold-PPI-style graph: ring blocks + class-assortative hubs."""
    y = block_labels(n, classes, noise=noise, rng=rng)
    i = np.arange(n, dtype=np.int64)
    local = [np.stack([i, (i + d) % n], 1) for d in range(1, local_k + 1)]
    hubs = assort_hub_pairs(n, hub_deg, hub_alpha, y, assort, rng)
    pairs = np.concatenate(local + [hubs], 0)
    lo = np.minimum(pairs[:, 0], pairs[:, 1])
    hi = np.maximum(pairs[:, 0], pairs[:, 1])
    uniq = np.unique(lo * n + hi)
    return np.stack([uniq // n, uniq % n], 1), y


def make_fold_ppi(out: str, seed=1, noise=0.35, signal=0.42, assort=0.7,
                  rank=3, private=0.0):
    # Knobs set by TRAIN-IN-THE-LOOP calibration against BOTH reference
    # numbers read correctly (round 5; round 4 had calibrated final-step to
    # 0.578, which is the reference's accs[1] — see the `private` note
    # below). Full-preset production-driver sweeps (parity_cal/,
    # logs round 5): homophily is the level lever (noise 0.50->0.35 +
    # assort 0.5->0.7 moved final 0.61->0.73) and the shared-subspace RANK
    # is the one-step-transfer lever — rank=3 makes meta-training cover
    # the whole class subspace, lifting accs[1] 0.517->0.575 and
    # flattening the finetune curve (rank 4: 0.496; rank 6: 0.517; rank
    # 12: 0.354). At (noise .35, assort .7, rank 3, signal .42):
    # ref-style 0.575 vs reference 0.578, final-step 0.687 vs 0.656 —
    # and the val curve now DECLINES from epoch 1 (0.709..0.682) like a
    # genuine early-stop structure.
    #
    # `private` adds a per-class FULL-RANK center component on top of the
    # shared rank-`rank` subspace — probed (round 5) as a candidate
    # mechanism for the reference's early-stopped(0.656) > final(0.578)
    # gap and MEASURED REJECTED: full-preset runs at private=0.3/0.6/1.0
    # scored 0.485/0.418/0.438 (vs 0.549 at 0.0) with val still RISING
    # every epoch (parity_cal/fold_sweep.json). The rejection exposed a
    # protocol misread: the reference's own fold val accs rise to the last
    # epoch too (test.ipynb cell 2: 0.478..0.543), so its 0.578-vs-0.656
    # gap is NOT model selection — "Test acc" prints accs[1] (ONE finetune
    # step, train.py:137) while "Early Stopped Test acc" prints the
    # contaminated-list accs[-1] (step 20, train.py:146). The right
    # calibration target is therefore ref_style(accs[1])~=0.578 AND
    # final-step~=0.656, not final-step~=0.578 (round 4 calibrated to the
    # latter, landing the whole curve ~0.12 low).
    n_graphs, n, feat_dim, classes = 144, 1_200, 512, 29
    rng = np.random.RandomState(seed)
    graphs, feats, labels = [], [], []
    centers = shared_subspace_centers(classes, feat_dim, rank, rng)
    if private:
        centers = (centers
                   + private * rng.randn(classes, feat_dim).astype(np.float32))
    for _ in range(n_graphs):
        pairs, y = fold_graph(n, classes, local_k=4, hub_deg=4.0,
                              hub_alpha=0.8, noise=noise, assort=assort,
                              rng=rng)
        graphs.append(CSRGraph.from_edges(pairs[:, 0], pairs[:, 1], n,
                                          make_bidirectional=True))
        labels.append(y)
        feats.append(class_features(y, feat_dim, signal=signal,
                                    centers=centers, rng=rng))
    prepare_node_disjoint(out, graphs, feats, labels, num_label_set=6,
                          seed=seed)
    return dict(graphs=n_graphs, nodes=n_graphs * n, classes=classes)


def make_tissue_ppi(out: str, seed=2, n_tasks=10, spike_dim=2,
                    spike=3.0, feat_noise=0.6):
    n_graphs, n, feat_dim = 24, 4_000, 50
    rng = np.random.RandomState(seed)
    graphs, feats, bases = [], [], []
    for _ in range(n_graphs):
        pairs = ring_hub_pairs(n, local_k=10, hub_deg=8.0, hub_alpha=0.75,
                               rng=rng)
        graphs.append(CSRGraph.from_edges(pairs[:, 0], pairs[:, 1], n,
                                          make_bidirectional=True))
        # Spiked covariance: the first `spike_dim` field dims carry `spike`x
        # the variance, and task directions live in that subspace — without
        # the spike the other 44 isotropic dims dominate the k_spt=3
        # prototype noise and cap accuracy near chance regardless of
        # feat_noise (measured in calibrate_replicas sweeps).
        base = smooth_field(n, feat_dim, win=24, rng=rng)
        base[:, :spike_dim] *= spike
        bases.append(base)
        feats.append((base + feat_noise * rng.randn(n, feat_dim))
                     .astype(np.float32))
    # task t = binary threshold of a random direction in the SPIKED subspace
    # of the smooth base field: consistent across graphs, recoverable from
    # denoised features
    task_labels = []
    for _t in range(n_tasks):
        w = np.zeros(feat_dim)
        w[:spike_dim] = rng.randn(spike_dim)
        w /= np.linalg.norm(w)
        task_labels.append([(b @ w > 0).astype(np.int64) for b in bases])
    prepare_node_shared_tasks(out, graphs, feats, task_labels,
                              val_graph=22, test_graph=23)
    return dict(graphs=n_graphs, nodes=n_graphs * n, tasks=n_tasks)


def ring_actz_pairs(n: int, local_k: int, hub_deg: float, beta: float,
                    z_win: int, rng: np.random.RandomState,
                    max_hub_w: float = 0.02):
    """Link-replica graph: ring-local pairs plus n*hub_deg/2 ACTIVITY-
    ASSORTATIVE hub pairs — BOTH endpoints drawn proportional to
    exp(beta * z) where z is a ring-smooth latent activity field (smoothed
    over z_win positions). Returns (pairs, z).

    Why this shape: the prototype head is linear in logit space
    (meta.py:56-79; scripts/calibrate_replicas.py), so the only signal it
    can exploit is a FEATURE-MEAN difference between positive and negative
    pairs — here, positive hub edges' endpoints have high activity while
    uniformly-sampled negatives don't (the high-activity/high-degree
    protein mechanism of the real PPI link datasets). And because the
    reference GCN adds NO self-loop (learner.py:38-45), a center's own
    feature is diluted out of its embedding — z must be SMOOTH along the
    ring so the center's activity survives aggregation via its neighbors.
    exp(beta*z) is lognormal -> heavy-tailed hub degrees (capped at
    max_hub_w mass), which keeps 2-hop union neighborhoods cap-hitting."""
    z = smooth_field(n, 1, z_win, rng)[:, 0]
    z = (z - z.mean()) / max(z.std(), 1e-9)
    i = np.arange(n, dtype=np.int64)
    local = [np.stack([i, (i + d) % n], 1) for d in range(1, local_k + 1)]
    pairs = np.concatenate(local, 0)
    m_hub = int(n * hub_deg / 2)
    if m_hub:
        w = np.exp(beta * z)
        w = np.minimum(w / w.sum(), max_hub_w)
        w /= w.sum()
        src = rng.choice(n, size=m_hub, p=w)
        dst = rng.choice(n, size=m_hub, p=w)
        keep = src != dst
        pairs = np.concatenate([pairs, np.stack([src[keep], dst[keep]], 1)], 0)
    lo = np.minimum(pairs[:, 0], pairs[:, 1])
    hi = np.maximum(pairs[:, 0], pairs[:, 1])
    uniq = np.unique(lo * n + hi)
    return np.stack([uniq // n, uniq % n], 1), z


def link_features(n: int, deg: np.ndarray, z: np.ndarray,
                  feature_kind: str, rng,
                  noise: float = 0.3) -> np.ndarray:
    """Node features for the link replicas: the activity field z (the
    mean-separating link signal, see ring_actz_pairs) plus `noise`, with
    degree/positional summary channels in the 5-dim FirstMM layout."""
    mean_deg = max(deg.mean(), 1.0)
    if feature_kind == "degree":
        # ToL ships a single scalar feature
        return (z + noise * rng.randn(n))[:, None].astype(np.float32)
    # FirstMM's 5 features are mesh/point-cloud summaries; the stand-in is
    # structural summaries (activity + degree channel + positional).
    i = np.arange(n)
    return np.stack([
        z + noise * rng.randn(n),
        np.log1p(deg) / np.log1p(mean_deg),
        np.sin(2 * np.pi * i / n),
        np.cos(2 * np.pi * i / n),
        noise * rng.randn(n),
    ], axis=1).astype(np.float32)


def _link_recipe(out: str, n_graphs: int, n: int, feat_dim: int,
                 local_k: int, hub_deg: float, seed: int,
                 feature_kind: str, noise: float = 0.3,
                 beta: float = 2.0, z_win: int = 16):
    rng = np.random.RandomState(seed)
    pos_edges, num_nodes, feats = [], [], []
    for _ in range(n_graphs):
        pairs, z = ring_actz_pairs(n, local_k=local_k, hub_deg=hub_deg,
                                   beta=beta, z_win=z_win, rng=rng)
        pos_edges.append(pairs)
        num_nodes.append(n)
        deg = np.zeros(n)
        np.add.at(deg, pairs[:, 0], 1.0)
        np.add.at(deg, pairs[:, 1], 1.0)
        feats.append(link_features(n, deg, z, feature_kind, rng,
                                   noise=noise))
    prepare_link(out, pos_edges, num_nodes, feats,
                 training_edges_fraction=0.3, val_frac=0.1, seed=seed)
    return dict(graphs=n_graphs, nodes=n_graphs * n,
                pos_edges=sum(len(p) for p in pos_edges))


def make_firstmm_db(out: str, seed=3):
    # FirstMM-DB: 41 object graphs, ~1.4k nodes, sparse (3D meshes), 5-dim.
    # beta=3.5 chosen by TRAIN-IN-THE-LOOP calibration (round 5,
    # scripts/calibrate_link.py): full-preset production-driver sweeps
    # measured noise has NO effect (0.30/0.22/0.15 -> 0.735/0.736/0.737 —
    # aggregation already denoises the activity channel) and beta is
    # non-monotone with a peak at 3.5 (2.5->0.735, 3.0->0.742, 3.5->0.747,
    # 4.0->0.744, 4.5->0.731; parity_cal/firstmm_db_*). The residual ~0.02
    # gap to the 0.769 reference is structural: degree-proportional
    # negative sampling (the reference's own spec, link_process.py:50-64)
    # draws negative endpoints from the same activity tail the positives
    # come from, bounding pos/neg mean separation — measured pair-LDA
    # overlap 0.55-0.60 across the whole knob grid.
    return _link_recipe(out, n_graphs=41, n=1_350, feat_dim=5,
                        local_k=1, hub_deg=4.0, seed=seed,
                        feature_kind="structural", noise=0.3,
                        beta=3.5, z_win=32)


def make_tree_of_life(out: str, seed=4, n_graphs=1_840):
    # ToL: 1,840 species PPI networks, ~2.9k nodes each, 1-dim feature;
    # fewer graphs give a replica of ToL's per-graph shape (chip_smoke.py)
    return _link_recipe(out, n_graphs=n_graphs, n=2_900, feat_dim=1,
                        local_k=3, hub_deg=7.5, seed=seed,
                        feature_kind="degree", noise=0.4,
                        beta=2.5, z_win=32)


RECIPES = {
    "arxiv": make_arxiv,
    "tissue_ppi": make_tissue_ppi,
    "fold_ppi": make_fold_ppi,
    "firstmm_db": make_firstmm_db,
    "tree_of_life": make_tree_of_life,
}


def main(argv=None):
    ap = argparse.ArgumentParser("gmeta_tpu_torch.data.replicas")
    ap.add_argument("recipes", nargs="*", choices=list(RECIPES) + [[]])
    ap.add_argument("--out", default="replicas")
    args = ap.parse_args(argv)
    for r in (args.recipes or list(RECIPES)):
        t0 = time.time()
        out = os.path.join(args.out, r)
        stats = RECIPES[r](out)
        print(f"{r}: {stats} -> {out} [{time.time() - t0:.1f}s]", flush=True)


if __name__ == "__main__":
    main()
