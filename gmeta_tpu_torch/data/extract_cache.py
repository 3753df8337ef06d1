"""On-disk subgraph-extraction cache.

Counterpart of gmeta_tpu/data/extract_cache.py, with the same file names
and .npz layout, so each package reads a cache the other wrote. (The JAX
package also adopts caches it wrote under an older, mtime-based key; the
port never wrote one, and leaves that migration to the JAX package.)

Extraction is fully deterministic for the NATIVE engine: its cap-sampling
RNG is content-derived per subgraph name (csrc/extract.cpp), so results are
independent of extraction order and a partial cache composes with fresh
extractions bit-exactly. (The numpy fallback consumes ONE sequential RNG
stream across calls — a partial cache would shift the stream for the
misses — so the disk cache is only wired for the native engine.)

Format: one .npz of flattened arrays + offsets next to the dataset, keyed
by the extraction parameters and the graphs file's CONTENT identity
(size + sampled-bytes hash — NOT mtime, which a fresh clone/checkout
resets, permanently orphaning every cache), so a regenerated dataset
invalidates automatically while a copied one keeps its cache.
"""

from __future__ import annotations

import glob
import hashlib
import os
from typing import Dict

import numpy as np

from gmeta_tpu_torch.data.extract import Subgraph


def graphs_identity(path: str) -> str:
    """Content fingerprint of the graphs file: size + blake2b over the
    first/middle/last 4 MB. Sampling keeps it O(ms) on large files while
    still catching any regenerated dataset — npz members are stored with
    per-array headers, so a changed graph moves bytes everywhere."""
    st = os.stat(path)
    hsh = hashlib.blake2b(digest_size=8)
    chunk = 4 << 20
    with open(path, "rb") as f:
        for off in {0, max(st.st_size // 2 - chunk // 2, 0),
                    max(st.st_size - chunk, 0)}:
            f.seek(off)
            hsh.update(f.read(chunk))
    return f"{st.st_size}_{hsh.hexdigest()}"


def cache_path(data_dir: str, h: int, sample_nodes: int,
               cap_strategy: str) -> str:
    g = os.path.join(data_dir, "graphs.npz")
    prefix = f".extract_cache_h{h}_n{sample_nodes}_{cap_strategy}"
    try:
        ident = graphs_identity(g)
    except OSError:
        ident = "nograph"
    return os.path.join(data_dir, f"{prefix}_{ident}.npz")


def stale_paths(data_dir: str, current: str) -> list:
    """Caches for the SAME (h, sample_nodes, cap_strategy) parameterization
    as `current` but a different dataset identity — i.e. superseded by a
    regenerated dataset. Other parameterizations' caches are still valid
    and must survive (two configs alternating on one dataset dir would
    otherwise thrash each other's caches)."""
    prefix = os.path.basename(current).rsplit("_", 2)[0]
    return [p for p in glob.glob(
        os.path.join(data_dir, f"{prefix}_*.npz")) if p != current]


def save(path: str, cache: Dict[str, Subgraph]) -> None:
    """Write the cache through a temporary name of this process, then
    rename it into place."""
    if not cache:
        return
    names = sorted(cache)
    subs = [cache[n] for n in names]
    n_nodes = np.array([len(s.parents) for s in subs], np.int64)
    n_edges = np.array([len(s.edge_src) for s in subs], np.int64)
    n_centers = np.array([len(s.centers) for s in subs], np.int64)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f,
                 names=np.array(names),
                 n_nodes=n_nodes, n_edges=n_edges, n_centers=n_centers,
                 parents=np.concatenate([s.parents for s in subs]),
                 centers=np.concatenate([s.centers for s in subs]),
                 edge_src=np.concatenate([s.edge_src for s in subs]),
                 edge_dst=np.concatenate([s.edge_dst for s in subs]))
    os.replace(tmp, path)


def load(path: str) -> Dict[str, Subgraph]:
    """Reconstructs the cache as slices (views) of the flat arrays —
    no per-subgraph copies."""
    z = np.load(path, allow_pickle=False)
    names = z["names"]
    node_off = np.zeros(len(names) + 1, np.int64)
    np.cumsum(z["n_nodes"], out=node_off[1:])
    edge_off = np.zeros(len(names) + 1, np.int64)
    np.cumsum(z["n_edges"], out=edge_off[1:])
    cen_off = np.zeros(len(names) + 1, np.int64)
    np.cumsum(z["n_centers"], out=cen_off[1:])
    parents, centers = z["parents"], z["centers"]
    src, dst = z["edge_src"], z["edge_dst"]
    out: Dict[str, Subgraph] = {}
    for i, nm in enumerate(names):
        out[str(nm)] = Subgraph(
            parents=parents[node_off[i]:node_off[i + 1]],
            centers=centers[cen_off[i]:cen_off[i + 1]],
            edge_src=src[edge_off[i]:edge_off[i + 1]],
            edge_dst=dst[edge_off[i]:edge_off[i + 1]])
    return out
