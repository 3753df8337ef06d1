"""Edge-partitioned full-graph GCN over the mesh's 'edge' axis.

Counterpart of gmeta_tpu/parallel/edgepart.py. Graphs whose (V, H)
activations exceed one card's memory are computed with

- nodes block-partitioned across the edge group (shard d owns rows
  [d*Vb, (d+1)*Vb)),
- edges partitioned by DESTINATION block, so every shard aggregates only
  into rows it owns,
- a halo exchange per GCN layer, then a purely local aggregation.

The host planning (`shard_graph`, `pad_features`, `build_halo_plan`,
`build_overlap_plan`) is the JAX package's, in the port's own numpy, with
bit-equal outputs. On top of it, once per graph on the host, each shard's
edge sets become CSR pairs (ops/sized_spmm.py `csr_pair`): keyed by local
destination for the forward, by source for the transpose, each with its
heavy-row plan, so the card's launches need no host sync. The aggregation
`segment_sum(table[src] * mask, dst, num_segments=Vb)` over sorted
destinations is then one `csr_gather` (the CUDA kernel on the card,
`csr_plain` on the CPU); pad edges (mask 0) are left out of the CSRs.

Two halo variants, as in the JAX package:
- `halo='all_gather'`: every shard's (Vb, H) block reaches every shard; here
  an all-reduce of the zero-padded (D*Vb, H) table, which the collectives'
  autograd rules make differentiable. Communication V*H per layer.
- `halo='boundary'`: each shard ships only the rows other shards' edges
  reference (a static per-pair plan), through one all-to-all of (D, M, H).

Semantics match models/gcn.py's GraphConv math (clamp-norm before and after,
no self-loops), with the aggregation before the projection, as the JAX
engine computes it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from gmeta_tpu_torch.data.graph import CSRGraph
from gmeta_tpu_torch.ops.sized_spmm import CsrAgg, CsrPair, csr_pair
from gmeta_tpu_torch.parallel.collectives import all_reduce_sum, all_to_all


class ShardedGraph(NamedTuple):
    """Static-shape edge shards. Shard d owns node rows
    [d*Vb, (d+1)*Vb) and all edges whose dst falls in that range."""
    edge_src: np.ndarray    # (D, Eb) int32 global src ids (pad: 0)
    edge_dst: np.ndarray    # (D, Eb) int32 LOCAL dst ids in [0, Vb) (pad: Vb-1)
    edge_mask: np.ndarray   # (D, Eb) float32
    deg: np.ndarray         # (D, Vb) float32 in-degrees of owned rows
    num_nodes: int          # true V (<= D * Vb)
    Vb: int


def shard_graph(g: CSRGraph, n_shards: int, pad_to: int = 128) -> ShardedGraph:
    """Partition a CSR graph's edges by destination block."""
    V = g.num_nodes
    Vb = -(-V // n_shards)
    Vb = ((Vb + pad_to - 1) // pad_to) * pad_to
    dst = np.repeat(np.arange(V, dtype=np.int64), np.diff(g.indptr))
    src = g.indices.astype(np.int64)
    owner = dst // Vb
    counts = np.bincount(owner, minlength=n_shards)
    Eb = ((int(counts.max()) + pad_to - 1) // pad_to) * pad_to

    e_src = np.zeros((n_shards, Eb), np.int32)
    e_dst = np.full((n_shards, Eb), Vb - 1, np.int32)
    e_mask = np.zeros((n_shards, Eb), np.float32)
    deg = np.zeros((n_shards, Vb), np.float32)
    for d in range(n_shards):
        sel = owner == d
        k = int(sel.sum())
        order = np.argsort(dst[sel], kind="stable")
        e_src[d, :k] = src[sel][order]
        e_dst[d, :k] = (dst[sel][order] - d * Vb)
        e_mask[d, :k] = 1.0
        np.add.at(deg[d], e_dst[d, :k], 1.0)
    return ShardedGraph(e_src, e_dst, e_mask, deg, V, Vb)


def pad_features(x: np.ndarray, sg: ShardedGraph, n_shards: int) -> np.ndarray:
    """(V, H) -> (D * Vb, H) zero-padded to the block partition."""
    out = np.zeros((n_shards * sg.Vb, x.shape[1]), x.dtype)
    out[:sg.num_nodes] = x
    return out


class HaloPlan(NamedTuple):
    """Static boundary-exchange plan for `halo='boundary'`.

    send_idx[p, d]: the (padded) LOCAL row indices shard p ships to shard d
    each layer; halo_src[d] remaps shard d's edge sources into the flattened
    (D * M, H) receive table (slot p*M+j = row j received from shard p).
    """
    send_idx: np.ndarray   # (D, D, M) int32 local rows p -> d (pad: 0)
    send_mask: np.ndarray  # (D, D, M) float32
    halo_src: np.ndarray   # (D, Eb) int32 into the receive table (pad: 0)
    M: int                 # padded per-pair boundary width

    @property
    def comm_rows(self) -> int:
        """Real rows shipped per layer (vs D * V for all_gather)."""
        return int(self.send_mask.sum())


def build_halo_plan(sg: ShardedGraph, n_shards: int,
                    pad_to: int = 8) -> HaloPlan:
    """Host-side: per (owner p, consumer d) boundary index sets + edge-source
    remap. Self-pairs (p == d) route through the same table so the
    aggregation has one uniform gather."""
    D, Vb = n_shards, sg.Vb
    needs: List[List[np.ndarray]] = [[None] * D for _ in range(D)]
    for d in range(D):
        k = int(sg.edge_mask[d].sum())
        srcs = sg.edge_src[d, :k].astype(np.int64)
        owners = srcs // Vb
        for p in range(D):
            needs[p][d] = np.unique(srcs[owners == p]) - p * Vb
    M = max((len(needs[p][d]) for p in range(D) for d in range(D)),
            default=0)
    M = max(((M + pad_to - 1) // pad_to) * pad_to, pad_to)

    send_idx = np.zeros((D, D, M), np.int32)
    send_mask = np.zeros((D, D, M), np.float32)
    for p in range(D):
        for d in range(D):
            n = len(needs[p][d])
            send_idx[p, d, :n] = needs[p][d]
            send_mask[p, d, :n] = 1.0

    halo_src = np.zeros((D, sg.edge_src.shape[1]), np.int32)
    for d in range(D):
        k = int(sg.edge_mask[d].sum())
        srcs = sg.edge_src[d, :k].astype(np.int64)
        owners = srcs // Vb
        pos = np.empty(k, np.int64)
        for p in range(D):
            sel = owners == p
            # position of each needed row within p's (sorted-unique) send list
            pos[sel] = p * M + np.searchsorted(needs[p][d], srcs[sel] - p * Vb)
        halo_src[d, :k] = pos
    return HaloPlan(send_idx=send_idx, send_mask=send_mask,
                    halo_src=halo_src, M=M)


class OverlapPlan(NamedTuple):
    """Static plan for halo/compute overlap: each shard's edges are split
    into LOCAL (source row owned by this shard, computable before any
    communication lands) and REMOTE (source arrives through the boundary
    all-to-all). The engine starts the all-to-all first, aggregates the
    local edges while it is in flight, then folds in the remote part.

    Shapes: local_* (D, L), remote_* (D, R); send_idx/send_mask (D, D, M)
    as in HaloPlan; remote_src indexes the flattened (D*M, H) receive table.
    """
    local_src: np.ndarray    # (D, L) int32 LOCAL row ids (pad: 0)
    local_dst: np.ndarray    # (D, L) int32 local dst, nondecreasing (pad: Vb-1)
    local_mask: np.ndarray   # (D, L) float32
    remote_src: np.ndarray   # (D, R) int32 into receive table (pad: 0)
    remote_dst: np.ndarray   # (D, R) int32 local dst, nondecreasing (pad: Vb-1)
    remote_mask: np.ndarray  # (D, R) float32
    send_idx: np.ndarray     # (D, D, M) int32 rows p ships to d (pad: 0)
    send_mask: np.ndarray    # (D, D, M) float32
    M: int

    @property
    def comm_rows(self) -> int:
        """Real boundary rows shipped per layer."""
        return int(self.send_mask.sum())

    @property
    def local_edges(self) -> int:
        return int(self.local_mask.sum())

    @property
    def remote_edges(self) -> int:
        return int(self.remote_mask.sum())


def build_overlap_plan(sg: ShardedGraph, n_shards: int,
                       pad_to: int = 8) -> OverlapPlan:
    """Host-side: split each shard's edge list by source ownership and build
    the boundary send plan (only p != d pairs ship rows; a shard's own rows
    never cross the interconnect)."""
    D, Vb = n_shards, sg.Vb
    needs: List[List[np.ndarray]] = [[np.zeros(0, np.int64)] * D
                                     for _ in range(D)]
    per_shard = []
    for d in range(D):
        k = int(sg.edge_mask[d].sum())
        srcs = sg.edge_src[d, :k].astype(np.int64)   # GLOBAL src ids
        dsts = sg.edge_dst[d, :k].astype(np.int64)   # already LOCAL dst ids
        owners = srcs // Vb
        loc = owners == d
        per_shard.append((srcs, dsts, owners, loc))
        for p in range(D):
            if p != d:
                needs[p][d] = np.unique(srcs[owners == p]) - p * Vb
    M = max((len(needs[p][d]) for p in range(D) for d in range(D)), default=0)
    M = max(((M + pad_to - 1) // pad_to) * pad_to, pad_to)
    L = max((int(loc.sum()) for _, _, _, loc in per_shard), default=0)
    R = max((int((~loc).sum()) for _, _, _, loc in per_shard), default=0)
    L = max(((L + pad_to - 1) // pad_to) * pad_to, pad_to)
    R = max(((R + pad_to - 1) // pad_to) * pad_to, pad_to)

    local_src = np.zeros((D, L), np.int32)
    local_dst = np.full((D, L), Vb - 1, np.int32)
    local_mask = np.zeros((D, L), np.float32)
    remote_src = np.zeros((D, R), np.int32)
    remote_dst = np.full((D, R), Vb - 1, np.int32)
    remote_mask = np.zeros((D, R), np.float32)
    send_idx = np.zeros((D, D, M), np.int32)
    send_mask = np.zeros((D, D, M), np.float32)
    for p in range(D):
        for d in range(D):
            n = len(needs[p][d])
            send_idx[p, d, :n] = needs[p][d]
            send_mask[p, d, :n] = 1.0
    for d in range(D):
        srcs, dsts, owners, loc = per_shard[d]
        nl = int(loc.sum())
        local_src[d, :nl] = srcs[loc] - d * Vb
        local_dst[d, :nl] = dsts[loc]
        local_mask[d, :nl] = 1.0
        rem = ~loc
        nr = int(rem.sum())
        pos = np.empty(nr, np.int64)
        r_src, r_own = srcs[rem], owners[rem]
        for p in range(D):
            sel = r_own == p
            pos[sel] = p * M + np.searchsorted(needs[p][d], r_src[sel] - p * Vb)
        remote_src[d, :nr] = pos
        remote_dst[d, :nr] = dsts[rem]
        remote_mask[d, :nr] = 1.0
    return OverlapPlan(local_src, local_dst, local_mask,
                       remote_src, remote_dst, remote_mask,
                       send_idx, send_mask, M)


# ---- one shard's operands on its device -------------------------------------

def _live_pair(src, dst, mask, n_src: int, n_dst: int) -> CsrPair:
    """The CSR pair of a padded (src, dst, mask) edge row, pads left out,
    with both directions' heavy-row plans."""
    live = np.asarray(mask) != 0
    return csr_pair(np.asarray(src)[live], np.asarray(dst)[live], n_src,
                    n_dst)


class HaloShard(NamedTuple):
    """Shard d's operands for `make_full_graph_forward`: its aggregation as
    a CSR pair into the halo table (D*Vb rows for all_gather, D*M for
    boundary), its norm (Vb, 1), and for boundary its send plan (D, M)."""
    agg: CsrPair
    norm: torch.Tensor
    send_idx: Optional[torch.Tensor] = None
    send_mask: Optional[torch.Tensor] = None

    def to(self, device) -> "HaloShard":
        return HaloShard(self.agg.to(device), self.norm.to(device),
                         *(None if t is None else t.to(device)
                           for t in (self.send_idx, self.send_mask)))


def _norm(sg: ShardedGraph, d: int) -> torch.Tensor:
    return torch.rsqrt(torch.from_numpy(sg.deg[d]).clamp(min=1.0))[:, None]


def halo_shard(sg: ShardedGraph, d: int, n_shards: int, halo: str,
               plan: Optional[HaloPlan] = None) -> HaloShard:
    """Host: shard d's operands for one halo variant (CPU tensors)."""
    if halo == "all_gather":
        agg = _live_pair(sg.edge_src[d], sg.edge_dst[d], sg.edge_mask[d],
                         n_shards * sg.Vb, sg.Vb)
        return HaloShard(agg, _norm(sg, d))
    if halo != "boundary":
        raise ValueError(f"halo must be 'all_gather' or 'boundary', got "
                         f"{halo!r}")
    agg = _live_pair(plan.halo_src[d], sg.edge_dst[d], sg.edge_mask[d],
                     n_shards * plan.M, sg.Vb)
    return HaloShard(agg, _norm(sg, d),
                     torch.from_numpy(plan.send_idx[d].astype(np.int64)),
                     torch.from_numpy(plan.send_mask[d]))


def make_full_graph_forward(layer_dims: Sequence[Tuple[int, int]], mesh,
                            n_shards: int, Vb: int, halo: str = "all_gather",
                            M: int = 0):
    """Returns forward(params, h_block, shard: HaloShard) -> (Vb, H_out),
    this rank's rows of the node embeddings; params replicated, h_block
    (Vb, H_in) the rank's rows. GraphConv math per models/gcn.py (clamp-norm
    before/after, ReLU), aggregation then projection. Every rank of the
    edge group must call it together (each layer runs a collective)."""
    if halo not in ("all_gather", "boundary"):
        raise ValueError(f"halo must be 'all_gather' or 'boundary', got "
                         f"{halo!r}")
    if halo == "boundary" and M <= 0:
        raise ValueError("the boundary halo needs the HaloPlan's M")
    group, d = mesh.edge_group, mesh.e

    def table_of(h, shard):
        if halo == "all_gather":
            if n_shards == 1:
                return h
            full = h.new_zeros((n_shards * Vb, h.shape[1]))
            full[d * Vb:(d + 1) * Vb] = h
            return all_reduce_sum(full, group)
        send = h[shard.send_idx] * shard.send_mask[..., None]   # (D, M, H)
        return all_to_all(send, group).reshape(n_shards * M, -1)

    def forward(params, h_block, shard: HaloShard):
        h = h_block
        for i, _ in enumerate(layer_dims):
            w, b = params[2 * i], params[2 * i + 1]
            h = h * shard.norm
            agg = CsrAgg.apply(shard.agg, table_of(h, shard))
            h = torch.relu((agg @ w) * shard.norm + b)
        return h

    return forward


def full_graph_embed(params, feats: np.ndarray, g: CSRGraph, mesh,
                     layer_dims, halo: str = "all_gather") -> torch.Tensor:
    """Shard, pad, run, gather, unpad: (V, H_out) node embeddings on every
    rank, on the mesh's device. Each rank moves only its own shard to its
    device; the edge group computes together (the task groups each compute
    the same)."""
    D, d, device = mesh.edge, mesh.e, mesh.device
    sg = shard_graph(g, D)
    plan = build_halo_plan(sg, D) if halo == "boundary" else None
    shard = halo_shard(sg, d, D, halo, plan).to(device)
    h0 = pad_features(np.asarray(feats, np.float32), sg, D)
    h_block = torch.from_numpy(h0[d * sg.Vb:(d + 1) * sg.Vb]).to(device)
    params = [torch.as_tensor(p).to(device) for p in params]
    fwd = make_full_graph_forward(layer_dims, mesh, D, sg.Vb, halo=halo,
                                  M=0 if plan is None else plan.M)
    with torch.no_grad():
        out = fwd(params, h_block, shard)
        full = out.new_zeros((D * sg.Vb, out.shape[1]))
        full[d * sg.Vb:(d + 1) * sg.Vb] = out
        full = all_reduce_sum(full, mesh.edge_group)
    return full[:sg.num_nodes]
