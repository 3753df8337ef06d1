"""Dense block-diagonal aggregation over packed subgraph batches.

Replacement for DGL's SpMM `update_all(copy_src, sum)` (learner.py:38-45):
out[v] = sum over edges (u -> v) of h[u]. The packing (data/pack.py) makes
the batch adjacency block-diagonal with S blocks of <= P x P, so the
adjacency is built ONCE per task by a scalar scatter of E edge weights
(`densify`), and every GCN layer, inner step and backward pass is then a
batched matrix product, `aggregate_dense`. The size-aware path
(ops/sized_spmm.py) builds no adjacency: it gathers over the edge lists.
Counterpart of gmeta_tpu/ops/spmm.py:29-54; its
segment-sum, ELL and SDDMM paths come in a later slice.
"""

from __future__ import annotations

import torch


def densify(edge_src: torch.Tensor, edge_dst: torch.Tensor,
            edge_mask: torch.Tensor, S: int, P: int,
            dtype=torch.float32) -> torch.Tensor:
    """(..., S, P, P) block-diagonal adjacency: A[s, v, u] = 1 for each edge
    (u -> v) inside block s (flat slots s*P+u, s*P+v). Leading dims of the
    (..., E) edge arrays carry over (one adjacency per task). Duplicate edges
    accumulate. Padding edges carry mask 0 and add nothing; their source
    index is clamped into range, since a pad edge (src 0, dst S*P-1) does
    not lie inside one block. Real edges never cross blocks (extraction is
    per subgraph), so src // P == dst // P for them."""
    lead = edge_dst.shape[:-1]
    n_lead = 1
    for d in lead:
        n_lead *= d
    edge_src = edge_src.reshape(n_lead, -1).long()
    edge_dst = edge_dst.reshape(n_lead, -1).long()
    sid = edge_dst // P
    dst_l = edge_dst - sid * P
    src_l = (edge_src - sid * P).clamp(0, P - 1)
    lead_id = torch.arange(n_lead, device=edge_dst.device)[:, None]
    flat = ((lead_id * S + sid) * P + dst_l) * P + src_l
    A = torch.zeros(n_lead * S * P * P, dtype=dtype, device=edge_dst.device)
    A.index_put_((flat.reshape(-1),),
                  edge_mask.reshape(-1).to(dtype), accumulate=True)
    return A.view(*lead, S, P, P)


def aggregate_dense(A: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """out[s, v] = sum_u A[s, v, u] * h[s, u] over full (P, P) blocks:
    a batched matmul, which the JAX package also leaves to its compiler.
    A: (S, P, P), h: (S, P, H). Accumulates in float32 and returns float32,
    as the reference's preferred_element_type does."""
    if A.dtype == torch.float32 and h.dtype == torch.float32:
        return torch.bmm(A, h)
    return torch.bmm(A.float(), h.float())


def degrees_from_dense(A: torch.Tensor) -> torch.Tensor:
    """(..., S, P) in-degrees — DGL `in_degrees()` (learner.py:29)."""
    return A.sum(dim=-1)
