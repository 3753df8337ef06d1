"""The aggregation crossover at the five runs of record's bucket shapes:
which of the port's aggregation paths is fastest where.

Counterpart of scripts/bench_kernels.py. For each recipe's support and
query buckets (B bins x P slots, E edge slots per task, from
parity/<recipe>.json), at H = the width the layer aggregates (the spt
bucket at min(feat, hidden), the qry bucket at hidden; models/gcn.py
aggregates the narrow side first), over S = tasks x B bins (`--tasks`,
default the preset's task_num: one launch of the port's meta-step covers
that many tasks; `--tasks 1` is the JAX script's shape), it times:

  dense    `densify` (the once-per-step precompute), then
           `aggregate_dense` (torch.bmm; bf16 inputs are multiplied in
           float32, as models/gcn.py runs them) forward, and its
           transpose as autograd runs it in the backward, torch.bmm(A^T,
           g) on float32 operands; plus torch.bmm on bf16 operands (the
           tensor cores), which the port does not run
  sized    `sized_graph` (the precompute: two CSR sorts), then the port's
           `csr_gather_kernel` (ops/sized_spmm.py `launch`) forward and
           transposed, float32 and bf16
  segment  `ops/spmm.aggregate` (gather, index_add_), float32, forward
  ell      `aggregate_ell` over `build_ell` slabs (row_cap 16; its host
           build timed on the host clock), float32, forward

Each time is the median of single launches between CUDA events
(`cardtime.cuda_ms`); each card time also has its back-to-back twin
(`cuda_ms_b2b`: 20 launches between one event pair), which shows where a
single launch is the host's launch time rather than the card's work.
Each row carries its bound (`cardtime.gather_bound`, `dense_bound`).
Every path's output is held against the plain gather (`sized_plain`) at
the dtype's tolerance: the synthetic bucket is built so that all four
compute the same function (`synth_bucket`).

    python -m gmeta_tpu_torch.scripts.bench_kernels [--tasks N] [--iters 20]
        [--recipes arxiv ...] [--device cpu] [--out PATH] [--global-b-ab]
        [--crossover]

The dense precompute is also timed in the form that scattered every pad
edge into one cell (`densify_serial`, `dense_*_pre_serial`), and held
bitwise against `densify`.

`main_path_bf16` then times the packed kernel at each bucket as a bf16 run
of the preset launches it (every layer at H = hidden but a layer 1 that
aggregates first, which runs float32 at H = feat): both directions,
single launches and back to back, beside its bound at bf16's 2 bytes,
torch.sparse.mm on the same CSR in bf16 (or torch's refusal), torch.bmm
on a prebuilt bf16 A, and the launches a meta-step makes there
(`launches_per_meta_step`).

`--global-b-ab` only times the dense arxiv query aggregation at the
record's B against the mean per-task need (25 bins), and merges that
into the existing output.

`--crossover` runs the sweep behind data/pipeline.py `agg_for` instead
(default output measure_torch/bench_crossover.json): P in SWEEP_P, H in
SWEEP_H, float32 and bf16, SWEEP_EDGES real edges per slot at the bin
fills of SWEEP_FILLS, over SWEEP_BINS bins. At each point it times one
meta-step's aggregation work of one layer on each path (`step_ms`: the
precompute of both sets and the calls `calls_per_meta_step` counts), and
reads off, per (dtype, P, H, fill), the edges per slot where the two
paths cost the same (`crossover`; `crossover_table` turns it into
data/pipeline.py's `CARD_CROSSOVER`).
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np
import torch

from gmeta_tpu_torch.config import PRESETS
from gmeta_tpu_torch.ops import sized_spmm as sp
from gmeta_tpu_torch.ops.spmm import (aggregate, aggregate_dense,
                                      aggregate_ell, build_ell, densify)
from gmeta_tpu_torch.scripts.common import (OUT_DIR, ROOT, finish, fmt,
                                            parser, start)
from gmeta_tpu_torch.utils import cardtime
from gmeta_tpu_torch.utils.metrics import counted

# (feat, hidden) per recipe preset (config.py PRESETS + replica feature
# widths): the spt bucket is timed at the layer-1 aggregated width
# min(feat, hidden), the qry bucket at hidden.
FEAT_HID = {
    "arxiv": (128, 256),
    "tissue_ppi": (50, 128),
    "fold_ppi": (512, 128),
    "firstmm_db": (5, 128),
    "tree_of_life": (1, 256),
}

# Buckets for a recipe without a run of record (the JAX script's
# synthetic shapes); all five have records.
FALLBACK = {
    "arxiv":      dict(spt=(1024, 9, 18432), qry=(1024, 72, 129024),
                       fill=0.93),
    "tissue_ppi": dict(spt=(1024, 6, 49152), qry=(1024, 20, 149504),
                       fill=0.90),
    "fold_ppi":   dict(spt=(1024, 9, 18432), qry=(1024, 61, 114688),
                       fill=0.90),
    "firstmm_db": dict(spt=(128, 4, 2048), qry=(128, 7, 2048), fill=0.75),
    "tree_of_life": dict(spt=(128, 14, 4096), qry=(256, 7, 4096),
                         fill=0.60),
}

TOLS = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (8e-3, 8e-3)}
DTYPES = (("f32", torch.float32), ("bf16", torch.bfloat16))

# The crossover sweep (--crossover)
SWEEP_P = (512, 1024)
SWEEP_H = (1, 5, 50, 128, 256)        # every preset's aggregated widths
SWEEP_EDGES = (1, 2, 4, 8, 16, 32, 64, 128, 256)  # real edges per slot
SWEEP_FILLS = (0.5, 0.8)
SWEEP_BINS = 128     # S of a call: one meta-step's tasks x B at the records
SWEEP_PADS = 0.5     # pad edge slots per real edge (E rounds a set up)
SWEEP_STEP = 10      # update_step of four of the five presets


def densify_serial(edge_src, edge_dst, edge_mask, S, P, dtype=torch.float32):
    """`densify` as it scattered before: `index_put_` with accumulate, every
    pad edge adding its 0 into the one cell its clamped endpoints name. On
    a CUDA tensor those adds run one after another. The yardstick of
    `dense_*_pre_serial`; the same adjacency as `densify`."""
    lead = edge_dst.shape[:-1]
    n_lead = math.prod(lead)
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


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether two float32 or bf16 tensors are equal bit for bit."""
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.view(as_int[a.dtype]), b.view(as_int[b.dtype])))


def calls_per_set(update_step: int, track_curve: bool = True) -> dict:
    """The aggregation calls of one GraphConv layer in one first-order
    meta-step (meta/maml.py `make_inner_loop`), per set: {"spt": {"fwd",
    "T"}, "qry": {...}}, for a layer whose input takes a gradient (a layer
    1 that aggregates first makes only the forwards). With the curve (the
    Trainer's default) the support set runs a forward at step 0 and at
    each of the K steps, a transpose for each inner gradient and one for
    the meta-gradient; the query set a forward at step 0 and after each
    step, and the meta-gradient's transpose. Without it (the bench) the
    support set's step-0 forward goes and the query set runs one
    forward."""
    K = update_step
    return {"spt": {"fwd": K + int(track_curve), "T": K + 1},
            "qry": {"fwd": K + 1 if track_curve else 1, "T": 1}}


def calls_per_meta_step(update_step: int, track_curve: bool = True) -> dict:
    """One layer's aggregation work in one meta-step, both sets together:
    one precompute per set, and the forward and transposed calls of
    `calls_per_set`."""
    sets = calls_per_set(update_step, track_curve).values()
    return {"pre": 2, **{k: sum(s[k] for s in sets) for k in ("fwd", "T")}}


def launches_per_meta_step(update_step: int, feat: int, hidden: int,
                           gcn_layers: int = 2,
                           track_curve: bool = True) -> dict:
    """The packed kernel's launches in one first-order meta-step of a bf16
    run, per set ("spt", "qry"): {"<dtype> <H>": {"fwd": n, "T": n}}: each
    GraphConv layer makes its set's `calls_per_set`, the transposes only
    where its input takes a gradient. Layer 1 aggregates first where feat
    <= hidden (models/gcn.py): its input, the gathered features, is
    float32 in every run (`gather_features`) and takes no gradient, so it
    makes float32 forwards at H = feat; where feat > hidden it projects
    first and aggregates at H = hidden in bf16, both ways, as every later
    layer does."""
    layers = [("float32", feat, False) if feat <= hidden
              else ("bfloat16", hidden, True)]
    layers += [("bfloat16", hidden, True)] * (gcn_layers - 1)
    out = {}
    for s, calls in calls_per_set(update_step, track_curve).items():
        by = out[s] = {}
        for dtype, H, grad in layers:
            n = by.setdefault(f"{dtype} {H}", {"fwd": 0, "T": 0})
            n["fwd"] += calls["fwd"]
            n["T"] += calls["T"] if grad else 0
    return out


def load_shapes(parity_dir=None) -> dict:
    """Bucket shapes of the runs of record (<parity_dir>/<recipe>.json,
    default parity/): each run's P, B, E and mean bin fill, and the
    widths of FEAT_HID; the JAX script's dict."""
    parity_dir = str(parity_dir or ROOT / "parity")
    shapes = {}
    for recipe, (feat, hid) in FEAT_HID.items():
        p = os.path.join(parity_dir, f"{recipe}.json")
        if os.path.exists(p):
            with open(p) as f:
                rec = json.load(f)
            b = rec["buckets"]
            shapes[recipe] = dict(
                spt=(b["P_spt"], b["B_spt"], b["E_spt"]),
                qry=(b["P_qry"], b["B_qry"], b["E_qry"]),
                H=(min(feat, hid), hid),
                fill=float(rec.get("mean_bin_fill", 0.7)),
                source="parity")
        else:
            shapes[recipe] = dict(FALLBACK[recipe], H=(min(feat, hid), hid),
                                  source="fallback")
    return shapes


def synth_bucket(P, B, E, H, fill, rng, avg_deg=10, with_A=True):
    """One packed bucket: B bins with ~fill*P live rows, up to E edges
    uniform over each bin's live slots, h random; the JAX script's draws,
    bitwise. Returns (A or None, h, sizes, src, dst, mask).

    Two entries differ from the JAX script's, so that the dense path and
    the edge paths compute one function: A counts a duplicate edge as
    often as the edge list holds it (np.add.at; `A[b, d, s] += 1.0` adds
    it once), and the mask zeroes the pad edges by position, the last
    `pad` entries after the stable sort (masking every dst == B*P - 1 also
    drops the real edges into the last slot)."""
    sizes = np.clip((rng.normal(fill, 0.1, B) * P).astype(int), 16, P)
    A = np.zeros((B, P, P), np.float32) if with_A else None
    srcs, dsts = [], []
    per_bin = max(E // B, 1)
    for b in range(B):
        n = sizes[b]
        m = min(per_bin, n * avg_deg)
        s = rng.randint(0, n, m)
        d = rng.randint(0, n, m)
        if A is not None:
            np.add.at(A[b], (d, s), 1.0)
        srcs.append(b * P + s)
        dsts.append(b * P + d)
    src = np.concatenate(srcs)[:E]
    dst = np.concatenate(dsts)[:E]
    pad = E - len(src)
    if pad:
        src = np.concatenate([src, np.zeros(pad, np.int64)])
        dst = np.concatenate([dst, np.full(pad, B * P - 1, np.int64)])
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    mask = np.ones(E, np.float32)
    mask[E - pad:] = 0.0          # the pads sort last: stable, dst = B*P-1
    h = rng.randn(B, P, H).astype(np.float32)
    return A, h, sizes.astype(np.int32), src.astype(np.int32), \
        dst.astype(np.int32), mask


class Timer:
    """Times callables on one device: the single-launch median, and on
    CUDA its back-to-back twin."""

    def __init__(self, device, iters):
        self.device, self.iters = device, iters
        self.cuda = device.type == "cuda"

    def ms(self, fn):
        return cardtime.device_ms(fn, self.device, self.iters)

    def b2b(self, fn):
        return cardtime.cuda_ms_b2b(fn) if self.cuda else None

    def both(self, row, key, fn):
        row[key] = self.ms(fn)
        row[key + "_b2b"] = self.b2b(fn)


def _err(got, want, dtype, what):
    """Max abs error of got against want, raising past the dtype's
    tolerance."""
    rtol, atol = TOLS[dtype]
    got, want = got.float(), want.float()
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")
    return (got - want).abs().max().item()


def bench_bucket(P, B, E, H, fill, tasks, rng, device, timer) -> dict:
    """Every path at one bucket of `tasks` tasks; ms per layer call."""
    S = tasks * B
    V = S * P
    _, h, _, src, dst, mask = synth_bucket(P, S, tasks * E, H, fill, rng,
                                           with_A=False)
    live = mask > 0
    row = dict(P=P, B=B, E=E, H=H, tasks=tasks, S=S, nnz=int(live.sum()))
    src_d, dst_d, mask_d = (torch.from_numpy(a).to(device)
                            for a in (src, dst, mask))
    errs = {}
    for tag, dtype in DTYPES:
        x = torch.from_numpy(h).to(device, dtype)
        itemsize = x.element_size()
        graph = sp.sized_graph(src_d, dst_d, mask_d, S, P)
        plain = {d: sp.sized_plain(*graph.csr(d), x) for d in ("fwd", "bwd")}

        # sized: the precompute, then the kernel both ways
        row[f"sized_{tag}_pre"] = timer.ms(
            lambda: sp.sized_graph(src_d, dst_d, mask_d, S, P))
        for d, key in (("fwd", "fwd"), ("bwd", "T")):
            errs[f"sized_{tag}_{key}"] = _err(sp.launch(d, graph, x),
                                              plain[d], dtype,
                                              f"sized {tag} {d}")
            timer.both(row, f"sized_{tag}_{key}",
                       lambda d=d: sp.launch(d, graph, x))
            row_ptr, col = graph.csr(d)
            nnz = int(row_ptr[-1])
            read = int(torch.unique(col[:nnz]).numel())
            ms, by, _ = cardtime.gather_bound(nnz, H, read, V, itemsize)
            row[f"sized_{tag}_{key}_bound"] = ms
            row[f"sized_{tag}_{key}_bound_by"] = by

        # dense: densify, then torch.bmm both ways
        A = densify(src_d, dst_d, mask_d, S, P, dtype=dtype)
        if not same_bits(A, densify_serial(src_d, dst_d, mask_d, S, P,
                                           dtype=dtype)):
            raise AssertionError(f"densify {tag}: not densify_serial's")
        row[f"dense_{tag}_pre"] = timer.ms(
            lambda: densify(src_d, dst_d, mask_d, S, P, dtype=dtype))
        row[f"dense_{tag}_pre_serial"] = timer.ms(
            lambda: densify_serial(src_d, dst_d, mask_d, S, P, dtype=dtype))
        errs[f"dense_{tag}_fwd"] = _err(aggregate_dense(A, x), plain["fwd"],
                                        dtype, f"dense {tag} fwd")
        timer.both(row, f"dense_{tag}_fwd", lambda: aggregate_dense(A, x))
        A32, g32 = A.float(), x.float()       # autograd's saved operands
        errs[f"dense_{tag}_T"] = _err(torch.bmm(A32.mT, g32), plain["bwd"],
                                      dtype, f"dense {tag} T")
        timer.both(row, f"dense_{tag}_T", lambda: torch.bmm(A32.mT, g32))
        del A32, g32
        ms, by, _ = cardtime.dense_bound(S, P, H, dtype)
        row[f"dense_{tag}_bound"], row[f"dense_{tag}_bound_by"] = ms, by
        if dtype == torch.bfloat16:
            errs["bmm_bf16_fwd"] = _err(torch.bmm(A, x), plain["fwd"],
                                        dtype, "bmm bf16")
            timer.both(row, "bmm_bf16_fwd", lambda: torch.bmm(A, x))
        if dtype == torch.float32:
            # segment and ell, float32 forward, as the JAX script
            hf, want = x.view(V, H), plain["fwd"].view(V, H)
            errs["segment_f32_fwd"] = _err(
                aggregate(hf, src_d, dst_d, mask_d, V), want, dtype,
                "segment")
            timer.both(row, "segment_f32_fwd",
                       lambda: aggregate(hf, src_d, dst_d, mask_d, V))
            t0 = time.perf_counter()
            nbr, emask, row_id = build_ell(src[live], dst[live], V,
                                           row_cap=16)
            row["ell_build_host_ms"] = 1e3 * (time.perf_counter() - t0)
            nbr, emask, row_id = (torch.from_numpy(a).to(device)
                                  for a in (nbr, emask, row_id))
            errs["ell_f32_fwd"] = _err(
                aggregate_ell(hf, nbr, emask, row_id, V), want, dtype, "ell")
            timer.both(row, "ell_f32_fwd",
                       lambda: aggregate_ell(hf, nbr, emask, row_id, V))
            del nbr, emask, row_id
        del A, graph, plain, x
        if device.type == "cuda":
            torch.cuda.empty_cache()
    row["max_abs_err"] = errs
    for tag, _ in DTYPES:
        paths = {p: row[f"{p}_{tag}_fwd"] for p in ("dense", "sized")}
        if tag == "f32":
            paths.update(segment=row["segment_f32_fwd"],
                         ell=row["ell_f32_fwd"])
        row[f"winner_{tag}_fwd"] = min(paths, key=paths.get)
        # one precompute and one layer call each way: the least weight the
        # precompute can carry in a step
        row[f"sized_over_dense_{tag}"] = (
            sum(row[f"sized_{tag}_{k}"] for k in ("pre", "fwd", "T"))
            / sum(row[f"dense_{tag}_{k}"] for k in ("pre", "fwd", "T")))
    return row


def main_path_bf16(shapes, tasks_of, rng, device, timer) -> dict:
    """The packed kernel at each record bucket as a bf16 run launches it,
    H = the preset's hidden width, both directions: single launches and
    back to back, its bound (`gather_bound` at itemsize 2), torch.sparse.mm
    on the same CSR in bf16 (its time and max abs error against the plain
    gather, or torch's refusal in `sparse_*_refused`), torch.bmm on a
    prebuilt bf16 A (A^T for the transpose), and the launches per
    meta-step at the preset's update_step (`launches_per_meta_step`). The
    kernel and torch.bmm are held against `sized_plain` at bf16's
    tolerance."""
    bf16, rows = torch.bfloat16, {}
    for recipe, cfg in shapes.items():
        feat, hid = FEAT_HID[recipe]
        tasks = tasks_of(recipe)
        launches = launches_per_meta_step(PRESETS[recipe].update_step, feat,
                                          hid, PRESETS[recipe].h)
        for which in ("spt", "qry"):
            P, B, E = cfg[which]
            S = tasks * B
            _, h, _, src, dst, mask = synth_bucket(P, S, tasks * E, hid,
                                                   cfg["fill"], rng,
                                                   with_A=False)
            e = [torch.from_numpy(a).to(device) for a in (src, dst, mask)]
            x = torch.from_numpy(h).to(device, bf16)
            xf = x.view(S * P, hid)
            graph = sp.sized_graph(*e, S, P)
            A = densify(*e, S, P, dtype=bf16)
            row = dict(P=P, B=B, E=E, H=hid, tasks=tasks, S=S,
                       launches_per_meta_step=launches[which])
            for d, key, At in (("fwd", "fwd", A), ("bwd", "T", A.mT)):
                row_ptr, col = graph.csr(d)
                nnz = int(row_ptr[-1])
                want = sp.sized_plain(row_ptr, col, x)
                _err(sp.launch(d, graph, x), want, bf16, f"{recipe} {d}")
                timer.both(row, f"sized_{key}",
                           lambda d=d: sp.launch(d, graph, x))
                read = int(torch.unique(col[:nnz]).numel())
                row[f"bound_{key}"], row[f"bound_by_{key}"], _ = \
                    cardtime.gather_bound(nnz, hid, read, S * P, 2)
                _err(torch.bmm(At, x), want, bf16, f"{recipe} bmm {d}")
                timer.both(row, f"bmm_{key}", lambda At=At: torch.bmm(At, x))
                sparse = torch.sparse_csr_tensor(
                    row_ptr, col[:nnz], torch.ones(nnz, dtype=bf16,
                                                   device=device),
                    size=(S * P, S * P), check_invariants=False)
                try:
                    got = torch.sparse.mm(sparse, xf)
                except RuntimeError as err:      # a yardstick torch refuses
                    row[f"sparse_{key}"] = row[f"sparse_{key}_b2b"] = None
                    row[f"sparse_{key}_refused"] = str(err).splitlines()[0]
                else:
                    row[f"sparse_{key}_err"] = (
                        got.float() - want.view(S * P, hid).float()
                    ).abs().max().item()
                    timer.both(row, f"sparse_{key}",
                               lambda s=sparse: torch.sparse.mm(s, xf))
                del sparse, want
            rows[f"{recipe}.{which}"] = row
            print(f"# main path bf16 {recipe}.{which}: H={hid} S={S} "
                  f"kernel fwd {fmt(row['sized_fwd'], 4)} T "
                  f"{fmt(row['sized_T'], 4)} ms", file=sys.stderr,
                  flush=True)
            del A, graph, x, xf, e
            if device.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def main_path_table(rows) -> list:
    lines = ["| bucket | S | H | dir | kernel ms | b2b | bound | share "
             "(b2b) | launches / meta-step | sparse.mm bf16 | bmm bf16 |",
             "|---" * 11 + "|"]
    for key, r in rows.items():
        n = r["launches_per_meta_step"].get(f"bfloat16 {r['H']}", {})
        for d in ("fwd", "T"):
            ms, b2b, bound = r[f"sized_{d}"], r[f"sized_{d}_b2b"], \
                r[f"bound_{d}"]
            share = f"{100 * bound / ms:.0f}%" + (
                f" ({100 * bound / b2b:.0f}%)" if b2b else "")
            sparse = r[f"sparse_{d}"]
            lines.append(
                f"| {key} | {r['S']} | {r['H']} | {d} | {fmt(ms, 4)} | "
                f"{fmt(b2b, 4)} | {fmt(bound, 4)} | {share} | "
                f"{n.get(d, 0)} | {fmt(sparse, 4) if sparse else 'refused'}"
                f" | {fmt(r[f'bmm_{d}'], 4)} |")
    return lines


def global_b_ab(shapes, tasks, rng, device, timer) -> dict:
    """The dense arxiv query aggregation at the record's B against the
    measured mean per-task need (25 bins, PACKING.md §3): the ceiling
    that any compaction of bins could reclaim from the dense path."""
    P, B_global, E = shapes["arxiv"]["qry"]
    H = shapes["arxiv"]["H"][1]
    fill = shapes["arxiv"]["fill"]
    B_mean = 25
    out = {"P": P, "H": H, "tasks": tasks, "B_global": B_global,
           "B_mean_need": B_mean}
    for tag, B in (("global", B_global), ("mean_need", B_mean)):
        S = tasks * B
        _, h, _, src, dst, mask = synth_bucket(P, S, tasks * E, H, fill,
                                               rng, with_A=False)
        A = densify(*(torch.from_numpy(a).to(device)
                      for a in (src, dst, mask)), S, P)
        x = torch.from_numpy(h).to(device)
        out[f"dense_f32_{tag}_ms"] = timer.ms(lambda: aggregate_dense(A, x))
        del A, x
    out["speedup_ceiling"] = (out["dense_f32_global_ms"]
                              / out["dense_f32_mean_need_ms"])
    return out


def sweep_edges(P, S, per_slot, fill, rng):
    """Packed edge lists of S bins of P slots: live sizes ~ N(fill, 0.05) P,
    `per_slot` x S x P real edges uniform over each bin's live square (so
    `per_slot` real edges per slot, pad slots included), dst
    nondecreasing, then SWEEP_PADS pad edges per real edge (src 0, dst
    S*P-1, mask 0). Returns (src, dst, mask) int32 / float32."""
    sizes = np.clip((rng.normal(fill, 0.05, S) * P).astype(int), 1, P)
    n = per_slot * S * P
    bins = rng.randint(0, S, n)
    src = bins * P + (rng.random_sample(n) * sizes[bins]).astype(np.int64)
    dst = bins * P + (rng.random_sample(n) * sizes[bins]).astype(np.int64)
    order = np.argsort(dst, kind="stable")
    pad = int(SWEEP_PADS * n)
    src = np.concatenate([src[order], np.zeros(pad, np.int64)])
    dst = np.concatenate([dst[order], np.full(pad, S * P - 1)])
    mask = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
    return src.astype(np.int32), dst.astype(np.int32), mask


def crossing(points):
    """The edges per slot where sized's step time meets dense's, from
    (edges per slot, sized / dense) points in rising edges: interpolated in
    log-log between the last point where sized is faster and the next;
    None where one path is faster at every point (`above` or `below`
    says which)."""
    for (e0, r0), (e1, r1) in zip(points, points[1:]):
        if r0 < 1.0 <= r1:
            t = math.log(r0) / (math.log(r0) - math.log(r1))
            return math.exp(math.log(e0) + t * (math.log(e1) - math.log(e0)))
    return None


def crossover_sweep(device, timer, rng) -> dict:
    """The sweep of `--crossover` over the SWEEP_* grid: per point the ms
    of each call, and
    `step_ms` of each path: one meta-step's precompute and calls of one
    layer (`calls_per_meta_step`). The dense side is `densify` and
    `aggregate_dense` (bf16 operands multiplied in float32, as the port
    runs them) with the transpose as autograd runs it; the sized side
    `sized_graph` and the kernel both ways. Each point's forward is held
    against the other path's at the dtype's tolerance."""
    P_list, H_list, fills, S = SWEEP_P, SWEEP_H, SWEEP_FILLS, SWEEP_BINS
    calls = calls_per_meta_step(SWEEP_STEP)
    rows = []
    for P in P_list:
        for fill in fills:
            for per_slot in SWEEP_EDGES:
                src, dst, mask = (torch.from_numpy(a).to(device) for a in
                                  sweep_edges(P, S, per_slot, fill, rng))
                nnz = int(mask.sum().item())
                print(f"# crossover P={P} fill={fill} edges/slot "
                      f"{per_slot}: {nnz} real of {mask.numel()}",
                      file=sys.stderr, flush=True)
                for tag, dtype in DTYPES:
                    row = dict(P=P, fill=fill, edges_per_slot=per_slot,
                               S=S, nnz=nnz, E=int(mask.numel()), dtype=tag)
                    row["dense_pre"] = timer.ms(
                        lambda: densify(src, dst, mask, S, P, dtype=dtype))
                    row["sized_pre"] = timer.ms(
                        lambda: sp.sized_graph(src, dst, mask, S, P))
                    A = densify(src, dst, mask, S, P, dtype=dtype)
                    graph = sp.sized_graph(src, dst, mask, S, P)
                    A32 = A.float()
                    by_H = {}
                    for H in H_list:
                        x = torch.randn(S, P, H, device=device).to(dtype)
                        _err(sp.launch("fwd", graph, x),
                             aggregate_dense(A, x), dtype,
                             f"P={P} H={H} {tag} sized vs dense")
                        r = {"dense_fwd": timer.ms(
                                 lambda: aggregate_dense(A, x)),
                             "dense_T": timer.ms(
                                 lambda: torch.bmm(A32.mT, x.float())),
                             "sized_fwd": timer.ms(
                                 lambda: sp.launch("fwd", graph, x)),
                             "sized_T": timer.ms(
                                 lambda: sp.launch("bwd", graph, x))}
                        for p in ("dense", "sized"):
                            r[f"{p}_step_ms"] = (
                                calls["pre"] * row[f"{p}_pre"]
                                + calls["fwd"] * r[f"{p}_fwd"]
                                + calls["T"] * r[f"{p}_T"])
                        r["sized_over_dense"] = (r["sized_step_ms"]
                                                 / r["dense_step_ms"])
                        by_H[str(H)] = r
                        del x
                    row["by_H"] = by_H
                    rows.append(row)
                    del A, A32, graph
                    if device.type == "cuda":
                        torch.cuda.empty_cache()
    crossover = {}
    for tag, _ in DTYPES:
        for P in P_list:
            for H in H_list:
                for fill in fills:
                    pts = [(r["edges_per_slot"],
                            r["by_H"][str(H)]["sized_over_dense"])
                           for r in rows if (r["dtype"], r["P"], r["fill"])
                           == (tag, P, fill)]
                    e = crossing(pts)
                    side = None if e is not None else (
                        "sized" if pts[-1][1] < 1.0 else "dense")
                    crossover[f"{tag} P={P} H={H} fill={fill}"] = {
                        "edges_per_slot": e, "faster_everywhere": side}
    return {"calls": calls, "update_step": SWEEP_STEP, "bins": S,
            "pads_per_real_edge": SWEEP_PADS, "rows": rows,
            "crossover": crossover}


def crossover_table(sweep) -> dict:
    """data/pipeline.py `CARD_CROSSOVER` from a sweep: per dtype ("float32",
    "bfloat16"), P and H the lower of the fills' crossings, or where sized
    was faster at every point the sweep's largest edges per slot, the edge
    of the measurement."""
    names = {"f32": "float32", "bf16": "bfloat16"}
    edge = max(r["edges_per_slot"] for r in sweep["rows"])
    table = {}
    for key, c in sweep["crossover"].items():
        tag, P, H, _ = key.split(" ")
        e = c["edges_per_slot"]
        if e is None:
            e = edge if c["faster_everywhere"] == "sized" else 0.0
        e, H = round(e, 1), int(H[2:])
        by_H = table.setdefault(names[tag], {}).setdefault(int(P[2:]), {})
        by_H[H] = min(e, by_H.get(H, e))
    return table


def sweep_table(sweep) -> list:
    lines = ["| dtype | P | H | fill | " + " | ".join(
        f"{e}/slot" for e in sorted({r["edges_per_slot"]
                                     for r in sweep["rows"]}))
             + " | crossover |"]
    lines.append("|---" * (len(lines[0].split("|")) - 2) + "|")
    for key, c in sweep["crossover"].items():
        tag, P, H, fill = key.split(" ")
        P, H, fill = int(P[2:]), H[2:], float(fill[5:])
        ratios = [fmt(r["by_H"][H]["sized_over_dense"])
                  for r in sweep["rows"]
                  if (r["dtype"], r["P"], r["fill"]) == (tag, P, fill)]
        cross = (fmt(c["edges_per_slot"], 1) if c["edges_per_slot"]
                 else f"{c['faster_everywhere']} everywhere")
        lines.append(f"| {tag} | {P} | {H} | {fill} | "
                     + " | ".join(ratios) + f" | {cross} |")
    return lines


def table(results) -> list:
    lines = ["| bucket | S | H | dtype | dense pre | dense fwd | dense T |"
             " sized pre | sized fwd | sized T | sized bound fwd |"
             " bmm bf16 | segment | ell | fastest fwd |"
             " sized/dense (pre+fwd+T) |",
             "|---" * 16 + "|"]
    for key, r in results["buckets"].items():
        for tag, _ in DTYPES:
            cells = [key, str(r["S"]), str(r["H"]), tag]
            cells += [fmt(r[f"{p}_{tag}_{k}"]) for p in ("dense", "sized")
                      for k in ("pre", "fwd", "T")]
            cells += [fmt(r[f"sized_{tag}_fwd_bound"], 4),
                      fmt(r.get("bmm_bf16_fwd") if tag == "bf16" else None),
                      fmt(r.get(f"segment_{tag}_fwd")),
                      fmt(r.get(f"ell_{tag}_fwd")),
                      r[f"winner_{tag}_fwd"],
                      fmt(r[f"sized_over_dense_{tag}"])]
            lines.append("| " + " | ".join(cells) + " |")
    return lines


def main(argv=None):
    ap = parser("bench_kernels", __doc__)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--tasks", type=int, default=None,
                    help="tasks per bucket (default: the preset's "
                         "task_num)")
    ap.add_argument("--recipes", nargs="*", default=list(FEAT_HID),
                    choices=list(FEAT_HID))
    ap.add_argument("--parity_dir", default=None,
                    help="where the runs of record lie (default parity/)")
    ap.add_argument("--global-b-ab", action="store_true")
    ap.add_argument("--crossover", action="store_true")
    args = ap.parse_args(argv)
    device, head = start(args.device)
    timer = Timer(device, args.iters)
    rng = np.random.RandomState(0)

    if args.crossover:
        out = args.out
        if out == ap.get_default("out"):
            out = str(OUT_DIR / "bench_crossover.json")
        with counted() as c:
            sweep = crossover_sweep(device, timer, rng)
        sweep.update(head, unit="ms", iters=args.iters,
                     launches=c.of(sp.LAUNCHES))
        return finish(sweep, out, sweep_table(sweep))
    shapes = load_shapes(args.parity_dir)
    launched = counted()

    if args.global_b_ab:
        ab = global_b_ab(shapes, args.tasks or PRESETS["arxiv"].task_num,
                         rng, device, timer)
        existing = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                existing = json.load(f)
        existing["global_b_ab"] = dict(ab, **head)
        return finish(existing, args.out,
                      [json.dumps({"metric": "global_b_ab", **ab})])

    results = dict(head, unit="ms per layer call", iters=args.iters,
                   timing="median of single launches between CUDA events "
                          "(*_b2b: 20 launches back to back)"
                   if device.type == "cuda" else "host clock (CPU)",
                   buckets={})
    for recipe in args.recipes:
        cfg = shapes[recipe]
        tasks = args.tasks or PRESETS[recipe].task_num
        for which, H in (("spt", cfg["H"][0]), ("qry", cfg["H"][1])):
            P, B, E = cfg[which]
            key = f"{recipe}.{which}"
            print(f"# {key}: P={P} B={B} E={E} H={H} tasks={tasks} "
                  f"[{cfg['source']}]", file=sys.stderr, flush=True)
            results["buckets"][key] = dict(
                fill=cfg["fill"], source=cfg["source"],
                **bench_bucket(P, B, E, H, cfg["fill"], tasks, rng, device,
                               timer))
    results["main_path_bf16"] = main_path_bf16(
        {r: shapes[r] for r in args.recipes},
        lambda r: args.tasks or PRESETS[r].task_num, rng, device, timer)
    results["launches"] = launched.of(sp.LAUNCHES)
    if device.type == "cuda" and not all(results["launches"].values()):
        raise RuntimeError(f"the sized kernel did not launch both ways: "
                           f"{results['launches']}")
    return finish(results, args.out, table(results)
                  + main_path_table(results["main_path_bf16"]))


if __name__ == "__main__":
    main()
