#!/usr/bin/env python3
"""Time design variants of the aggregation kernel's two bodies on one NVIDIA
GPU.

    python3 sweep_sized_spmm.py [packed|full]     (both when no argument)
    python3 sweep_sized_spmm.py combine [PARENT]

packed: the packed sets' body (csr_gather_kernel). Each variant is
gmeta_tpu_torch/csrc/sized_spmm.cu with some of its constants replaced
(blocks per SM in the launch bounds, threads per block, the store),
compiled by nvcc with the port's flags into build/sweep_sized_spmm/ and
loaded with ctypes. All run the forward CSR of chip_smoke.py's arxiv query
batch (its data and seed), float32 and bf16, H = 128 and 256. Each is
checked against the plain version, then timed as the median of 30 launches
(CUDA events) beside the bytes bound that chip_smoke.py phase 5 computes.

full: the rectangular entry point `csr_gather` on the two full-graph CSRs
of chip_smoke.py phase 10: the edge engine's CSR pair of the arxiv-scale
graph (uniform endpoints, rows of about 28 edges) and a power-law CSR of
the same V and nnz (`powerlaw_edges`), both directions, float32, H = 128
and 256. Variants: the row-wise body (`rowwise_gather`, what csr_gather
ran before its full-graph body), the committed full-graph body at slab
widths S in {32, 64, 128, H} and split thresholds T in {64, 128, 256,
1024, 4096}
(runtime arguments, no rebuild), and variants of that body's constants
(SLAB_VARIANTS, each built like the packed variants) at S in {32, 64},
T = the committed `CHUNK`. Each is checked against `csr_plain`, then timed
as the median of 30 launches beside the bytes bound of chip_smoke.py
`gather_bound`.

combine: the combine kernel alone (`csr_combine_kernel`, through its C
entry gmeta_csr_combine) on the split rows of two power-law CSRs:
chip_smoke.py phase 10's (`powerlaw_edges` at V 170,112 and nnz
4,759,966: 3,782 split rows, 17,910 chunks) at H = 128 and 256, and that
of `gmeta_tpu_torch/scripts/bench_edges.py 23` (V 2^23, 7 edges a node:
31,117 split rows) at H = 128, each into float32 and bf16 rows, from
normal float32 partial sums. Variants (COMBINE_VARIANTS: the heavy-row
threshold and bands, the heavy rows' tile), and where PARENT names
another checkout, its sized_spmm.cu's combine first and last ("parent",
"parent, again"), so parent and change run in turns in one process.
Each is held bitwise against `combine_plain` on the CPU (chunk order),
then timed: the median of single launches and of 20 launches back to
back (`cardtime.cuda_ms`, `cuda_ms_b2b`, both with the host's launch
time in them), and the kernel's own device time per launch from
torch.profiler, beside one `index_add_` of the partials per row and
`cardtime.combine_bound`. JSON to build/sweep_sized_spmm/combine.json.

Prints one line per variant, then the card's name and power limit.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from chip_smoke import (HBM_BYTES_S, arxiv_data, card_line, cuda_ms,
                        gather_bound, powerlaw_edges, rowwise_gather)

VARIANTS = {
    "committed": [],
    "no min blocks": [
        ("__launch_bounds__(THREADS, MIN_BLOCKS)",
         "__launch_bounds__(THREADS)")],
    "128 threads": [("constexpr int THREADS = 256;",
                     "constexpr int THREADS = 128;")],
    "plain float32 store": [
        ("__stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], "
         "v[3]));",
         "*reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], "
         "v[3]);")],
    "committed, again": [],
}


# variants of the full-graph body (csr_slab_kernel)
SLAB_VARIANTS = {
    "committed": [],
    "8 blocks per SM (32 registers)": [
        ("constexpr int SLAB_MIN_BLOCKS = 4;",
         "constexpr int SLAB_MIN_BLOCKS = 8;")],
    "edges one at a time": [
        ("#pragma unroll 4\n    for (int e = a; e < b; ++e) {",
         "#pragma unroll 1\n    for (int e = a; e < b; ++e) {")],
    "edges unrolled by 8": [
        ("#pragma unroll 4\n    for (int e = a; e < b; ++e) {",
         "#pragma unroll 8\n    for (int e = a; e < b; ++e) {")],
    "edges unrolled by 2": [
        ("#pragma unroll 4\n    for (int e = a; e < b; ++e) {",
         "#pragma unroll 2\n    for (int e = a; e < b; ++e) {")],
    "3 blocks per SM": [
        ("constexpr int SLAB_MIN_BLOCKS = 4;",
         "constexpr int SLAB_MIN_BLOCKS = 3;")],
    "one vector per lane": [
        ("constexpr int slab_cpl() { return cpl<VEC>(); }",
         "constexpr int slab_cpl() { return 1; }")],
}


# variants of the combine kernel (csr_combine_kernel)
BAND = "constexpr int HEAVY_BAND = 8;"
HEAVY = "constexpr int HEAVY_CHUNKS = 128;"
COMBINE_VARIANTS = {
    "committed": [],
    "no heavy rows (lanes only)": [(HEAVY,
                                    "constexpr int HEAVY_CHUNKS = 1 << 30;")],
    "heavy rows whole (bands of 256)": [(BAND,
                                         "constexpr int HEAVY_BAND = 256;")],
    "heavy bands of 4 vectors": [(BAND, "constexpr int HEAVY_BAND = 4;")],
    "heavy bands of 16 vectors": [(BAND, "constexpr int HEAVY_BAND = 16;")],
    "heavy above 64 chunks": [(HEAVY, "constexpr int HEAVY_CHUNKS = 64;")],
    "16 KB tile": [("constexpr int COMBINE_TILE = 8192;",
                    "constexpr int COMBINE_TILE = 4096;")],
    "committed, again": [],
}


def build(index, subs, prefix="v", source=None):
    """The variant's library and its ptxas register counts: `source`
    (default this checkout's csrc/sized_spmm.cu) with `subs` applied."""
    from gmeta_tpu_torch.ops import cuda_build
    text = Path(source or cuda_build.CSRC / "sized_spmm.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant {index}: {old!r} not in the source")
        text = text.replace(old, new)
    out = Path(__file__).resolve().parent / "build" / "sweep_sized_spmm"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"{prefix}{index}.cu", out / f"{prefix}{index}.so"
    cu.write_text(text)
    r = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(so), str(cu)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {index}:\n{r.stderr}")
    regs = [line.split("Used ")[1].split(" registers")[0]
            for line in (r.stdout + r.stderr).splitlines() if "Used " in line]
    lib = ctypes.CDLL(str(so))
    fn = lib.gmeta_sized_spmm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, regs, lib


def sweep_packed():
    import torch
    from gmeta_tpu_torch.config import PRESETS
    from gmeta_tpu_torch.meta.maml import batch_to
    from gmeta_tpu_torch.models.gcn import precompute
    from gmeta_tpu_torch.ops import sized_spmm as sp

    device = torch.device("cuda", 0)
    _, ds = arxiv_data()
    batch = next(ds["train"].batches(PRESETS["arxiv"].task_num,
                                     shuffle=False))
    qry = batch_to(batch, device).qry
    graph = precompute(qry, agg="sized").sized
    T, B, P = qry.node_gid.shape
    S, N = T * B, T * B * P
    nnz = int(graph.row_ptr[-1])
    read_rows = torch.unique(graph.col[:nnz]).numel()
    print(f"S={S} P={P} nnz={nnz}, x rows read {read_rows}", flush=True)
    g = torch.Generator(device=device).manual_seed(0)
    xs = {(H, dt): torch.randn(S, P, H, device=device, generator=g).to(dt)
          for dt in (torch.float32, torch.bfloat16) for H in (128, 256)}
    codes = {torch.float32: 0, torch.bfloat16: 1}
    stream = torch.cuda.current_stream().cuda_stream
    for index, (name, subs) in enumerate(VARIANTS.items()):
        fn, regs, _ = build(index, subs)
        cells = []
        for (H, dt), x in xs.items():
            out = torch.empty_like(x)

            def run():
                err = fn(graph.row_ptr.data_ptr(), graph.col.data_ptr(),
                         x.data_ptr(), out.data_ptr(), N, H, 1, codes[dt],
                         stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")
            run()
            want = sp.sized_plain(graph.row_ptr, graph.col, x)
            tol = (1e-5, 1e-4) if dt == torch.float32 else (8e-3, 8e-3)
            torch.testing.assert_close(out.float(), want.float(),
                                       rtol=tol[0], atol=tol[1])
            ms = cuda_ms(run, iters=30)
            nbytes = x.element_size() * (read_rows + N) * H \
                + 4.0 * (N + 1 + nnz)
            share = 100 * nbytes / HBM_BYTES_S / (ms * 1e-3)
            cells.append(f"{str(dt)[6:]} H={H} {ms:.3f} ms ({share:.1f}%)")
        print(f"{name}: registers {'/'.join(regs)}; " + "; ".join(cells),
              flush=True)


def full_graph_pairs(device):
    """The two full-graph CSR pairs of chip_smoke.py phase 10: the edge
    engine's local pair of the arxiv-scale graph (world of one), and a
    power-law pair of the same V and nnz."""
    from gmeta_tpu_torch.data.graph import synthetic_store
    from gmeta_tpu_torch.ops.sized_spmm import csr_pair
    from gmeta_tpu_torch.parallel.edgepart import (_live_pair,
                                                   build_overlap_plan,
                                                   shard_graph)
    from gmeta_tpu_torch.run.edgepart import union_graph
    store, _ = synthetic_store(1, 170_000, 28, 128, 15, seed=7)
    sg = shard_graph(union_graph(store), 1)
    plan = build_overlap_plan(sg, 1)
    uniform = _live_pair(plan.local_src[0], plan.local_dst[0],
                         plan.local_mask[0], sg.Vb, sg.Vb)
    V, nnz = sg.Vb, uniform.col.numel()
    return {"uniform": uniform.to(device),
            "powerlaw": csr_pair(*powerlaw_edges(V, nnz), V, V).to(device)}


def slab_runner(lib):
    """gather(row_ptr, col, x, split, S) through a library's full-graph
    body and combine kernel, as `csr_gather` launches them."""
    import torch
    body, combine = lib.gmeta_csr_slab, lib.gmeta_csr_combine
    body.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    combine.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    body.restype = combine.restype = ctypes.c_int

    def gather(row_ptr, col, x, split, S):
        n, H = row_ptr.numel() - 1, x.shape[1]
        out = torch.empty((n, H), device=x.device)
        partial = torch.empty((split.chunk_row.numel(), H), device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = body(row_ptr.data_ptr(), col.data_ptr(), x.data_ptr(),
                   out.data_ptr(), partial.data_ptr(),
                   split.chunk_row.data_ptr(), split.chunk_start.data_ptr(),
                   n, split.chunk_row.numel(), H, 0, S, split.chunk, stream)
        if not err and split.rows.numel():
            err = combine(split.rows.data_ptr(), split.chunk_ptr.data_ptr(),
                          partial.data_ptr(), out.data_ptr(),
                          split.rows.numel(), H, 0, stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
        return out
    return gather


def sweep_full():
    import torch
    from gmeta_tpu_torch.ops import sized_spmm as sp
    device = torch.device("cuda", 0)
    g = torch.Generator(device=device).manual_seed(1)
    l2 = sp.l2_bytes(0)
    with ThreadPoolExecutor(len(SLAB_VARIANTS)) as pool:   # nvcc at once
        built = list(pool.map(lambda kv: build(kv[0], kv[1][1], "s"),
                              enumerate(SLAB_VARIANTS.items())))
    variants = {}
    for name, (_, regs, lib) in zip(SLAB_VARIANTS, built):
        variants[name] = slab_runner(lib)
        print(f"{name}: registers {'/'.join(regs)}", flush=True)
    for name, pair in full_graph_pairs(device).items():
        nnz = pair.col.numel()
        for count, row_ptr, col, n_in in (
                ("fwd", pair.row_ptr, pair.col, pair.row_ptr_t.numel() - 1),
                ("bwd", pair.row_ptr_t, pair.col_t, pair.row_ptr.numel() - 1)):
            n_out = row_ptr.numel() - 1
            read_rows = torch.unique(col).numel()
            longest = int((row_ptr[1:] - row_ptr[:-1]).max())
            splits = {T: sp.row_split(row_ptr, T)
                      for T in (64, 128, 256, 1024, 4096)}
            for H in (128, 256):
                # small integers: every sum is exact in float32, in any
                # order, so each variant must equal the plain version
                x = torch.randint(-8, 9, (n_in, H), device=device,
                                  generator=g).float()
                want = sp.csr_plain(row_ptr, col, x)
                bound = gather_bound(nnz, H, read_rows, n_out)[0]
                cells = []

                def cell(label, fn):
                    assert torch.equal(fn(), want), (name, count, H, label)
                    ms = cuda_ms(fn, iters=30)
                    cells.append(f"{label} {ms:.3f} ms "
                                 f"({100 * bound / ms:.1f}%)")
                cell("row-wise", lambda: rowwise_gather(row_ptr, col, x))
                for vname, gather in variants.items():
                    grid = ([(S, T) for T in splits
                             for S in sorted({32, 64, 128, H})]
                            if vname == "committed" else
                            [(32, sp.CHUNK), (64, sp.CHUNK)])
                    for S, T in grid:
                        cell(f"{vname} S={S} T={T}", lambda: gather(
                            row_ptr, col, x, splits[T], S))
                print(f"{name} {count} H={H} (longest row {longest}, bound "
                      f"{bound:.4f} ms, slab_width "
                      f"{sp.slab_width(n_in, H, 4, l2)}): "
                      + "; ".join(cells), flush=True)
                del x, want


def combine_cases(device):
    """(name, RowSplit on the card, H) of the combine sweep."""
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.scripts.bench_edges import powerlaw_graph
    import numpy as np
    import torch

    def split_of(dst, V):
        row_ptr = np.zeros(V + 1, np.int64)
        np.cumsum(np.bincount(dst, minlength=V), out=row_ptr[1:])
        return sp.row_split(torch.from_numpy(row_ptr.astype(np.int32))
                            .to(device))
    _, dst = powerlaw_edges(170_112, 4_759_966)
    smoke = split_of(dst, 170_112)
    V = 1 << 23
    edges23 = split_of(powerlaw_graph(V, 7)[1], V)
    return [("chip_smoke power-law", smoke, 128),
            ("chip_smoke power-law", smoke, 256),
            ("bench_edges 23", edges23, 128)]


def kernel_device_ms(fn, name, calls=20):
    """Device milliseconds per call of fn() spent in kernels whose name
    holds `name`, from torch.profiler's records of `calls` calls (no host
    time in it, unlike the CUDA-event times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(float(getattr(e, "self_device_time_total", None)
                   or getattr(e, "self_cuda_time_total", 0))
             for e in prof.key_averages() if name in e.key)
    return us / calls / 1e3


def sweep_combine(parent):
    import torch
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.utils.cardtime import (combine_bound, cuda_ms,
                                                cuda_ms_b2b)
    device = torch.device("cuda", 0)
    # (name, substitutions, source): the parent's combine first and last
    variants = [(k, v, None) for k, v in COMBINE_VARIANTS.items()]
    if parent:
        cu = Path(parent) / "gmeta_tpu_torch/csrc/sized_spmm.cu"
        variants = [("parent", [], cu), *variants, ("parent, again", [], cu)]
    with ThreadPoolExecutor(len(variants)) as pool:   # nvcc at once
        built = list(pool.map(lambda iv: build(iv[0], iv[1][1], "c",
                                               iv[1][2]),
                              enumerate(variants)))
    combines = {}
    for (name, _, _), (_, regs, lib) in zip(variants, built):
        fn = lib.gmeta_csr_combine
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        combines[name] = fn
        print(f"{name}: registers {'/'.join(regs)}", flush=True)
    codes = {torch.float32: 0, torch.bfloat16: 1}
    results = []
    g = torch.Generator(device=device).manual_seed(0)
    for case, split, H in combine_cases(device):
        n_rows, n_chunks = split.rows.numel(), split.chunk_row.numel()
        per = (split.chunk_ptr[1:] - split.chunk_ptr[:-1]).long()
        owner = torch.repeat_interleave(torch.arange(n_rows, device=device),
                                        per)
        n_out = int(split.rows.max()) + 1
        partial = torch.randn(n_chunks, H, device=device, generator=g)
        split_cpu, partial_cpu = split.to("cpu"), partial.cpu()
        for dtype in (torch.float32, torch.bfloat16):
            sentinel = torch.full((n_out, H), 7.0, dtype=dtype, device=device)
            want = sp.combine_plain(split_cpu, partial_cpu, sentinel.cpu())
            out = sentinel.clone()
            bound, by, _ = combine_bound(n_chunks, n_rows, H,
                                         out.element_size())
            row = dict(case=case, H=H, dtype=str(dtype)[6:], rows=n_rows,
                       chunks=n_chunks, longest_row_chunks=int(per.max()),
                       bound_ms=bound, bound_by=by, variants={})

            def library():
                torch.zeros((n_rows, H), device=device).index_add_(
                    0, owner, partial)
            row["index_add_ms"] = cuda_ms(library)
            row["index_add_ms_b2b"] = cuda_ms_b2b(library)
            cells = []
            for name, fn in combines.items():
                def run():
                    err = fn(split.rows.data_ptr(),
                             split.chunk_ptr.data_ptr(), partial.data_ptr(),
                             out.data_ptr(), n_rows, H, codes[dtype],
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")
                out.copy_(sentinel)
                run()
                assert torch.equal(out.cpu(), want), (case, H, dtype, name)
                ms, b2b = cuda_ms(run, iters=30), cuda_ms_b2b(run)
                dev = kernel_device_ms(run, "csr_combine_kernel")
                row["variants"][name] = {"ms": ms, "ms_b2b": b2b,
                                         "device_ms": dev}
                cells.append(f"{name} {ms:.4f} / {b2b:.4f} / {dev:.4f} ms "
                             f"({100 * bound / ms:.1f}% / "
                             f"{100 * bound / b2b:.1f}% / "
                             f"{100 * bound / dev:.1f}%)")
            results.append(row)
            print(f"{case} H={H} {row['dtype']} ({n_rows} rows, {n_chunks} "
                  f"chunks, longest {row['longest_row_chunks']}; bound "
                  f"{bound:.4f} ms, index_add_ {row['index_add_ms']:.4f} / "
                  f"{row['index_add_ms_b2b']:.4f} ms), single / back to "
                  f"back / device: " + "; ".join(cells), flush=True)
            del sentinel, out, want
        del partial, partial_cpu
    return results


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sweep_sized_spmm: needs an NVIDIA GPU")
    from gmeta_tpu_torch.utils.device import resolve_device
    resolve_device(torch.device("cuda", 0))
    which = sys.argv[1:] or ["packed", "full"]
    if which[0] == "combine":
        out = {"card": card_line(),
               "rows": sweep_combine(which[1] if len(which) > 1 else None)}
        path = Path(__file__).resolve().parent / "build" / "sweep_sized_spmm"
        path.mkdir(parents=True, exist_ok=True)
        (path / "combine.json").write_text(json.dumps(out))
        print(out["card"])
        return
    if "packed" in which:
        sweep_packed()
    if "full" in which:
        sweep_full()
    print(card_line())


if __name__ == "__main__":
    main()
