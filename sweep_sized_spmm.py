#!/usr/bin/env python3
"""Time design variants of the size-aware aggregation kernel on one NVIDIA
GPU.

    python3 sweep_sized_spmm.py

Each variant is gmeta_tpu_torch/csrc/sized_spmm.cu with some of its
constants replaced (blocks per SM in the launch bounds, threads per
block, the store), compiled by nvcc
with the port's flags into build/sweep_sized_spmm/ and loaded with ctypes.
All run the forward CSR of chip_smoke.py's arxiv query batch (its data and
seed), float32 and bf16, H = 128 and 256. Each is checked against the plain
version, then timed as the median of 30 launches (CUDA events) beside the
bytes bound that chip_smoke.py phase 5 computes. Prints one line per
variant, then the card's name and power limit. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

from chip_smoke import HBM_BYTES_S, arxiv_data, card_line, cuda_ms

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


def build(index, subs):
    """The variant's library and its ptxas register counts."""
    from gmeta_tpu_torch.ops import cuda_build
    text = (cuda_build.CSRC / "sized_spmm.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"variant {index}: {old!r} not in the source")
        text = text.replace(old, new)
    out = Path(__file__).resolve().parent / "build" / "sweep_sized_spmm"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"v{index}.cu", out / f"v{index}.so"
    cu.write_text(text)
    r = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                        str(so), str(cu)], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {index}:\n{r.stderr}")
    regs = [line.split("Used ")[1].split(" registers")[0]
            for line in (r.stdout + r.stderr).splitlines() if "Used " in line]
    fn = ctypes.CDLL(str(so)).gmeta_sized_spmm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, regs


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("sweep_sized_spmm: needs an NVIDIA GPU")
    from gmeta_tpu_torch.config import PRESETS
    from gmeta_tpu_torch.meta.maml import batch_to
    from gmeta_tpu_torch.models.gcn import precompute
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.utils.device import resolve_device

    device = torch.device("cuda", 0)
    resolve_device(device)
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
        fn, regs = build(index, subs)
        cells = []
        for (H, dt), x in xs.items():
            out = torch.empty_like(x)

            def run():
                err = fn(graph.row_ptr.data_ptr(), graph.col.data_ptr(),
                         x.data_ptr(), out.data_ptr(), N, H, codes[dt],
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
    print(card_line())


if __name__ == "__main__":
    main()
