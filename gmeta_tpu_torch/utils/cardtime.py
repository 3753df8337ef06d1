"""Timing and bounds shared by chip_smoke.py and the measurement scripts
(gmeta_tpu_torch/scripts/).

- `card_line`: the card's name and power limit, as nvidia-smi gives them.
- `cuda_ms`: the median of CUDA-event times of single launches;
  `cuda_ms_b2b`: launches back to back between one event pair, so that
  the host's launch overhead hides behind the card's work where there is
  enough of it; `host_ms`: the host clock's twin for the CPU;
  `device_ms` picks by device.
- `gather_bound`, `dense_bound`: the least time the card could take for a
  gather or a dense batched product of the given data, the larger of its
  bytes over the memory rate and its operations over the peak rate.
- `rounding_bound`: how far two sums of one CSR row, in two orders, can
  part.

- `rates_apply`: whether those rates describe a device (bench.py's `mfu`).
- `profile`: the card's busy share of one call and its device time by
  kernel, under `torch.profiler`.

The peak rates are the H100 SXM's (NVIDIA's data sheet, dense, at its
700 W limit): float32 outside the tensor cores, bf16 on the tensor cores,
and the HBM3's bandwidth. A card set below 700 W runs slower under load,
so every reading stands beside `card_line`'s power limit. TF32 stays off
on the port's paths (utils/device.py), so float32 products run at the
float32 rate.
"""

from __future__ import annotations

import statistics
import subprocess
import time

import torch

FP32_PEAK = 67e12      # H100 SXM float32 FLOP/s outside the tensor cores
BF16_PEAK = 989e12     # H100 SXM bf16 tensor-core FLOP/s, dense
HBM_BYTES_S = 3.35e12  # H100 SXM device memory
CARD = "NVIDIA H100 80GB HBM3"   # the H100 SXM's name in torch.cuda


def rates_apply(device) -> bool:
    """Whether the peak rates above are this device's: a CUDA device that
    names itself as the H100 SXM does (not the CPU, nor an H100 PCIe or
    NVL, whose peaks are lower)."""
    device = torch.device(device)
    return (device.type == "cuda"
            and torch.cuda.get_device_name(device) == CARD)


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Median milliseconds of fn() on the card, one event pair per call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms_b2b(fn, launches=20, repeats=5, warmup=3):
    """Milliseconds per call of fn() run `launches` times back to back
    between one event pair, the median over `repeats` such runs. Where
    the card's work per call exceeds the host's launch time, the queue
    stays full and this is the card's time; where it does not, this is
    the host's, and so below `cuda_ms`'s single-launch time only by what
    the card overlaps."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return statistics.median(times)


def host_ms(fn, iters=20, warmup=3):
    """Median milliseconds of fn() on the host clock (for the CPU, where
    every op has finished when it returns)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def device_ms(fn, device, iters=20, warmup=3):
    """`cuda_ms` on a CUDA device, `host_ms` elsewhere."""
    if torch.device(device).type == "cuda":
        return cuda_ms(fn, iters, warmup)
    return host_ms(fn, iters, warmup)


def sync(device):
    """Wait for the work queued on a CUDA device; nothing elsewhere."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def profile(step, top=12):
    """Device time by kernel over one call of `step()` (which returns a
    tensor on the card) under torch.profiler, and the card's busy share of
    the call's wall time (the profiler slows the host side, so the share is
    a lower bound of the unprofiled one). Returns {"wall_ms", "busy_ms",
    "busy_share", "top": [[kernel, ms], ...]}, or None where the profiler
    records no device time."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        step().cpu()
        wall_us = (time.time() - t0) * 1e6
    kernels = {}
    for e in prof.key_averages():
        if "cuda" not in str(getattr(e, "device_type", "")).lower():
            continue
        us = (getattr(e, "self_device_time_total", None)
              or getattr(e, "self_cuda_time_total", 0))
        kernels[e.key] = kernels.get(e.key, 0.0) + float(us)
    busy = sum(kernels.values())
    if busy <= 0:
        return None
    rows = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "busy_share": busy / wall_us,
            "top": [[k[:90], us / 1e3] for k, us in rows]}


def gather_bound(nnz, H, read_rows, n_out, itemsize=4):
    """The least time the card could take for a gather of this data, in ms,
    and what bounds it: the edges' 2 x nnz x H operations at the float32
    rate (the kernels add in float32 whatever they read), or the table
    rows they name and the int32 CSR read once and the whole (n_out, H)
    output written once, in elements of `itemsize` bytes, whichever is
    longer; with those bytes."""
    t_ops = 2.0 * nnz * H / FP32_PEAK
    nbytes = (itemsize * (read_rows * H + n_out * H)
              + 4.0 * (n_out + 1 + nnz))
    t_bytes = nbytes / HBM_BYTES_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", nbytes)


def combine_bound(n_chunks, n_rows, H, itemsize=4):
    """The least time the card could take for the combine of `n_rows`
    split rows from `n_chunks` float32 partial sums of H columns, in ms,
    and what bounds it: the partials read once, the rows written once in
    elements of `itemsize` bytes and the int32 row ids and chunk pointers
    read once, or one add per partial element at the float32 rate,
    whichever is longer; with the bytes."""
    nbytes = (4.0 * n_chunks * H + itemsize * n_rows * H
              + 4.0 * (2 * n_rows + 1))
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = float(n_chunks) * H / FP32_PEAK
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", nbytes)


def epilogue_bound(rows, H, direction, itemsize=4, bias_elems=0):
    """The least time the card could take for the GraphConv epilogue over
    rows x H elements of `itemsize` bytes (ops/epilogue.py), in ms, and
    what bounds it: the function's own inputs read once and its outputs
    written once. Forward, x read and out written, the one-byte mask
    written and the norm read; backward, g and the mask read, g_x
    written, the norm read and the bias's gradient (`bias_elems`
    elements) written. Or 4 operations an element at the float32 rate,
    whichever is longer; with the bytes. The backward's g_pre, which the
    kernel writes and the bias's sum reads again, is its design's
    traffic, not the function's, and is not counted."""
    moved = 2 * itemsize + 1
    nbytes = float(rows) * (H * moved + itemsize)
    if direction == "bwd":
        nbytes += float(bias_elems) * itemsize
    t_bytes = nbytes / HBM_BYTES_S
    t_ops = 4.0 * rows * H / FP32_PEAK
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", nbytes)


def attention_bound(rows, edges, K, F, direction):
    """The least time the card could take for GAT's attention
    (ops/gat_attention.py) over `rows` rows with `edges` in-edges, K heads
    of F float32 features, in ms, and what bounds it: forward, zst (z, s,
    t) read, o and the log-sum-exp written, the CSR read, or 2 (edges +
    rows) K F operations (the weighted sums, self terms included);
    backward, zst, o, the log-sum-exp and o's gradient read, zst's gradient
    written, the CSR read, or twice the operations. The same count as the
    benchmark's (benchmark/models/gat.py)."""
    ld, csr = K * F + 2 * K, 4.0 * (rows + 1 + edges)
    if direction == "fwd":
        nbytes = 4.0 * rows * (ld + K * F + K) + csr
        ops = 2.0 * (edges + rows) * K * F
    else:
        nbytes = 4.0 * rows * (2 * ld + 2 * K * F + K) + csr
        ops = 4.0 * (edges + rows) * K * F
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / FP32_PEAK
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", nbytes)


def spatial_attention_bound(lengths, K, D, direction):
    """The least time the card could take for Graphormer's attention
    (ops/spatial_attention.py) over segments of `lengths` rows, K heads of
    D float32 features, in ms, and what bounds it: forward, q, k, v read,
    o and the log-sum-exp written and phi's n^2 bytes read a segment of n,
    or 4 n^2 D operations a head (both products); backward, those bytes and
    o's gradient read and the gradients of q, k and v written, or 8 n^2 D
    a head. The same count as the benchmark's
    (benchmark/models/graphormer.py)."""
    n = sum(lengths)
    n2 = float(sum(x * x for x in lengths))
    H = K * D
    nbytes = 4.0 * n * (4 * H + K) + n2
    ops = 4.0 * n2 * D * K
    if direction != "fwd":
        nbytes += 4.0 * n * 4 * H
        ops *= 2
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / FP32_PEAK
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", nbytes)


def dense_bound(S, P, H, dtype):
    """The least time for S products (P, P) @ (P, H), in ms, and what
    bounds it: 2 S P^2 H operations at the dtype's peak (float32 outside
    the tensor cores; bf16 on them), or A and h read once and the (S, P,
    H) output written once in the dtype, whichever is longer; with the
    bytes."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    peak = BF16_PEAK if dtype == torch.bfloat16 else FP32_PEAK
    t_ops = 2.0 * S * P * P * H / peak
    nbytes = itemsize * (S * P * P + 2.0 * S * P * H)
    t_bytes = nbytes / HBM_BYTES_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", nbytes)


def rounding_bound(row_ptr, col, x, unit=2.0**-24):
    """Per output element, how far two sums of its row's n terms, taken in
    any two orders with every partial sum rounded to a unit roundoff of
    `unit` (2^-24 for float32, 2^-8 for bf16), can part: 2 (n - 1) unit
    sum |x| (each sum is within (n - 1) unit sum |x| of the exact one)."""
    from gmeta_tpu_torch.ops import sized_spmm as sp
    n = (row_ptr[1:] - row_ptr[:-1]).float()[:, None]
    return 2 * (n - 1).clamp(min=0) * unit * sp.csr_plain(
        row_ptr, col, x.abs().float())
