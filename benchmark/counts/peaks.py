"""Peak rates of one NVIDIA H100 SXM, and the least time a gather can take.

Frozen copies of the port's `utils/cardtime.py` figures (NVIDIA's data
sheet for the SXM part, dense rates without sparsity, at its 700 W power
limit) and of its `gather_bound`, so that the yardstick stays put whatever
the program later does to its own copy. A card set below 700 W runs slower
under load: every reading is reported beside the card's power limit.
"""

from __future__ import annotations

FP32_PEAK = 67e12       # FLOP/s, float32 outside the tensor cores
BF16_PEAK = 989e12      # FLOP/s, bf16 on the tensor cores, dense
HBM_BYTES_S = 3.35e12   # bytes/s of the HBM3

PEAK_BY_DTYPE = {"float32": FP32_PEAK, "bfloat16": BF16_PEAK}


def gather_bound(nnz, H, read_rows, n_out, itemsize=4):
    """The least time, in ms, that a gather of `nnz` edges over H columns
    can take: 2 nnz H operations at the float32 rate, or the table rows it
    names and its (n_out, H) output each moved once in elements of
    `itemsize` bytes, with the int32 CSR read once, whichever is longer.
    Returns (ms, "operations" or "bytes", bytes)."""
    t_ops = 2.0 * nnz * H / FP32_PEAK
    nbytes = (itemsize * (read_rows * H + n_out * H)
              + 4.0 * (n_out + 1 + nnz))
    t_bytes = nbytes / HBM_BYTES_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", nbytes)
