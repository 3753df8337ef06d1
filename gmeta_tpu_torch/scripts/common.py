"""What the measurement scripts share: the repository root, the device and
card header, and writing one result."""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import torch

from gmeta_tpu_torch.utils.cardtime import card_line
from gmeta_tpu_torch.utils.device import resolve_device

ROOT = Path(__file__).resolve().parents[2]
OUT_DIR = ROOT / "measure_torch"


def parser(name: str, doc: str) -> argparse.ArgumentParser:
    """An argument parser with the flags every script takes: --device
    (CUDA unless named; no CUDA and no name raises) and --out (default
    measure_torch/<name>.json)."""
    ap = argparse.ArgumentParser(f"gmeta_tpu_torch.scripts.{name}",
                                 description=doc.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu, where the plain versions "
                         "run in place of the kernels")
    ap.add_argument("--out", default=str(OUT_DIR / f"{name}.json"))
    return ap


def start(device_arg) -> tuple:
    """(device, header): the device an argument names (utils/device.py
    `resolve_device`, which raises without CUDA unless the CPU is named),
    and what the result records of it: on CUDA the card's name and
    nvidia-smi's name and power limit, printed here."""
    device = resolve_device(device_arg)
    head = {"device": str(device), "torch": torch.__version__}
    if device.type == "cuda":
        head["kind"] = torch.cuda.get_device_name(device)
        head["card"] = card_line()
        print(f"# {head['kind']}; nvidia-smi: {head['card']}; torch "
              f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    return device, head


def finish(result: dict, out: str, table) -> dict:
    """Write the result to `out` (JSON), print it as one line, then the
    markdown table's lines. Returns the result."""
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result), flush=True)
    for line in table:
        print(line, flush=True)
    return result


def fmt(x, digits=3) -> str:
    """A table cell: '-' for a missing value."""
    if x is None:
        return "-"
    if isinstance(x, str):
        return x
    return f"{x:.{digits}f}"
