"""Build and load the port's native libraries: its CUDA kernels and its
host C++ extraction engine.

Each `csrc/<name>.cu` has a plain C interface; it is compiled by nvcc for
sm_90a into a shared library at first use and loaded with ctypes.
`csrc/<name>.cpp` (host code) is compiled the same way by g++
(`build_host`). Libraries go to `build/gmeta_tpu_torch/` at the root of the
checkout, named by a hash of the source, the flags and (for g++) the
compiler's version, so an edited source is rebuilt and an unchanged one is
not. Nothing is compiled when a module is imported.

A build writes to a name of its own process (`<so>.tmp.<pid>`) and renames
it into place, so processes that build the same library at once (test
workers) neither share a half-written file nor leave one under the final
name.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "gmeta_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# No -march=native: build/ travels with a copy of the checkout, and a
# library tuned for the CPU that built it can die on another host's.
HOST_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """nvcc from CUDA_HOME, else PATH, else the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def host_compiler() -> Optional[str]:
    """The C++ compiler of host libraries: g++ on PATH, or None."""
    return shutil.which("g++")


@functools.lru_cache(maxsize=None)
def _compiler_version(cxx: str) -> str:
    return subprocess.run([cxx, "--version"], capture_output=True,
                          text=True, check=True).stdout


def _path(name: str, src: Path, flags, extra: str = "") -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                            + extra.encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def library_path(name: str) -> Path:
    return _path(name, CSRC / f"{name}.cu", NVCC_FLAGS)


def host_library_path(name: str) -> Path:
    cxx = host_compiler()
    if cxx is None:
        raise RuntimeError(f"g++ not found: cannot build csrc/{name}.cpp")
    return _path(name, CSRC / f"{name}.cpp", HOST_FLAGS,
                 _compiler_version(cxx))


def _compile(so: Path, cmd: List[str], what: str) -> str:
    """Run `cmd` + ["-o", tmp] and rename tmp to `so`; returns the
    compiler's output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
    r = subprocess.run(cmd + ["-o", str(tmp)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{what} failed:\n{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return r.stdout + r.stderr


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already built. The
    compiler's register/shared-memory report goes beside it (.ptxas.txt)."""
    so = library_path(name)
    if so.exists():
        return so
    report = _compile(so, [nvcc(), *NVCC_FLAGS, str(CSRC / f"{name}.cu")],
                      f"nvcc of {name}.cu")
    so.with_suffix(".ptxas.txt").write_text(report)
    return so


def build_host(name: str) -> Path:
    """Compile csrc/<name>.cpp with g++ unless its library is built."""
    so = host_library_path(name)
    if not so.exists():
        _compile(so, [host_compiler(), *HOST_FLAGS,
                      str(CSRC / f"{name}.cpp")], f"g++ of {name}.cpp")
    return so


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = _libs[name] = ctypes.CDLL(str(build(name)))
    return lib


def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cpp, built first if needed."""
    key = f"{name}.cpp"
    lib = _libs.get(key)
    if lib is None:
        lib = _libs[key] = ctypes.CDLL(str(build_host(name)))
    return lib
