"""Start the ranks of one host as processes, as `torchrun --nproc_per_node`
would, with a time limit: the launcher of the tests and of chip_smoke.py.

Each rank is `cmd` run in a fresh interpreter with RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT set (a free port
of localhost), so it imports only what `cmd` imports. If a rank fails, the
others are killed at once (they would wait on a collective until the
group's timeout), and so are all of them at the time limit.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(cmd: Sequence[str], nprocs: int, timeout: float,
                env: Optional[Dict[str, str]] = None,
                cwd: Optional[str] = None) -> List[str]:
    """Run `cmd` as ranks 0..nprocs-1 of one world and wait for all of
    them; returns each rank's output (stdout and stderr). Raises
    RuntimeError, with every rank's output, if a rank exits non-zero or the
    ranks outlast `timeout` seconds."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(nprocs), LOCAL_WORLD_SIZE=str(nprocs))
    with tempfile.TemporaryDirectory() as logs:
        files = [open(os.path.join(logs, f"rank{r}.log"), "w+")
                 for r in range(nprocs)]
        procs = []
        try:
            for r, f in enumerate(files):
                procs.append(subprocess.Popen(
                    list(cmd), env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                    stdout=f, stderr=subprocess.STDOUT, cwd=cwd))
            deadline = time.monotonic() + timeout
            failed = None
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    failed = "a rank failed"
                    break
                if time.monotonic() > deadline:
                    failed = f"the ranks outlasted {timeout} s"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            outs = []
            for f in files:
                f.seek(0)
                outs.append(f.read())
                f.close()
    if failed is None and any(p.returncode != 0 for p in procs):
        failed = "a rank failed"
    if failed is not None:
        detail = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{o}"
                           for r, (p, o) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"spawn_ranks: {failed}\n{detail}")
    return outs
