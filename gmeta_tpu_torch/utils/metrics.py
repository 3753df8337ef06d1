"""Structured metric stream: jsonl + stdout, and spans of the meta-step.

The reference's only observability is print statements
(G-Meta/train.py:110-111,124,137,146-148; SURVEY.md §5.5). Here every metric
event is a typed jsonl record (step, wall time, payload) so throughput
(tasks/s), accuracy curves, NaN skips, and memory are machine-readable,
while keeping the human-readable per-step line.

`span(name)` marks a phase of the program (a meta-step, its decode, its
inner steps, the aggregation...) while a torch.profiler is active, and
costs one check otherwise. Each recorded span keeps its name, its parent,
the meta-step it belongs to, its host interval on the Unix clock in ns (the
clock of the profiler's device events) and its device time between two
`StreamClock` marks, resolved by `spans()` once the window's work is done.

`count(name, n)` adds to one process-wide table of counts, the program's
only one: the kernel wrappers' launches, the repack's rows, the
collectives' calls and seconds, each under a dotted name that its module
fixes as a constant. `counted()` reads each name's delta over a stretch
of the program; nothing is ever reset.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, NamedTuple

import torch

try:
    import psutil
except ImportError:  # psutil is baked into the image, but stay safe
    psutil = None


def rss_gb() -> float:
    """This process's resident memory, GiB."""
    if psutil is None:
        return 0.0
    return float(psutil.Process().memory_info().rss / (1024 ** 3))


class MetricLogger:
    def __init__(self, path: str = "", echo: bool = True):
        self.path = path
        self.echo = echo
        self._f = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a", buffering=1)
        self.t0 = time.time()

    def log(self, kind: str, **payload):
        rec = {"kind": kind, "t": round(time.time() - self.t0, 4), **payload}
        if self._f is not None:
            self._f.write(json.dumps(rec, default=float) + "\n")
        return rec

    def echo_line(self, msg: str):
        if self.echo:
            print(msg, flush=True)

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class StreamClock:
    """Points in the compute stream's order and the seconds between them:
    CUDA timing events on a CUDA device, where the host runs ahead of the
    card and its clock would time the enqueueing; the host clock elsewhere,
    where each op has finished when it returns. `torch.device("cuda")`
    marks the current device's current stream."""

    def __init__(self, device: torch.device):
        self.device = device if device.type == "cuda" else None
        self._stream = None   # (device index, raw stream, its Stream)

    def mark(self):
        if self.device is None:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._current_stream())
        return ev

    def _current_stream(self):
        """The device's current stream. Its Python object is built again
        only when the stream changed: building one takes longer than
        recording the event (about 6 of 10 us on the H100 machine)."""
        idx = self.device.index
        if idx is None:
            idx = torch.cuda.current_device()
        raw = torch._C._cuda_getCurrentRawStream(idx)
        s = self._stream
        if s is None or s[0] != idx or s[1] != raw:
            s = self._stream = (idx, raw, torch.cuda.current_stream(idx))
        return s[2]

    @staticmethod
    def seconds(a, b) -> float:
        """Seconds from mark a to mark b; both must have completed."""
        if isinstance(a, float):
            return b - a
        return a.elapsed_time(b) / 1e3


# --- counts ------------------------------------------------------------------

_counts: Dict[str, float] = {}


def count(name: str, n=1) -> None:
    """Add n to the count `name`: one dict increment, unlocked. The
    program counts from one thread at a time (a backward runs on the
    autograd engine's thread while its caller waits in it)."""
    _counts[name] = _counts.get(name, 0) + n


def counts() -> Dict[str, float]:
    """The table as it stands: every name counted so far, with its total."""
    return dict(_counts)


class counted:
    """Each name's delta from here on: `c[name]` (0 for a name that did
    not move) and `c.of({key: name})` read it up to now, or, where `c` is
    used as a context manager, over its body. Marks nest and reset
    nothing."""

    def __init__(self):
        self._start = dict(_counts)
        self._end = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._end = dict(_counts)
        return False

    def __getitem__(self, name: str):
        end = _counts if self._end is None else self._end
        return end.get(name, 0) - self._start.get(name, 0)

    def of(self, names: Dict[str, str]) -> Dict[str, float]:
        """{key: delta of names[key]}, e.g. a kernel's launches by
        direction from its module's {"fwd": ..., "bwd": ...}."""
        return {k: self[n] for k, n in names.items()}


# --- spans -------------------------------------------------------------------

class Span(NamedTuple):
    name: str
    parent: int       # index of the parent in the window's list, -1: none
    step: int         # the meta-step's id, shared by its spans; -1: none
    start_ns: int     # host interval, time.time_ns()
    end_ns: int
    device_ms: float  # between the stream marks at open and close


MAX_SPANS = 200_000   # per window; later spans are not recorded

_profiling = torch._C._autograd._profiler_enabled
# a range of the profiler's host timeline, as `record_function` records
# one, without its operator call: a tenth of its host time
_Annotation = torch._C._profiler._RecordFunctionFast
_HOST = StreamClock(torch.device("cpu"))
_CUDA = StreamClock(torch.device("cuda"))
_lock = threading.Lock()


class _Local(threading.local):
    def __init__(self):
        self.stack = []    # the thread's open spans, innermost last


_tls = _Local()
_raw: list = []            # [name, parent, step, t0, t1, mark0, mark1]
_window: List[Span] = []   # the latest window, resolved
_grad_parent = -1          # the span open where `grad` was called
_next_step = 0


class _Off:
    """What `span` returns while no profiler is active: one object, reused."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NO_SPAN = _Off()


class _Span:
    __slots__ = ("idx", "entry", "clock", "annotation")

    def __init__(self, name: str):
        global _next_step
        stack = _tls.stack
        if stack:
            parent = stack[-1].idx
        elif torch._C._current_graph_task_id() != -1:
            # the autograd engine's own thread, inside a backward
            parent = _grad_parent
        else:
            parent = -1
        self.clock = _CUDA if torch.cuda.is_initialized() else _HOST
        with _lock:
            if len(_raw) >= MAX_SPANS:
                self.idx = None
                return
            if name == "step":
                step, _next_step = _next_step, _next_step + 1
            else:
                step = _raw[parent][2] if 0 <= parent < len(_raw) else -1
            self.idx = len(_raw)
            self.entry = [name, parent, step, time.time_ns(), 0,
                          self.clock.mark(), None]
            _raw.append(self.entry)
        stack.append(self)
        self.annotation = _Annotation(name)

    def __enter__(self):
        if self.idx is not None:
            self.annotation.__enter__()
        return None

    def __exit__(self, *exc):
        if self.idx is None:
            return False
        self.annotation.__exit__(*exc)
        self.entry[6] = self.clock.mark()
        self.entry[4] = time.time_ns()
        _tls.stack.pop()
        return False


def span(name: str):
    """A context manager that records a span of the program named `name`
    while a torch.profiler is active (the harness's traced window, the
    Trainer's `profile_dir` window), and does nothing otherwise. The
    profiler follows the thread that started it and the autograd engine's
    threads; a span on any other thread (the host pool's producer) records
    nothing. Its parent is the innermost span open on this thread; on the
    autograd engine's own thread, with none open there, the one that was
    innermost where `grad` was called. The span is also a range `name` of
    the profiler's host timeline (as `torch.profiler.record_function`
    makes one), so that the Chrome trace shows it."""
    if not _profiling():
        return NO_SPAN
    return _Span(name)


def grad(outputs, inputs, **kw):
    """`torch.autograd.grad`, under which spans that the autograd engine's
    own threads open (on CUDA the backward runs there) take the caller's
    innermost span as their parent."""
    global _grad_parent
    if not _profiling():
        return torch.autograd.grad(outputs, inputs, **kw)
    stack = _tls.stack
    prev, _grad_parent = _grad_parent, (stack[-1].idx if stack else -1)
    try:
        return torch.autograd.grad(outputs, inputs, **kw)
    finally:
        _grad_parent = prev


def bracket(tensor: torch.Tensor, name: str) -> None:
    """Record a span `name` around the backward of the autograd node that
    made `tensor` (while a profiler is active): hooks before and after the
    node, which leave its gradients as they are."""
    node = tensor.grad_fn
    if node is None or not _profiling():
        return
    open_ = []

    def pre(grad_outputs):
        s = span(name)
        s.__enter__()
        open_.append(s)

    def post(grad_inputs, grad_outputs):
        if open_:
            open_.pop().__exit__(None, None, None)

    node.register_prehook(pre)
    node.register_hook(post)


def clear_spans() -> None:
    """Forget the spans recorded so far (a new window starts)."""
    global _raw, _window
    with _lock:
        _raw, _window = [], []


def spans() -> List[Span]:
    """The spans of the latest profiled window, in the order they opened:
    those recorded since the previous call, or, if none were, what that
    call returned. Call it once the window's device work has finished (a
    sync) and no span is open."""
    global _raw, _window
    with _lock:
        raw, _raw = _raw, []
    if raw:
        out = []
        for name, parent, step, t0, t1, m0, m1 in raw:
            if m1 is None:          # never closed
                ms = 0.0
            else:
                if not isinstance(m1, float):
                    m1.synchronize()
                ms = StreamClock.seconds(m0, m1) * 1e3
            out.append(Span(name, parent, step, t0, t1, ms))
        _window = out
    return _window


def span_summary(window: List[Span]) -> Dict:
    """The steps of a window (its `step` spans), each name's count and its
    device ms per step. A span inside another of its own name (remat's
    rerun of the meta-loss forward within the meta-gradient) is counted
    but its time is not added twice."""
    steps = sum(s.name == "step" for s in window)
    count: Dict[str, int] = {}
    ms: Dict[str, float] = {}
    for s in window:
        count[s.name] = count.get(s.name, 0) + 1
        p = s.parent
        while p >= 0 and window[p].name != s.name:
            p = window[p].parent
        if p < 0:
            ms[s.name] = ms.get(s.name, 0.0) + s.device_ms
    per = max(steps, 1)
    return {"steps": steps, "count": count,
            "ms_per_step": {k: v / per for k, v in ms.items()}}
