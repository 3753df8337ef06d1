"""The traced window as intervals: the device's operations from
torch.profiler, the host's phases from the harness's own clock.

The profiler records only the device's activity (kernels, copies, sets;
recording the host's every operation as well slowed a step enough to idle
the card), on the Unix clock in ns. The harness marks the window and its
phases inside it (`dispatch`, `sync`) with `time.time_ns()` on the same
clock. `Trace` keeps them as (start_ns, end_ns, name) intervals and reduces
them: the union of the device's intervals (its busy time, overlapping
streams counted once), the idle gaps between them, each named by the
harness span the host was in when it began, and device time by operation
name.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

Interval = Tuple[int, int, str]


def _union(intervals: List[Interval]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e, _ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Trace:
    """One traced window: `device` and `host` intervals clipped to it, and
    `steps` meta-steps run inside it."""

    def __init__(self, window: Tuple[int, int], device: List[Interval],
                 host: List[Interval], steps: int):
        self.start, self.end = window
        clip = [(max(s, self.start), min(e, self.end), n)
                for s, e, n in device if e > self.start and s < self.end]
        self.device = clip
        self.host = host
        self.steps = steps

    @classmethod
    def from_profiler(cls, prof, steps: int, window, host) -> "Trace":
        """From a stopped `torch.profiler.profile` of the device's
        activity, the window's (start_ns, end_ns) and the host's spans."""
        from torch.autograd import DeviceType
        device = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and not getattr(
                    e, "is_user_annotation", lambda: False)():
                start = e.start_ns()
                device.append((start, start + e.duration_ns(), e.name()))
        return cls(window, device, host, steps)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in _union(self.device)) / 1e9

    def device_s(self, match: Callable[[str], bool]) -> float:
        """Summed device time of the operations whose names match."""
        return sum(e - s for s, e, n in self.device if match(n)) / 1e9

    def top_ops(self, k: int = 10) -> List[list]:
        by: dict = {}
        for s, e, n in self.device:
            by[n] = by.get(n, 0) + (e - s)
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n[:120], ns / 1e9] for n, ns in rows]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The k longest stretches with no device operation, each named by
        the harness span the host was in when it began (else "harness")."""
        gaps, t = [], self.start
        for s, e in _union(self.device) + [(self.end, self.end)]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        rows = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:k]:
            name = next((n for hs, he, n in self.host if hs <= s < he),
                        "harness")
            rows.append([name, (e - s) / 1e9])
        return rows
