"""Reading a torch.profiler trace of a window: what ran on the device, when,
and what the host was doing in the gaps. The benchmark's own calls carry
``record_function("chipbench.<step>")`` ranges; device activities are the
CUDA kernels, copies and sets. Counts of a kernel family are held against
the program's launch counters (``CudaKernel.launches``, kept true across
CUDA graph replays): a family whose events the trace lacks reads as
missing, never as zero time. The profiler also lays each benchmark range
onto the device's timeline (from the first to the last kernel launched
inside it): ``range_busy`` reads the device time within those spans,
which the pace of the host's enqueue does not stretch.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

HOST_PREFIX = "chipbench."


def _raw(prof) -> List[Tuple[str, bool, float, float]]:
    """(name, on the device, start s, end s) of every event."""
    from torch.autograd import DeviceType

    return [(e.name(), e.device_type() == DeviceType.CUDA, e.start_ns() * 1e-9,
             (e.start_ns() + e.duration_ns()) * 1e-9) for e in prof.profiler.kineto_results.events()]


class Trace:
    def __init__(self, events: List[Tuple[str, bool, float, float]], window_s: float):
        self.window_s = window_s
        self.device = sorted((s, e, n) for n, dev, s, e in events
                             if dev and not n.startswith(HOST_PREFIX) and e > s)
        self.host = sorted((s, e, n) for n, dev, s, e in events if not dev and n.startswith(HOST_PREFIX))
        self.ranges = sorted((s, e, n) for n, dev, s, e in events if dev and n.startswith(HOST_PREFIX))
        merged: List[List[float]] = []
        for s, e, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy = merged
        self.busy_s = sum(e - s for s, e in merged)

    @classmethod
    def from_profiler(cls, prof, window_s: float) -> "Trace":
        return cls(_raw(prof), window_s)

    def family(self, pattern: str, regex: bool = False) -> Tuple[int, float]:
        """(events, device seconds) of the kernels whose name holds ``pattern``
        as a whole word (``regex``: matches the regular expression)."""
        rx = re.compile(pattern if regex else
                        r"(?<![A-Za-z0-9_])" + re.escape(pattern) + r"(?![A-Za-z0-9_])")
        n, t = 0, 0.0
        for s, e, name in self.device:
            if rx.search(name):
                n += 1
                t += e - s
        return n, t

    def range_busy(self, name: str) -> List[float]:
        """Device seconds in which an operation ran within each device span
        of the benchmark range ``name``, in order."""
        out = []
        for lo, hi, n in self.ranges:
            if n == HOST_PREFIX + name:
                out.append(sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in self.busy))
        return out

    def top_ops(self, k: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for s, e, name in self.device:
            by[name] = by.get(name, 0.0) + (e - s)
        return [[n[:160], t] for n, t in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[List]:
        """The ``k`` longest gaps between device activity, each named by the
        innermost benchmark range the host was in at its middle."""
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(self.busy, self.busy[1:])]
        out = []
        for length, s, e in sorted(gaps, reverse=True)[:k]:
            mid = (s + e) / 2
            inside = [(hs, he, n) for hs, he, n in self.host if hs <= mid <= he]
            name = min(inside, key=lambda x: x[1] - x[0])[2] if inside else "outside the benchmark's calls"
            out.append([name, length])
        return out


class Context:
    """What a per-layer metric reads: the trace, the program's launch counts
    over the traced stretch, the run's record of its work (``window``: the
    untraced window, its seconds and host times; ``traced``: the stretch run
    under the profiler after it), and the configuration."""

    def __init__(self, trace: Optional[Trace], launches: Dict[str, int], work: Dict, cfg: Dict):
        self.trace, self.launches, self.work, self.cfg = trace, launches, work, cfg
        self.missing: List[str] = []

    def kernel_seconds(self, symbol: str, pattern: str, regex: bool = False) -> Optional[float]:
        """Device seconds of the kernels ``pattern`` launched by the C entry
        point ``symbol``; None when the trace holds fewer of them than the
        program launched (or none were launched)."""
        launched = self.launches.get(symbol, 0)
        n, t = self.trace.family(pattern, regex) if self.trace is not None else (0, 0.0)
        if launched == 0 or n < launched:
            self.missing.append(f"{pattern}: {n} events, {launched} launches")
            return None
        return t

    def idle_share(self, work_of) -> Optional[float]:
        """Percent of the untraced window in which the device is idle: the
        trace's busy seconds, scaled from the traced stretch's work to the
        window's by ``work_of(record)``, against the window's seconds. The
        profiler slows the host's enqueue, so the traced stretch's own idle
        share reads high."""
        if self.trace is None or self.trace.busy_s <= 0:
            return None
        window, traced = self.work["window"], self.work["traced"]
        busy = self.trace.busy_s * work_of(window) / work_of(traced)
        return 100.0 * (1.0 - busy / window["window_s"])
