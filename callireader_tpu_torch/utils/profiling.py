"""The port's recorder of spans and counters, and training throughput
(PyTorch port of callireader_tpu/utils/profiling.py: ``Spans``,
``TrainThroughput``). The XLA trace helpers (``trace``, ``parse_xplane``)
have no counterpart here: torch.profiler traces the card directly.

``Spans`` records named host spans, nested, without ever synchronising the
device:

- each span's name, its parent (the span open around it on the same thread)
  and its start and end in ``time.time_ns()``, the clock of torch.profiler's
  events, into a bounded in-memory log (``log``, a ring of ``LOG_SIZE``);
- per name, the host seconds (``totals``), the calls (``counts``), the host
  seconds of the ``blocked.*`` spans inside it (``blocked``) and, for each
  ``device(name)`` bracket, the device seconds between a pair of CUDA events
  recorded on the current stream around the launches it holds
  (``device_totals``; the host's preparation and uploads stay outside the
  bracket, so that the device's waits for them do not count). The events
  come from a pool; ``resolve()`` reads the pairs whose end the stream has
  passed (``query()``) and adds their time. The blocking readbacks
  (``readback``) resolve right after they return, when the stream has passed
  every event recorded before them. On the CPU a bracket records nothing.

``SPANS`` is the program's recorder. The names in ``SPAN_NAMES`` are also
counters in ``kernels/_build.COUNTS`` (``span.<name>.host_ns``,
``.device_ns``, ``.blocked_ns``, ``.calls``), made when this module is
imported, so that a snapshot of the registry taken before a stretch of work
can be subtracted from one taken after it; with ``blocked.upload.bytes``, the
bytes handed to ``upload``. Other names stay in memory only (the train CLI's
own ``Spans()`` publishes nothing).

The program opens no ``torch.profiler.record_function`` range: the profiler
lays a range that encloses kernel launches onto the device's timeline, where
a reader of the trace would take it for device work. Its stamps on the
profiler's clock let a trace's gaps be named by the program's spans instead.

``DEVICE_SPANS`` are device brackets with no host span of their own (each
MLA-MoE prefill layer's routed experts); a bracket read counts as a call.
``DeviceTally`` keeps a data-dependent count on the device (the expert
layer's touched experts, which a captured decode step adds into) and
publishes it as a ``Counter`` with the next ``readback``, never waiting.

``Spans.enabled = False`` turns every recorder off: a span then costs one
attribute check.

Training throughput reads the host clock: on CUDA it measures device work
only where the step synchronises (the train CLI's step reads its loss,
which does).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from callireader_tpu_torch.kernels import _build

LOG_SIZE = 4096  # spans kept in the log; the oldest drop out first
BLOCKED = "blocked."  # prefix of the spans in which the host waits for the device

# every span of the page route (runtime/engine.py, runtime/generate.py,
# models/detector.py, models/orderformer.py); each is a counter too
SPAN_NAMES = (
    # the box stage
    "detect_dispatch", "detect_fetch", "nms", "columns", "order_dispatch", "order_fetch",
    # batch_build_rows
    "page_tiling", "char_prep", "char_route", "tile_encode", "tokenize", "embed_build",
    # generate, then batch_decode
    "prefill", "decode", "readback", "detokenize",
    # the waits, each inside the span of its site
    "blocked.upload", "blocked.readback",
)
# the stages of the route: every span but those only ever opened inside
# another (the host NMS, the waits)
STAGE_SPANS = tuple(n for n in SPAN_NAMES if n != "nms" and not n.startswith(BLOCKED))
# device brackets with no host span of their own, inside a stage: a bracket
# counts as a call when its time is read (models/mla_moe.py: each prefill
# layer's routed experts)
DEVICE_SPANS = ("prefill_experts",)
SPAN_FIELDS = ("host_ns", "device_ns", "blocked_ns", "calls")
_COUNTERS = {name: tuple(_build.Counter(f"span.{name}.{f}") for f in SPAN_FIELDS)
             for name in SPAN_NAMES + DEVICE_SPANS}
UPLOAD_BYTES = _build.Counter("blocked.upload.bytes")

_NULL = contextlib.nullcontext()


class _Span:
    __slots__ = ("rec", "frame")

    def __init__(self, rec: "Spans", name: str):
        self.rec = rec
        self.frame = [name, 0, None]  # name, blocked ns inside it, log entry

    def __enter__(self):
        stack = self.rec._stack()
        # name, parent, start, end, thread, device ns (the brackets inside it)
        self.frame[2] = [self.frame[0], stack[-1][0] if stack else None, 0, 0, threading.get_ident(), None]
        stack.append(self.frame)
        self.frame[2][2] = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        stack = self.rec._stack()
        name, blocked, entry = stack.pop()
        entry[3] = t1
        host = t1 - entry[2]
        self.rec._close(name, host, blocked, entry)
        if stack:
            stack[-1][1] += host if name.startswith(BLOCKED) else blocked
        return False


class _Device:
    __slots__ = ("rec", "name", "ev", "entry")

    def __init__(self, rec: "Spans", name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        # the log entry of the innermost open span of this name, if any
        self.entry = next((f[2] for f in reversed(self.rec._stack()) if f[0] == self.name), None)
        self.ev = self.rec._start_event()
        return self

    def __exit__(self, *exc):
        if self.ev is not None:
            self.rec._end_event(self.name, self.ev, self.entry)
        return False


class Spans:
    """Named spans with host and device time (see the module docstring)."""

    enabled = True  # the one switch for every recorder

    def __init__(self, publish: bool = False):
        self.totals: Dict[str, float] = {}  # host s
        self.counts: Dict[str, int] = {}
        self.blocked: Dict[str, float] = {}  # host s of the blocked.* spans inside
        self.device_totals: Dict[str, float] = {}  # device s
        self.log: collections.deque = collections.deque(maxlen=LOG_SIZE)
        self._counters = _COUNTERS if publish else {}
        self._local = threading.local()
        self._lock = threading.Lock()
        self._pending: List[Tuple[str, torch.cuda.Event, torch.cuda.Event, Optional[list]]] = []
        self._pool: List[torch.cuda.Event] = []

    # ---------------------------------------------------------- recording

    def span(self, name: str):
        """A context manager timing ``name`` on the host."""
        if not Spans.enabled:
            return _NULL
        return _Span(self, name)

    def device(self, name: str):
        """A pair of CUDA events around launches of the span ``name`` (after
        its host preparation and uploads), credited to ``name``'s device
        time and to the log entry of the open span ``name``; no host
        span."""
        if not Spans.enabled:
            return _NULL
        return _Device(self, name)

    def add(self, name: str, dt: float) -> None:
        """``dt`` host seconds and one call for ``name``, as a span would."""
        t1 = time.time_ns()
        ns = int(dt * 1e9)
        self._close(name, ns, 0, [name, None, t1 - ns, t1, threading.get_ident(), None])

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _close(self, name: str, host_ns: int, blocked_ns: int, entry: list) -> None:
        c = self._counters.get(name)
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + host_ns * 1e-9
            self.counts[name] = self.counts.get(name, 0) + 1
            if blocked_ns:
                self.blocked[name] = self.blocked.get(name, 0.0) + blocked_ns * 1e-9
            self.log.append(entry)
            if c is not None:
                c[0].add(host_ns)
                c[2].add(blocked_ns)
                c[3].add(1)

    def _start_event(self) -> Optional[torch.cuda.Event]:
        if not torch.cuda.is_initialized() or torch.cuda.is_current_stream_capturing():
            return None
        with self._lock:
            ev = self._pool.pop() if self._pool else None
        ev = ev or torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def _end_event(self, name: str, start: torch.cuda.Event, entry: Optional[list]) -> None:
        with self._lock:
            end = self._pool.pop() if self._pool else None
        end = end or torch.cuda.Event(enable_timing=True)
        end.record()
        with self._lock:
            self._pending.append((name, start, end, entry))

    def resolve(self) -> None:
        """Adds the device time of every event pair the stream has passed;
        the rest stay pending. Never waits."""
        if not self._pending:
            return
        with self._lock:
            pending, self._pending = self._pending, []
        left = []
        for name, start, end, entry in pending:
            if not end.query():
                left.append((name, start, end, entry))
                continue
            ns = int(start.elapsed_time(end) * 1e6)
            c = self._counters.get(name)
            with self._lock:
                self.device_totals[name] = self.device_totals.get(name, 0.0) + ns * 1e-9
                self._pool += (start, end)
                if c is not None:
                    c[1].add(ns)
                    if name in DEVICE_SPANS:
                        c[3].add(1)
            if entry is not None:
                entry[5] = (entry[5] or 0) + ns
        if left:
            with self._lock:
                self._pending = left + self._pending

    # ---------------------------------------------------------- reading

    def report(self) -> str:
        """One line a name: host s, of them blocked s, device s, calls."""
        lines = []
        for name in sorted(self.totals):
            n, t = self.counts[name], self.totals[name]
            dev = self.device_totals.get(name)
            lines.append(f"{name:24s} {t:8.3f}s  blocked {self.blocked.get(name, 0.0):8.3f}s  device "
                         + (f"{dev:8.3f}s" if dev is not None else "       -")
                         + f"  x{n:<5d} ({t / max(n, 1) * 1000:8.1f} ms/call)")
        return "\n".join(lines)

    def chrome_trace(self, path: str) -> None:
        """The log as Chrome-trace JSON: one complete event a span, ``ts`` in
        us since the Unix epoch (torch.profiler's clock: an export of it plus
        its ``baseTimeNanoseconds``), the parent and the device ms in
        ``args``."""
        pid = os.getpid()
        events = [{"name": name, "ph": "X", "cat": "span", "pid": pid, "tid": tid,
                   "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
                   "args": {"parent": parent, "device_ms": None if dev is None else dev / 1e6}}
                  for name, parent, t0, t1, tid, dev in list(self.log)]
        with open(path, "w") as f:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)

    def reset(self) -> None:
        """Clears the in-memory totals and log (the counters of ``COUNTS``
        only ever grow)."""
        with self._lock:
            for d in (self.totals, self.counts, self.blocked, self.device_totals):
                d.clear()
            self.log.clear()


SPANS = Spans(publish=True)


def counters_report() -> str:
    """The program's counters other than the span totals, and each kernel's
    launches and the decode steps run, one a line."""
    return "\n".join(f"{c.name:24s} {c.launches}" for c in _build.COUNTS
                     if not c.name.startswith("span."))


def _blocks(t: torch.Tensor, device) -> bool:
    """Whether ``upload`` records ``t.to(device)``: a copy from host memory
    to another device, with the recorder on."""
    return Spans.enabled and t.device.type == "cpu" and torch.device(device).type != "cpu"


def upload(t: torch.Tensor, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``t.to(device, dtype)``: from host memory to the card a blocking copy
    (it waits for the work queued before it), timed as a ``blocked.upload``
    span inside its site's span, its bytes counted; any other move, or any
    with the recorder off, is a plain ``.to``."""
    if not _blocks(t, device):
        return t.to(device, dtype)
    with SPANS._lock:
        UPLOAD_BYTES.add(t.numel() * t.element_size())
    with SPANS.span("blocked.upload"):
        return t.to(device, dtype)


def readback(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()``, timed as a ``blocked.readback`` span inside its site's
    span; then the pending device brackets and tallies are resolved."""
    with SPANS.span("blocked.readback"):
        out = t.cpu()
    SPANS.resolve()
    for tally in TALLIES:
        tally.collect()
    return out


class DeviceTally:
    """A count the device keeps, published as the ``Counter`` ``name`` of
    ``kernels/_build.COUNTS``: work adds into ``acc(device)``, a (1,) int64
    tensor made once a device (before any graph captures an add into it, so
    that replays add too); ``snapshot()`` (generate's decode routes, after
    their steps are enqueued) queues a copy into pinned host memory behind
    the work so far, without waiting; ``collect()`` (each ``readback``, so
    with the tokens) adds to the counter what the copies the stream has
    passed show. No read of its own ever waits for the device."""

    def __init__(self, name: str):
        self.counter = _build.Counter(name)
        self._acc: Dict[str, torch.Tensor] = {}
        self._seen: Dict[str, int] = {}
        self._pending: List[Tuple[str, torch.Tensor, Optional[torch.cuda.Event]]] = []
        TALLIES.append(self)

    def acc(self, device) -> torch.Tensor:
        key = str(torch.device(device))
        t = self._acc.get(key)
        if t is None:
            with torch.inference_mode(False):
                t = self._acc[key] = torch.zeros(1, dtype=torch.int64, device=device)
        return t

    def snapshot(self) -> None:
        for key, t in self._acc.items():
            if t.device.type != "cuda":
                self._pending.append((key, t.clone(), None))
                continue
            host = torch.empty(1, dtype=torch.int64, pin_memory=True)
            host.copy_(t, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            self._pending.append((key, host, ev))

    def collect(self) -> None:
        while self._pending:
            key, host, ev = self._pending[0]
            if ev is not None and not ev.query():
                return
            self._pending.pop(0)
            value = int(host[0])
            self.counter.add(value - self._seen.get(key, 0))
            self._seen[key] = value


TALLIES: List[DeviceTally] = []


def snapshot_tallies() -> None:
    for tally in TALLIES:
        tally.snapshot()


class TrainThroughput:
    """Tokens/s across train steps. The clock starts at the first ``step``
    call, so the first step's tokens count but not its time."""

    def __init__(self):
        self._t0: Optional[float] = None
        self.tokens = 0
        self.steps = 0

    def start(self):
        self._t0 = time.time()

    def step(self, batch_tokens: int) -> Dict[str, float]:
        if self._t0 is None:
            self.start()
        self.tokens += batch_tokens
        self.steps += 1
        dt = max(time.time() - self._t0, 1e-9)
        return {"tokens_per_sec": self.tokens / dt, "steps_per_sec": self.steps / dt}
