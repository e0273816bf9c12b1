"""CUDA graphs of the decode: the port's counterpart of the JAX package's
compiled loops (runtime/generate.py's ``lax.while_loop`` inside one jit, and
the servers' jitted decode / ``lax.scan`` ticks).

A ``StepGraph`` runs a function that reads and writes persistent device
tensors only: static inputs that the host fills with ``copy_`` before a run,
and state updated in place. On a CUDA device its first run executes the
function on the capture stream without capturing: that run is real work
(the first chunk of a decode, the first tick of a server), and it does the
kernels' first-call setup (their shared-memory attributes) and PyTorch's lazy
initialisation outside any capture. It then captures the function into a
``torch.cuda.CUDAGraph``, and every later run replays that graph on the
current stream. A capture or a replay that fails raises: nothing falls back
to eager steps. On the CPU a StepGraph calls its function.

Launch counts: a capture records launches that do not run. A StepGraph keeps
how far each ``LaunchCount`` (kernels/_build.COUNTS: each kernel's count and
the model's ``DECODE_STEPS``) moved during its capture, takes that off, and
adds it back at each replay, so every count equals what ran. The program's
own counters (``_build.Counter``: span totals, builds) are left alone.

Under a mesh (``mesh=``) the function's collectives (the tensor-parallel
``all_reduce`` / ``all_gather`` of models/internlm2.py on NCCL) are captured
with the rest; before the first run every group of the mesh makes one
collective outside any capture, so that no communicator is created inside
one.

``GraphCache`` is a small LRU of graphs with their buffers, keyed by shapes
and knobs and tied to the identity of the parameter tensors they read: an
entry whose parameters die (a freed engine) is dropped at once, with its
buffers and its graph's memory pool.
"""

from __future__ import annotations

import collections
import gc
import weakref
from typing import Any, Callable, Dict, Hashable, List, Optional, Tuple

import torch

from callireader_tpu_torch.kernels._build import COUNTS, Counter

_CAPTURE_STREAMS: Dict[int, Any] = {}
GRAPH_CAPTURES = Counter("graph_captures")  # GraphCache misses that built a graph


def _capture_stream(device: torch.device):
    """One side stream per card for every first run and capture (a graph's
    memory pool is shared best when its captures use one stream)."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    s = _CAPTURE_STREAMS.get(index)
    if s is None:
        s = _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
    return s


class StepGraph:
    """A function run once eagerly, then captured and replayed (see the module
    docstring): ``graph(fn)`` runs ``fn`` itself at the first run and the
    capture (and at every run on the CPU or when ``eager``), and replays the
    capture afterwards; the graph keeps no reference to ``fn``.
    ``generator``: a torch.Generator that ``fn`` draws from, registered with
    the graph so that each replay draws afresh. ``share``: another StepGraph
    whose memory pool this one's capture shares (never replayed at the same
    time). ``eager``: run ``fn`` every time, on the card too (for tests that
    hold the graph against it). ``mesh``: the mesh whose collectives ``fn``
    runs."""

    def __init__(self, device: torch.device, *, generator: Optional[torch.Generator] = None,
                 share: Optional["StepGraph"] = None, eager: bool = False, mesh=None):
        self.device = torch.device(device)
        self.generator = generator
        self.share = share
        self.eager = eager
        self.mesh = mesh
        self.graph = None
        self.out = None
        self.counts: List[Tuple[Any, int]] = []

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self, fn: Callable[[], Any]) -> Any:
        if self.device.type != "cuda" or self.eager:
            return fn()
        if self.graph is None:
            return self._run_and_capture(fn)
        self.graph.replay()
        for count, n in self.counts:
            count.launches += n
        return self.out

    def _run_and_capture(self, fn: Callable[[], Any]) -> Any:
        if self.mesh is not None:
            import torch.distributed as dist

            for axis in self.mesh.axis_names:
                dist.all_reduce(torch.zeros(1, device=self.device), group=self.mesh.group(axis))
        main = torch.cuda.current_stream(self.device)
        side = _capture_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = fn()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.generator is not None:
            graph.register_generator_state(self.generator)
        pool = self.share.graph.pool() if self.share is not None and self.share.captured else None
        tracked = [c for c in COUNTS if c.replayed]
        before = [c.launches for c in tracked]
        # no cyclic garbage collection inside the capture: a finalizer that
        # frees CUDA objects (an old graph's memory pool) would make a call
        # the capture forbids (torch.cuda.graph collects just before it)
        collecting = gc.isenabled()
        gc.disable()
        try:
            # thread_local: a server's other threads (request uploads) may
            # use the card while its scheduler thread captures
            with torch.cuda.graph(graph, pool=pool, stream=side, capture_error_mode="thread_local"):
                captured_out = fn()
        except Exception:
            # the next capture takes a fresh stream, not one a failed
            # capture may have left tied to its memory pool
            _CAPTURE_STREAMS.pop(side.device_index, None)
            raise
        finally:
            if collecting:
                gc.enable()
            moved = [(c, c.launches - b) for c, b in zip(tracked, before)]
            for c, n in moved:
                c.launches -= n  # recorded, not run
        self.graph, self.out = graph, captured_out
        self.counts = [(c, n) for c, n in moved if n]
        return out


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return []


class GraphCache:
    """LRU of at most ``capacity`` values (graphs with their buffers) keyed by
    ``key`` and the identity of every tensor of ``params``."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.entries: Dict[Hashable, Tuple[Any, list]] = collections.OrderedDict()

    def get(self, key: Hashable, params, build: Callable[[], Any]) -> Any:
        leaves = _leaves(params)
        full = (key, tuple(id(t) for t in leaves))
        hit = self.entries.get(full)
        if hit is not None and all(r() is t for r, t in zip(hit[1], leaves)):
            self.entries.move_to_end(full)
            return hit[0]
        self.entries.pop(full, None)
        value = build()
        GRAPH_CAPTURES.add(1)
        refs = [weakref.ref(t, lambda _r, k=full: self.entries.pop(k, None)) for t in leaves]
        self.entries[full] = (value, refs)
        while len(self.entries) > self.capacity:
            self.entries.popitem(last=False)
        return value

    def discard(self, value) -> None:
        for k in [k for k, (v, _) in self.entries.items() if v is value]:
            del self.entries[k]

    def clear(self) -> None:
        self.entries.clear()

    def __len__(self) -> int:
        return len(self.entries)
