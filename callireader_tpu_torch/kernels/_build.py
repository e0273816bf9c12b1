"""Build and bind the hand-written CUDA kernels (nvcc -> .so -> ctypes).

Each source under ``callireader_tpu_torch/csrc/*.cu`` compiles on its own
into ``callireader_tpu_torch/_build/<name>.so`` for ``sm_90a`` with a plain C
interface, at first use (or all at once through ``build_all``, which starts
one nvcc per source in parallel). Nothing builds at import time: the CPU
tests import every module of the port. A C++ source (``csrc/<name>.cpp``,
the host char-prep library) builds the same way with the host's g++ into
``_build/lib<name>.so``; it needs no CUDA and builds on the CPU too.

A ``CudaKernel`` owns one C entry point. Calling it launches on the current
CUDA stream, raises if the C function returns a non-zero
``cudaGetLastError()``, and adds one to ``launches``. A decode step launches
a few hundred small kernels from the host, so the call takes the stream's
raw handle straight from PyTorch's C layer instead of building a
``torch.cuda.Stream`` object each time. Every ``LaunchCount`` (each
``CudaKernel``, and the model's count of decode steps) is listed in
``COUNTS``: a CUDA graph capture records launches that have not run, and
runtime/decode_graph.py takes them off again and adds them back at each
replay. ``COUNTS`` is also the program's registry of its own counters
(``Counter``: the span totals of utils/profiling.py, ``kernel_builds``,
``graph_captures``, ``decode_pad_steps``), which captures leave alone. Every
entry exists from its module's import on, under a name no other entry has, so
that a snapshot of ``COUNTS`` by name taken before a stretch of work can be
subtracted from one taken after it.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _is_host(name: str) -> bool:
    return (CSRC_DIR / f"{name}.cpp").exists()


def so_path(name: str) -> Path:
    return BUILD_DIR / (f"lib{name}.so" if _is_host(name) else f"{name}.so")


def _stale(name: str) -> bool:
    so = so_path(name)
    if not so.exists():
        return True
    deps = ([CSRC_DIR / f"{name}.cpp"] if _is_host(name)
            else [CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh")])
    return any(d.stat().st_mtime > so.stat().st_mtime for d in deps)


def _compiler(name: str, out: str) -> List[str]:
    if _is_host(name):
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError(f"g++ not found: {name}.cpp builds with the host's C++ compiler")
        return [gxx, *GXX_FLAGS, str(CSRC_DIR / f"{name}.cpp"), "-o", out]
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", out, str(CSRC_DIR / f"{name}.cu")]


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{name}.", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = _compiler(name, tmp)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    proc.kernel_name = name  # type: ignore[attr-defined]
    return proc


def build_all(names: Iterable[str], *, force: bool = False) -> Dict[str, str]:
    """Compile the named sources in parallel (one compiler each); returns
    the compiler output per source (register and shared-memory use from
    nvcc's ``-Xptxas -v``). Raises with the output if any build fails."""
    procs: List[subprocess.Popen] = [
        _start(n) for n in names if force or _stale(n)
    ]
    logs: Dict[str, str] = {}
    failed = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=900)
            logs[p.kernel_name] = out
            if p.returncode != 0:
                failed.append(p.kernel_name)
                os.unlink(p.tmp_path)
            else:
                os.replace(p.tmp_path, so_path(p.kernel_name))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    KERNEL_BUILDS.add(len(procs) - len(failed))
    if failed:
        raise RuntimeError(
            "the build failed for " + ", ".join(failed) + "\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def build_variants(root: Path, edits: Dict[str, Optional[Tuple[str, str, str]]],
                   sources: Sequence[str]) -> Dict[str, Dict[str, Tuple[str, str]]]:
    """Compile ``sources`` once for each entry of ``edits`` (one nvcc each, all
    in parallel) from a copy of ``csrc/`` under ``root`` in which the file
    ``edit[0]`` has its one line ``edit[1]`` replaced by ``edit[2]`` (None:
    the sources as they stand) -> {tag: {source: (.so path, nvcc output)}}.
    For probes that hold a kernel against a variant of itself."""
    shutil.rmtree(root, ignore_errors=True)
    procs = []
    for i, (tag, edit) in enumerate(edits.items()):
        src = root / f"src{i}"
        shutil.copytree(CSRC_DIR, src)
        if edit is not None:
            path, old, new = src / edit[0], edit[1], edit[2]
            text = path.read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"{edit[0]}: the line {old!r} was not found once")
            path.write_text(text.replace(old, new))
        for name in sources:
            so = root / f"{i}_{name}.so"
            procs.append((tag, name, str(so), subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-I", str(src), "-o", str(so), str(src / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out: Dict[str, Dict[str, Tuple[str, str]]] = {}
    for tag, name, so, p in procs:
        log, _ = p.communicate(timeout=900)
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name} ({tag}):\n{log}")
        out.setdefault(tag, {})[name] = (so, log)
    return out


def sass_functions(name: str) -> Dict[str, str]:
    """{kernel function: its SASS} of the built source ``name`` (building it
    if stale), read with the toolkit's ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or str(Path(nvcc_path()).with_name("cuobjdump"))
    load_library(name)
    sass = subprocess.run([tool, "-sass", str(BUILD_DIR / f"{name}.so")],
                          capture_output=True, text=True, check=True).stdout
    functions = {}
    for chunk in sass.split("Function : ")[1:]:
        fn, _, body = chunk.partition("\n")
        functions[fn.strip()] = body
    return functions


def load_library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build_all([name])
        lib = ctypes.CDLL(str(so_path(name)))
        _LIBS[name] = lib
    return lib


class LaunchCount:
    """A count of launches that graph replays keep true (``COUNTS``)."""

    replayed = True  # taken off at a graph capture, added back at each replay

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        COUNTS.append(self)


class Counter(LaunchCount):
    """A count of the program's own, registered in ``COUNTS`` beside the
    launch counts and read the same way (its value in ``launches``). A graph
    capture leaves it alone: nothing a capture records moves it."""

    replayed = False

    def add(self, n: int) -> None:
        self.launches += n


COUNTS: List[LaunchCount] = []
KERNEL_BUILDS = Counter("kernel_builds")  # sources compiled in this process


class CudaKernel(LaunchCount):
    """One C entry point of one source file, with its launch count."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        super().__init__(symbol)
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self._fn = None

    def entry_in(self, lib: ctypes.CDLL):
        """This entry point of ``lib`` (the built source, or a probe's variant
        of it), typed."""
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes + [ctypes.c_void_p]  # + stream
        fn.restype = ctypes.c_int
        return fn

    def _bind(self):
        if self._fn is None:
            self._fn = self.entry_in(load_library(self.source))
        return self._fn

    def __call__(self, *args) -> None:
        fn = self._fn or self._bind()
        stream = torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed: cudaError {rc}")
        self.launches += 1


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def refuse_grad(kernel: str, *tensors: Optional[torch.Tensor]) -> None:
    """A kernel with no backward writes into a tensor autograd never sees, so
    a wrapper that launched it on an input requiring grad would cut the
    gradient without a word: it raises instead (while grad is enabled). The
    caller asks for the differentiable plain version by name."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{kernel} has no backward: its input requires grad; call its plain "
                           f"version, or run under torch.no_grad()")


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    check_layout(t, name, dtype)


def check_layout(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """``t`` has ``dtype`` and is contiguous and 16-byte aligned."""
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
