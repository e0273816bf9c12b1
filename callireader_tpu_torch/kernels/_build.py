"""Build and bind the hand-written CUDA kernels (nvcc -> .so -> ctypes).

Each source under ``callireader_tpu_torch/csrc/*.cu`` compiles on its own
into ``callireader_tpu_torch/_build/<name>.so`` for ``sm_90a`` with a plain C
interface, at first use (or all at once through ``build_all``, which starts
one nvcc per source in parallel). Nothing builds at import time: the CPU
tests import every module of the port.

A ``CudaKernel`` owns one C entry point. Calling it launches on the current
CUDA stream, raises if the C function returns a non-zero
``cudaGetLastError()``, and adds one to ``launches``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _stale(name: str) -> bool:
    so = BUILD_DIR / f"{name}.so"
    if not so.exists():
        return True
    deps = [CSRC_DIR / f"{name}.cu", *CSRC_DIR.glob("*.cuh")]
    return any(d.stat().st_mtime > so.stat().st_mtime for d in deps)


def _start(name: str) -> subprocess.Popen:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f"{name}.", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC_DIR), "-o", tmp,
           str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    proc.tmp_path = tmp  # type: ignore[attr-defined]
    proc.kernel_name = name  # type: ignore[attr-defined]
    return proc


def build_all(names: Iterable[str], *, force: bool = False) -> Dict[str, str]:
    """Compile the named sources in parallel (one nvcc each); returns the
    compiler output per source (register and shared-memory use from
    ``-Xptxas -v``). Raises if any build fails."""
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
                os.replace(p.tmp_path, BUILD_DIR / f"{p.kernel_name}.so")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + "\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load_library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            build_all([name])
        lib = ctypes.CDLL(str(BUILD_DIR / f"{name}.so"))
        _LIBS[name] = lib
    return lib


class CudaKernel:
    """One C entry point of one source file, with its launch count."""

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _bind(self):
        if self._fn is None:
            fn = getattr(load_library(self.source), self.symbol)
            fn.argtypes = self.argtypes + [ctypes.c_void_p]  # + stream
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, *args) -> None:
        fn = self._bind()
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed: cudaError {rc}")
        self.launches += 1


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
