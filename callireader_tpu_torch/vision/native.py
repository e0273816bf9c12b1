"""ctypes bridge to the native char-preprocessing library (port of
callireader_tpu/vision/native.py).

``csrc/charprep.cpp`` (a byte-for-byte copy of the JAX package's
``native/charprep.cpp``) builds with g++ at first use, through
kernels/_build.py's staleness cache, into ``_build/libcharprep.so``. It runs
the batched crop -> scale -> centre-pad-white pipeline of the host char
route over a thread pool, each crop written by one thread, so the thread
count changes no byte. The library pastes each row without clipping, so a
content wider than the canvas would be written past its crop's canvas
(into the neighbour's, or before the array for the first crop, at a place
that depends on the threads' order): ``char_content_batch`` refuses such a
crop, as ``preprocess.load_char_content`` does. Outputs are within 2/255 of PIL's bicubic (the
library convolves in double precision where PIL uses int16 fixed point).

A failed build or load raises with the compiler's or the loader's message:
there is no quiet switch to the numpy route (vision/preprocess.py's
``load_char_content`` stays the plain version the tests hold it to).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List

import numpy as np

from callireader_tpu_torch.kernels import _build

SOURCE = "charprep"
_LIB = None
_LOCK = threading.Lock()


def get_lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        with _LOCK:
            if _LIB is None:
                lib = _build.load_library(SOURCE)
                lib.char_content_batch.argtypes = [
                    ctypes.c_void_p,  # srcs
                    ctypes.POINTER(ctypes.c_longlong),
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.POINTER(ctypes.c_int),
                    ctypes.c_void_p,  # out
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ]
                lib.resize_bicubic_u8.argtypes = [
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ]
                _LIB = lib
    return _LIB


def resize_bicubic(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """(h, w, 3) uint8 -> (dh, dw, 3) uint8, PIL-compatible bicubic."""
    lib = get_lib()
    src = np.ascontiguousarray(src, np.uint8)
    out = np.empty((dh, dw, 3), np.uint8)
    lib.resize_bicubic_u8(src.ctypes.data, src.shape[0], src.shape[1], out.ctypes.data, dh, dw)
    return out


def content_dims(h: int, w: int, lo: int, hi: int):
    """The library's scaled (rows, cols) of an h x w crop: its longest edge
    brought into [lo, hi], each side truncated, at least 1."""
    m = max(h, w)
    scale = lo / m if m <= lo else hi / m if m >= hi else 1.0
    return max(int(h * scale), 1), max(int(w * scale), 1)


def char_content_batch(
    crops: List[np.ndarray], canvas: int, lo: int, hi: int, nthreads: int = 0
) -> np.ndarray:
    """crops: list of HWC uint8 arrays -> (N, canvas, canvas, 3) uint8: each
    scaled so its longest edge lies in [lo, hi], centred on white."""
    lib = get_lib()
    n = len(crops)
    crops = [np.ascontiguousarray(c, np.uint8) for c in crops]
    for c in crops:
        nh, nw = content_dims(c.shape[0], c.shape[1], lo, hi)
        if max(nh, nw) > canvas:
            raise ValueError(f"canvas {canvas} cannot hold a {nw}x{nh} char")
    packed = np.concatenate([c.reshape(-1) for c in crops])
    offsets = np.zeros(n, np.int64)
    shs = np.zeros(n, np.int32)
    sws = np.zeros(n, np.int32)
    off = 0
    for i, c in enumerate(crops):
        offsets[i] = off
        shs[i] = c.shape[0]
        sws[i] = c.shape[1]
        off += c.size
    out = np.empty((n, canvas, canvas, 3), np.uint8)
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 1)
    lib.char_content_batch(
        packed.ctypes.data,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        shs.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        sws.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        out.ctypes.data, n, canvas, lo, hi, nthreads,
    )
    return out
