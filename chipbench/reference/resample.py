"""Image resampling without PIL, a frozen copy of the port's vision/resample.py.

Two families, both as explicit separable weights:

(a) ``jax.image.resize(..., "cubic")`` semantics, used by the on-device page
    tiling (engine._page_tiles_impl) and the ViT position-embedding resize:
    Keys cubic (a = -0.5), the kernel widened by the scale when downscaling
    (antialias), columns renormalised, samples outside the input zeroed.
    ``jax_resize_weights`` builds the (out, in) matrix in float32 with the
    same formulas and operation order as jax/_src/image/scale.py; a resize is
    then two matmuls on the device.

(b) PIL's ``Image.resize`` with BILINEAR (detector letterbox) and BICUBIC
    (char crops that would be downscaled), in numpy: the coefficients of
    Pillow's Resample.c (support widened by the scale, normalised, rounded to
    22-bit fixed point), a horizontal pass then a vertical pass, each
    rounding to uint8. A pass whose size does not change is skipped, as
    Pillow does.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

# ---------------------------------------------------------------- (a) jax


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1.0)
    out = np.where(x >= f32(1.0), ((f32(-0.5) * x + f32(2.5)) * x - f32(4.0)) * x + f32(2.0), out)
    return np.where(x >= f32(2.0), f32(0.0), out).astype(np.float32)


def jax_resize_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) float32 weights of jax.image.resize "cubic" (antialiased)
    along one axis."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = _keys_cubic(x.astype(f32))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(
        np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
        w / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(in_size - 0.5))
    w = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    return np.ascontiguousarray(w.T)


def jax_resize_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    if in_size == out_size:  # jax skips unchanged dims (identity)
        return torch.eye(in_size, dtype=torch.float32, device=device)
    return torch.from_numpy(jax_resize_weights_np(in_size, out_size)).to(device)


def jax_resize_hw(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, out_h, out_w, C) with jax "cubic" resize."""
    B, H, W, C = x.shape
    if H != out_h:
        wy = jax_resize_weights(H, out_h, x.device)
        x = torch.einsum("yh,bhwc->bywc", wy, x)
    if W != out_w:
        wx = jax_resize_weights(W, out_w, x.device)
        x = torch.einsum("xw,bywc->byxc", wx, x)
    return x


# ----------------------------------------------------------------- (b) PIL

PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


_FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _pil_coeffs(in_size: int, out_size: int, method: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (index (out, ksize) int64, fixed-point weights (out, ksize) int64)."""
    filt, support = _FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    idx = np.zeros((out_size, ksize), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    one = 1 << PRECISION_BITS
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        if ww != 0.0:
            w = [v / ww for v in w]
        for x, v in enumerate(w):
            idx[xx, x] = xmin + x
            kk[xx, x] = int(0.5 + v * one) if v >= 0 else int(-0.5 + v * one)
    return idx, kk


def _pass(img: np.ndarray, out_size: int, axis: int, method: str) -> np.ndarray:
    idx, kk = _pil_coeffs(img.shape[axis], out_size, method)
    src = img.astype(np.int64)
    acc = np.full(
        img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
        1 << (PRECISION_BITS - 1), np.int64,
    )
    shape = [1] * img.ndim
    shape[axis] = out_size
    for t in range(idx.shape[1]):
        acc += np.take(src, idx[:, t], axis=axis) * kk[:, t].reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def pil_resize(img: np.ndarray, size: Tuple[int, int], method: str) -> np.ndarray:
    """PIL ``Image.resize(size=(w, h), BILINEAR|BICUBIC)`` on a uint8 (h, w)
    or (h, w, C) array."""
    out_w, out_h = size
    x = img
    if out_w != x.shape[1]:
        x = _pass(x, out_w, 1, method)
    if out_h != x.shape[0]:
        x = _pass(x, out_h, 0, method)
    return x.copy() if x is img else x


# ----------------------------------------------------------------- (c) PIL
