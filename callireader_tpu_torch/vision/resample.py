"""Image resampling without PIL.

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

(c) The rest of the CalliAlign augmentation's Pillow calls on 8-bit grey
    images, in numpy: ``Image.rotate(angle, BILINEAR, expand=True,
    fillcolor)`` (Pillow's expanded canvas and affine, Geometry.c's bilinear
    sample in float64), ``ImageFilter.MinFilter`` / ``MaxFilter`` (edge
    pixels repeated, as ``Image.expand`` does) and ``GaussianBlur(r)``
    (BoxBlur.c: three passes of the extended box blur a direction, its
    radius and 24-bit fixed-point weights from the float32 arithmetic of
    ``_gaussian_blur_radius``).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from callireader_tpu_torch.utils.profiling import upload

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
    return upload(torch.from_numpy(jax_resize_weights_np(in_size, out_size)), device)


def jax_resize_hw_weights(H: int, W: int, out_h: int, out_w: int, device):
    """(wy, wx) of ``jax_resize_hw`` on the device; None for a dim left
    unchanged."""
    return (None if H == out_h else jax_resize_weights(H, out_h, device),
            None if W == out_w else jax_resize_weights(W, out_w, device))


def jax_resize_hw(x: torch.Tensor, out_h: int, out_w: int, weights=None) -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, out_h, out_w, C) with jax "cubic" resize.
    ``weights``: ``jax_resize_hw_weights``' pair, made beforehand (then the
    call uploads nothing)."""
    B, H, W, C = x.shape
    wy, wx = weights if weights is not None else jax_resize_hw_weights(H, W, out_h, out_w, x.device)
    if wy is not None:
        x = torch.einsum("yh,bhwc->bywc", wy, x)
    if wx is not None:
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


def _affine(x, y, m):
    a, b, c, d, e, f = m
    return a * x + b * y + c, d * x + e * y + f


def pil_rotate(img: np.ndarray, angle: float, fillcolor: int = 255) -> np.ndarray:
    """PIL ``Image.rotate(angle, resample=BILINEAR, expand=True,
    fillcolor=fillcolor)`` on a uint8 (h, w) array."""
    angle = angle % 360.0
    h, w = img.shape
    if angle == 0:
        return img.copy()
    if angle == 180:
        return img[::-1, ::-1].copy()
    if angle in (90, 270):
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]
    m[2], m[5] = _affine(-cx, -cy, m)
    m[2] += cx
    m[5] += cy
    xx, yy = zip(*(_affine(x, y, m) for x, y in ((0, 0), (w, 0), (w, h), (0, h))))
    nw = math.ceil(max(xx)) - math.floor(min(xx))
    nh = math.ceil(max(yy)) - math.floor(min(yy))
    m[2], m[5] = _affine(-(nw - w) / 2.0, -(nh - h) / 2.0, m)
    # every output pixel's source point (pixel centres, float64)
    ox = np.arange(nw, dtype=np.float64)[None, :] + 0.5
    oy = np.arange(nh, dtype=np.float64)[:, None] + 0.5
    xin = m[0] * ox + m[1] * oy + m[2]
    yin = m[3] * ox + m[4] * oy + m[5]
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xs, ys = xin - 0.5, yin - 0.5
    x0, y0 = np.floor(xs).astype(np.int64), np.floor(ys).astype(np.int64)
    dx, dy = xs - x0, ys - y0
    src = img.astype(np.float64)
    xa, xb = np.clip(x0, 0, w - 1), np.clip(x0 + 1, 0, w - 1)
    ya = np.clip(y0, 0, h - 1)
    top = src[ya, xa] + (src[ya, xb] - src[ya, xa]) * dx
    has_next = (y0 + 1 >= 0) & (y0 + 1 < h)
    yb = np.clip(y0 + 1, 0, h - 1)
    bot = np.where(has_next, src[yb, xa] + (src[yb, xb] - src[yb, xa]) * dx, top)
    v = top + (bot - top) * dy
    out = np.full((nh, nw), fillcolor, np.uint8)
    out[inside] = v[inside].astype(np.uint8)  # C's (UINT8) cast truncates
    return out


def pil_rank_filter(img: np.ndarray, size: int, op: str) -> np.ndarray:
    """PIL ``ImageFilter.MinFilter(size)`` (``op="min"``) or
    ``MaxFilter(size)`` (``"max"``) on a uint8 (h, w) array."""
    r = size // 2
    pad = np.pad(img, r, mode="edge")
    h, w = img.shape
    reduce = np.minimum if op == "min" else np.maximum
    out = pad[:h, :w].copy()
    for dy in range(size):
        for dx in range(size):
            out = reduce(out, pad[dy:dy + h, dx:dx + w])
    return out


def _gaussian_box_radius(radius: float, passes: int) -> np.float32:
    """BoxBlur.c's _gaussian_blur_radius, in its float32 / float64 mix."""
    f32 = np.float32
    sigma2 = f32(radius) * f32(radius) / f32(passes)
    L = f32(math.sqrt(12.0 * float(sigma2) + 1.0))
    l = f32(math.floor((float(L) - 1.0) / 2.0))
    a = (f32(2) * l + f32(1)) * (l * (l + f32(1)) - f32(3) * sigma2)
    a = a / (f32(6) * (sigma2 - (l + f32(1)) * (l + f32(1))))
    return f32(l + a)


def _box_blur_rows(a: np.ndarray, radius: np.float32) -> np.ndarray:
    """One horizontal pass of BoxBlur.c's ImagingLineBoxBlur8 over every row
    of the uint8 (h, w) array ``a``."""
    r = int(radius)
    ww = int(np.float32(1 << 24) / (radius * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (r * 2 + 1) * ww) // 2
    h, w = a.shape
    last = w - 1
    # the window of x is [x - r, x + r] and the two far pixels x - r - 1 and
    # x + r + 1, every index clamped into the row (the C loops' edge cases)
    src = a.astype(np.int64)
    cols = np.arange(w)
    acc = np.zeros((h, w), np.int64)
    for t in range(-r, r + 1):
        acc += src[:, np.clip(cols + t, 0, last)]
    far = src[:, np.clip(cols - r - 1, 0, last)] + src[:, np.clip(cols + r + 1, 0, last)]
    bulk = acc * ww + far * fw
    return ((bulk + (1 << 23)) >> 24).astype(np.uint8)


def pil_gaussian_blur(img: np.ndarray, radius: float, passes: int = 3) -> np.ndarray:
    """PIL ``ImageFilter.GaussianBlur(radius)`` on a uint8 (h, w) array."""
    box = _gaussian_box_radius(radius, passes)
    out = img
    if box != 0:
        for _ in range(passes):
            out = _box_blur_rows(out, box)
        out = out.T
        for _ in range(passes):
            out = _box_blur_rows(out, box)
        out = np.ascontiguousarray(out.T)
    return out
