"""Host-side preprocessing helpers (numpy), ported from
callireader_tpu/vision/preprocess.py without PIL.

Pages arrive as uint8 RGB arrays. Tile-grid selection, the tile/char
buckets, the [200, 350] char-content rule and the host path for crops that
would be downscaled (PIL-compatible antialiased BICUBIC from
vision/resample.py, white-padded to a content canvas) live here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from callireader_tpu_torch.vision import resample

TILE_BUCKETS: Tuple[int, ...] = (1, 2, 3, 4, 5, 7, 9, 13)


def as_rgb_array(image) -> np.ndarray:
    """uint8 (H, W, 3) view of a page given as an array (gray is broadcast).
    The port has no image decoder: callers pass decoded pixels."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise TypeError(f"expected a uint8 image array, got {arr.dtype}")
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=2)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) RGB, got {arr.shape}")
    return arr


def find_closest_aspect_ratio(
    aspect_ratio: float,
    target_ratios: Sequence[Tuple[int, int]],
    width: int,
    height: int,
    image_size: int,
) -> Tuple[int, int]:
    best_diff = float("inf")
    best = (1, 1)
    area = width * height
    for ratio in target_ratios:
        target = ratio[0] / ratio[1]
        diff = abs(aspect_ratio - target)
        if diff < best_diff:
            best_diff = diff
            best = ratio
        elif diff == best_diff:
            if area > 0.5 * image_size * image_size * ratio[0] * ratio[1]:
                best = ratio
    return best


def tile_grid(
    ow: int, oh: int, min_num: int = 1, max_num: int = 12, image_size: int = 448
) -> Tuple[int, int]:
    """The (cols, rows) dynamic-tiling grid for a (ow, oh) page."""
    aspect = ow / oh
    ratios = sorted(
        {
            (i, j)
            for n in range(min_num, max_num + 1)
            for i in range(1, n + 1)
            for j in range(1, n + 1)
            if min_num <= i * j <= max_num
        },
        key=lambda x: x[0] * x[1],
    )
    return find_closest_aspect_ratio(aspect, ratios, ow, oh, image_size)


def char_content_canvas(input_size: int = 448) -> int:
    return max(2, round(350 * input_size / 448))


def char_canvas_buckets(input_size: int = 448) -> Tuple[int, ...]:
    out = []
    for b in (224, 288, 350):
        b = max(2, round(b * input_size / 448))
        if (input_size - b) % 2 != 0:
            b += 1
        out.append(b)
    seen, uniq = set(), []
    for b in out:
        if b not in seen:
            seen.add(b)
            uniq.append(b)
    return tuple(uniq)


def char_content_dims(w: int, h: int, input_size: int = 448) -> Tuple[int, int]:
    """Scaled (nw, nh) of a char crop under the [200, 350] rule."""
    lo = max(1, round(200 * input_size / 448))
    hi = char_content_canvas(input_size)
    m = max(w, h)
    if m <= lo:
        scale = lo / m
    elif m >= hi:
        scale = hi / m
    else:
        scale = 1.0
    return int(w * scale), int(h * scale)


def load_char_content(
    crop: np.ndarray, input_size: int = 448, canvas: Optional[int] = None
) -> np.ndarray:
    """Crop -> PIL-BICUBIC scale under the [200, 350] rule -> white pad to a
    content canvas. Returns (canvas, canvas, 3) uint8."""
    img = as_rgb_array(crop)
    h, w = img.shape[:2]
    nw, nh = char_content_dims(w, h, input_size)
    img = resample.pil_resize(img, (nw, nh), "bicubic")
    if canvas is None:
        hi = char_content_canvas(input_size)
        canvas = hi if (input_size - hi) % 2 == 0 else hi + 1
    if canvas < max(nw, nh) or (input_size - canvas) % 2:
        raise ValueError(f"canvas {canvas} cannot hold a {nw}x{nh} char")
    out = np.full((canvas, canvas, 3), 255, np.uint8)
    top, left = (canvas - nh) // 2, (canvas - nw) // 2
    out[top:top + nh, left:left + nw] = img
    return out


def bucket_tiles(n: int, buckets: Sequence[int] = TILE_BUCKETS) -> int:
    for b in buckets:
        if b >= n:
            return b
    return buckets[-1]


def pad_to_bucket(tiles: np.ndarray, buckets: Sequence[int] = TILE_BUCKETS) -> Tuple[np.ndarray, int]:
    """Zero-pad a stack (N, ...) up to its bucket. Returns (padded, N)."""
    n = tiles.shape[0]
    b = bucket_tiles(n, buckets)
    if b == n:
        return tiles, n
    pad = np.zeros((b - n,) + tiles.shape[1:], tiles.dtype)
    return np.concatenate([tiles, pad], axis=0), n
