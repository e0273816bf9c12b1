"""Host-side preprocessing helpers (numpy), ported from
callireader_tpu/vision/preprocess.py without PIL.

Pages arrive as uint8 RGB arrays (``open_image`` reads them from ``.npy``
files, or decodes other image files with PIL where it is installed). Tile-grid selection, the tile/char
buckets, host dynamic tiling (``load_image``, what the server runs per page),
the [200, 350] char-content rule, the reference's whole char-slice pipeline
(``load_char_slice``, normalized by ``to_tensor_normalized`` or kept uint8)
and the host path for crops that would be downscaled live here; every resize is the PIL-compatible antialiased BICUBIC
of vision/resample.py (PIL's default ``resize`` filter).
"""

from __future__ import annotations

import io
import os
from typing import List, Optional, Sequence, Tuple

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


def open_image(image) -> np.ndarray:
    """A page as uint8 (H, W, 3): an array as it is (gray broadcast), a
    ``.npy`` file of one read directly, and any other file, bytes or PIL
    image decoded by PIL, imported here only (the card's machine has none)."""
    if isinstance(image, (str, os.PathLike)) and os.fspath(image).endswith(".npy"):
        return as_rgb_array(np.load(os.fspath(image)))
    if isinstance(image, (str, os.PathLike, bytes)) or hasattr(image, "convert"):
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                f"decoding {image if not isinstance(image, bytes) else 'image bytes'} needs PIL, "
                f"which is not installed; save the page as a uint8 (H, W, 3) .npy array") from e
        if isinstance(image, bytes):
            image = io.BytesIO(image)
        if not hasattr(image, "convert"):
            with Image.open(image) as im:
                return np.asarray(im.convert("RGB"))
        return np.asarray(image.convert("RGB"))
    return as_rgb_array(image)


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


IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def to_tensor_normalized(img: np.ndarray, input_size: int) -> np.ndarray:
    """Bicubic resize -> [0, 1] -> ImageNet normalize. Returns HWC f32."""
    arr = to_tensor_uint8(img, input_size).astype(np.float32) / 255.0
    return (arr - IMAGENET_MEAN) / IMAGENET_STD


def to_tensor_uint8(img: np.ndarray, input_size: int) -> np.ndarray:
    """Bicubic resize to (input_size, input_size), uint8 HWC; ImageNet
    normalization happens on the device (models/internvit)."""
    return resample.pil_resize(as_rgb_array(img), (input_size, input_size), "bicubic")


def dynamic_tile(
    image: np.ndarray,
    min_num: int = 1,
    max_num: int = 12,
    image_size: int = 448,
    use_thumbnail: bool = False,
) -> List[np.ndarray]:
    """Aspect-ratio-aware tiling on the host: bicubic resize to the grid
    ``tile_grid`` picks, row-major split, thumbnail appended for a page of
    more than one tile."""
    oh, ow = image.shape[:2]
    cols, rows = tile_grid(ow, oh, min_num, max_num, image_size)
    resized = resample.pil_resize(image, (image_size * cols, image_size * rows), "bicubic")
    tiles = [
        resized[r * image_size:(r + 1) * image_size, c * image_size:(c + 1) * image_size]
        for r in range(rows) for c in range(cols)
    ]
    if use_thumbnail and len(tiles) != 1:
        tiles.append(resample.pil_resize(image, (image_size, image_size), "bicubic"))
    return tiles


def load_image(
    image, input_size: int = 448, max_num: int = 12, use_thumbnail: bool = True
) -> np.ndarray:
    """Main-image pipeline on the host -> (num_tiles, H, W, 3) uint8."""
    img = as_rgb_array(image)
    tiles = dynamic_tile(img, image_size=input_size, use_thumbnail=use_thumbnail, max_num=max_num)
    return np.stack([to_tensor_uint8(t, input_size) for t in tiles])


def load_char_slice(
    image, input_size: int = 448, max_num: int = 12, as_uint8: bool = False
) -> np.ndarray:
    """Character-crop pipeline (reference load_image_2): scale longest edge into
    [200, 350] (bounds scaled with input_size), center-pad white to input_size,
    then tile (always 1 tile since the padded image is square input_size).
    -> (num_tiles, H, W, C), f32 normalized or uint8 (``as_uint8``)."""
    img = open_image(image)
    h, w = img.shape[:2]
    nw, nh = char_content_dims(w, h, input_size)
    img = resample.pil_resize(img, (nw, nh), "bicubic")
    canvas = np.full((input_size, input_size, 3), 255, np.uint8)
    top, left = (input_size - nh) // 2, (input_size - nw) // 2
    canvas[top:top + nh, left:left + nw] = img
    tiles = dynamic_tile(canvas, image_size=input_size, use_thumbnail=True, max_num=max_num)
    conv = to_tensor_uint8 if as_uint8 else to_tensor_normalized
    return np.stack([conv(t, input_size) for t in tiles])


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
