"""Tiling grid and char-content rules, a frozen copy of the port's
vision/preprocess.py (its pure-Python part): the plain reference computes
the tile grid and the [200, 350] char scale the same way the served
engine does."""

from __future__ import annotations

from typing import Sequence, Tuple

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
