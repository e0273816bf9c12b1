"""Box geometry for the slicing priors (host-side numpy), copied from
callireader_tpu/vision/boxes.py.

The port keeps the dependency-free 2-cluster k-means only (no scikit-learn)
and leaves out the OpenCV drawing helper. Order-sensitive sequential code over
a few hundred boxes; it stays on the host.

Box formats: "pair" = [[x1,y1],[x2,y2]]; "flat" = [x1,y1,x2,y2].
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def calculate_iou(box_a: Sequence[float], box_b: Sequence[float], mini: bool = False) -> float:
    xa, ya = max(box_a[0], box_b[0]), max(box_a[1], box_b[1])
    xb, yb = min(box_a[2], box_b[2]), min(box_a[3], box_b[3])
    inter = max(0.0, xb - xa) * max(0.0, yb - ya)
    area_a = (box_a[2] - box_a[0]) * (box_a[3] - box_a[1])
    area_b = (box_b[2] - box_b[0]) * (box_b[3] - box_b[1])
    if mini:
        denom = min(area_a, area_b)
    else:
        denom = area_a + area_b - inter
    return inter / denom if denom > 0 else 0.0


def pair_to_flat(box) -> List[float]:
    return [box[0][0], box[0][1], box[1][0], box[1][1]]


def flat_to_pair(box) -> List[List[float]]:
    return [[box[0], box[1]], [box[2], box[3]]]


def _intersection_length(x1, x3, x2, x4) -> float:
    start, end = max(x1, x2), min(x3, x4)
    return end - start if start < end else 0.0


def _distance_or_intersection(x1, x3, x2, x4) -> float:
    if _intersection_length(x1, x3, x2, x4) > 0:
        return 0.0
    return min(abs(x1 - x4), abs(x2 - x3))


def _union(p1, p2):
    [x1, y1], [x2, y2] = p1
    [x3, y3], [x4, y4] = p2
    return [[min(x1, x3), min(y1, y3)], [max(x2, x4), max(y2, y4)]]


def merge_boxes(boxes: List, thresx: float = 0.7, thresy: float = 2.0) -> List:
    """Iteratively merge character boxes into columns (utils.py:273-331).
    Input/output are pair-format boxes. Mutates a copy."""
    boxes = sorted([b for b in boxes], key=lambda b: (b[0][1] + b[1][1]) / 2)
    now_len = len(boxes)
    for _ in range(10):
        if not boxes:
            break
        ydis_mean = sum(abs(b[0][1] - b[1][1]) for b in boxes) / len(boxes)
        length = len(boxes)
        i = 0
        while i < length:
            j = 0
            while j < length:
                mainbox = boxes[i]
                if i == j:
                    j += 1
                    continue
                length = len(boxes)
                inter = _intersection_length(
                    mainbox[0][0], mainbox[1][0], boxes[j][0][0], boxes[j][1][0]
                )
                wmin = min(abs(mainbox[0][0] - mainbox[1][0]), abs(boxes[j][0][0] - boxes[j][1][0]))
                x_rate = inter / wmin if wmin > 0 else 0.0
                y_dis = _distance_or_intersection(
                    boxes[i][0][1], boxes[i][1][1], boxes[j][0][1], boxes[j][1][1]
                )
                l1 = abs(boxes[i][0][1] - boxes[i][1][1])
                l2 = abs(boxes[j][0][1] - boxes[j][1][1])
                denom = (l1 + l2) / 2
                y_rate = y_dis / denom if denom > 0 else float("inf")
                if x_rate > thresx and y_rate < thresy:
                    rm = boxes[j]
                    boxes[i] = _union(mainbox, rm)
                    boxes.remove(rm)
                    if j < i:
                        i -= 1
                    length -= 1
                    j -= 1
                j += 1
            i += 1
        if now_len == len(boxes):
            break
        now_len = len(boxes)
    return boxes


def _dedup_boxes_iou_loop(boxes: List, threshold: float = 0.8) -> List:
    """The reference's literal pop-in-place loop
    (modeling_internvl_chat.py:374-392) — kept as the behavioral spec for
    the vectorized path's equivalence test (tests/test_boxes_metrics.py)."""
    boxes = list(boxes)
    i = 0
    length = len(boxes)
    while i < length:
        j = 0
        main_box = boxes[i]
        while j < length:
            if i == j:
                j += 1
                continue
            iou = calculate_iou(pair_to_flat(main_box), pair_to_flat(boxes[j]))
            if iou > threshold:
                boxes.pop(j)
                if j < i:
                    i -= 1
                length -= 1
                j -= 1
            j += 1
        i += 1
    return boxes


def dedup_boxes_iou(boxes: List, threshold: float = 0.8) -> List:
    """Remove near-duplicate detections (modeling_internvl_chat.py:374-392).
    Pair-format boxes; keeps the first of each duplicate cluster.

    Equivalent greedy form of the reference's O(n^2) pop-in-place Python
    loop: a box survives iff its IoU with every EARLIER survivor is <=
    threshold. (When box i becomes the loop's main box, no earlier survivor
    j<i can exceed the threshold against it — IoU is symmetric, so that pair
    was already resolved when j was main and i was still present.) The
    survivor test vectorizes over the kept set in float64 numpy — bit-equal
    IoUs to the Python-float loop — cutting the per-batch host cost of
    columns_stage ~20x at detector box counts (~150/page)."""
    boxes = list(boxes)
    if len(boxes) <= 1:
        return boxes
    flat = np.asarray([pair_to_flat(b) for b in boxes], np.float64)
    areas = (flat[:, 2] - flat[:, 0]) * (flat[:, 3] - flat[:, 1])
    kept: List[int] = []
    for i in range(len(boxes)):
        if kept:
            k = flat[kept]
            xa = np.maximum(k[:, 0], flat[i, 0])
            ya = np.maximum(k[:, 1], flat[i, 1])
            xb = np.minimum(k[:, 2], flat[i, 2])
            yb = np.minimum(k[:, 3], flat[i, 3])
            inter = np.maximum(0.0, xb - xa) * np.maximum(0.0, yb - ya)
            denom = areas[kept] + areas[i] - inter
            with np.errstate(divide="ignore", invalid="ignore"):
                iou = np.where(denom > 0, inter / denom, 0.0)
            if bool((iou > threshold).any()):
                continue
        kept.append(i)
    return [boxes[i] for i in kept]


def most_frequent_rgb_fast(
    image_array: np.ndarray, max_samples: int = 1 << 16
) -> Tuple[int, int, int]:
    """Most frequent RGB (mask-fill color, utils.py:98-110). Small images
    get the reference's exact full-image mode; large ones are strided-
    subsampled (>= max_samples pixels kept) — the fill color is the page
    background, which dominates any uniform sample, so a ~2s/page host cost
    becomes ~2ms. Subsampled mode is computed on a coarse (>>2 per channel)
    color grid first so near-tie shades of the same background hue cannot
    flip the winner, then the exact mode within the winning coarse cell."""
    h, w = image_array.shape[:2]
    stride = max(1, int(np.sqrt(h * w / max_samples)))
    flat = image_array[::stride, ::stride].reshape(-1, 3)
    rgb = (
        flat[:, 0].astype(np.uint32) << 16
    ) | (flat[:, 1].astype(np.uint32) << 8) | flat[:, 2].astype(np.uint32)
    if stride == 1:  # exact: every pixel counted, plain mode
        vals, counts = np.unique(rgb, return_counts=True)
        m = int(vals[np.argmax(counts)])
        return ((m >> 16) & 255, (m >> 8) & 255, m & 255)
    coarse = rgb & 0x00FCFCFC  # drop 2 LSBs per channel: 64-level grid
    cvals, ccounts = np.unique(coarse, return_counts=True)
    win = cvals[np.argmax(ccounts)]
    vals, counts = np.unique(rgb[coarse == win], return_counts=True)
    m = int(vals[np.argmax(counts)])
    return ((m >> 16) & 255, (m >> 8) & 255, m & 255)


def mask_area(image_array: np.ndarray, coords: Sequence[Sequence[int]], color) -> np.ndarray:
    for x1, y1, x2, y2 in coords:
        image_array[y1:y2, x1:x2] = color
    return image_array


def half_divide(image: np.ndarray, data: Dict) -> List:
    """Split a page vertically, masking characters the cut crosses
    (utils.py:96-129). ``data`` is labelme-style with absolute 'points'.
    Returns [left_img, left_data, right_img, right_data]."""
    h, w = image.shape[:2]
    split = w // 2
    color = most_frequent_rgb_fast(image)
    modified = image.copy()
    left = {"shapes": [], "imageHeight": data["imageHeight"], "imageWidth": data["imageWidth"] // 2}
    right = {"shapes": [], "imageHeight": data["imageHeight"], "imageWidth": data["imageWidth"] // 2}
    to_mask = []
    for item in data["shapes"]:
        pts = item["points"]
        if len(pts) != 2 or len(pts[0]) != 2 or len(pts[1]) != 2:
            continue
        (x1, y1), (x2, y2) = pts
        if x2 < split:
            left["shapes"].append({"points": [[x1, y1], [x2, y2]]})
        elif x1 > split:
            right["shapes"].append({"points": [[x1 - split, y1], [x2 - split, y2]]})
        else:
            to_mask.append([x1, y1, x2, y2])
    for x1, y1, x2, y2 in to_mask:
        modified[int(y1):int(y2), int(x1):int(x2)] = color
    return [modified[:, :split], left, modified[:, split:], right]


def refine(image: np.ndarray, data: Dict, max_chars: int = 300) -> List[Tuple[np.ndarray, Dict]]:
    """Recursively half-divide until every sub-page holds < max_chars
    character boxes (utils.py:131-167). Returns [(sub_image, sub_data), ...]."""
    if len(data["shapes"]) < max_chars:
        return [(image, data)]
    li, ld, ri, rd = half_divide(image, data)
    subs = [(li, ld), (ri, rd)]
    i = 0
    while i < len(subs):
        img, d = subs[i]
        if len(d["shapes"]) >= max_chars:
            subs.pop(i)
            a, ad, b, bd = half_divide(img, d)
            subs.append((a, ad))
            subs.append((b, bd))
            i -= 1
        i += 1
    return subs


def _area_kmeans_1d(areas: np.ndarray) -> np.ndarray:
    """Deterministic 2-cluster k-means on areas (Lloyd iterations from the
    min/max seeds)."""
    a = areas.reshape(-1)
    c0, c1 = a.min(), a.max()
    labels = np.zeros_like(a, dtype=np.int64)
    for _ in range(50):
        labels = (np.abs(a - c1) < np.abs(a - c0)).astype(np.int64)
        n0, n1 = (labels == 0).sum(), (labels == 1).sum()
        nc0 = a[labels == 0].mean() if n0 else c0
        nc1 = a[labels == 1].mean() if n1 else c1
        if nc0 == c0 and nc1 == c1:
            break
        c0, c1 = nc0, nc1
    return labels


def kmeans_split(normalized_boxes: List) -> Tuple[List, List]:
    """Area-based split into signature (group_0) and main text (group_1) with
    the reference's reassignment heuristics (modeling_internvl_chat.py:397-469).
    Input pair-format boxes normalized to [0,1]."""
    areas = np.array(
        [(b[1][0] - b[0][0]) * (b[1][1] - b[0][1]) for b in normalized_boxes], np.float64
    )
    labels = _area_kmeans_1d(areas)
    group_0 = [b for b, l in zip(normalized_boxes, labels) if l == 0]
    group_1 = [b for b, l in zip(normalized_boxes, labels) if l == 1]
    group_0.sort(key=lambda x: (x[1][0] - x[0][0]), reverse=True)
    group_1.sort(key=lambda x: (x[1][0] - x[0][0]), reverse=True)
    areas_col = areas.reshape(-1, 1)

    def reassign(big: List, small: List) -> Tuple[List, List]:
        # move entries of `small` that look like main text into `big`
        g_hs = float(np.mean([x[1][1] - x[0][1] for x in big]))
        thr1 = 1.0 * (big[-1][1][0] - big[-1][0][0])
        thr2 = 0.8 * g_hs
        new_small = []
        for ele in small:
            w = ele[1][0] - ele[0][0]
            h = ele[1][1] - ele[0][1]
            area = w * h
            cond3 = (
                area > 0
                and areas_col.min() / area <= 1 / 5
                and areas_col.mean() / area <= 1.3
            )
            if w >= thr1 or h >= thr2 or cond3:
                big.append(ele)
            else:
                new_small.append(ele)
        grouped = merge_boxes([list(map(list, e)) for e in new_small])
        final = []
        for ele in new_small:
            if ele in grouped:
                big.append(ele)
            else:
                final.append(ele)
        return big, final

    if group_1 and group_0 and (group_1[0][1][0] - group_1[0][0][0]) > (group_0[0][1][0] - group_0[0][0][0]):
        group_1, group_0 = reassign(group_1, group_0)
    elif group_0 and group_1 and (group_0[0][1][0] - group_0[0][0][0]) > (group_1[0][1][0] - group_1[0][0][0]):
        group_0, group_1 = reassign(group_0, group_1)
    return group_0, group_1


def char2col_with_kmeans(boxes: List, width: int, height: int) -> Dict:
    """Group character boxes into ordered-reading columns, splitting main text
    from signature when area variance is high
    (modeling_internvl_chat.py:395-533). Returns labelme-style dict."""
    normalized = [
        [[b[0][0] / width, b[0][1] / height], [b[1][0] / width, b[1][1] / height]]
        for b in boxes
    ]
    S = np.array([(b[0][0] - b[1][0]) * (b[0][1] - b[1][1]) for b in normalized], np.float64)
    boxes2class = col2class = None
    coef_var = float(np.std(S) / np.mean(S)) if len(S) and np.mean(S) != 0 else 0.0

    def toint(lst):
        if len(lst) == 2:
            return [[int(lst[0][0]), int(lst[0][1])], [int(lst[1][0]), int(lst[1][1])]]
        return [int(v) for v in lst]

    if coef_var > 0.66 and len(S) >= 2 and S.min() / S.mean() <= 1 / 8:
        b1, b2 = kmeans_split(normalized)
        b1 = [[[e[0][0] * width, e[0][1] * height], [e[1][0] * width, e[1][1] * height]] for e in b1]
        b2 = [[[e[0][0] * width, e[0][1] * height], [e[1][0] * width, e[1][1] * height]] for e in b2]
        cols1 = merge_boxes([list(map(list, e)) for e in b1])
        cols2 = merge_boxes([list(map(list, e)) for e in b2])
        columns = cols1 + cols2
        boxes2class = {1: [toint(e) for e in b1], 2: [toint(e) for e in b2]}
        col2class = {1: [toint(e) for e in cols1], 2: [toint(e) for e in cols2]}
    else:
        columns = merge_boxes([list(map(list, b)) for b in boxes])

    return {
        "imageHeight": height,
        "imageWidth": width,
        "shapes": [{"points": toint(col)} for col in columns],
        "boxes2class": boxes2class,
        "col2class": col2class,
    }
