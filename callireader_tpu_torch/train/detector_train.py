"""Character-detector training: anchor-free assignment + BCE/DFL loss
(PyTorch port of callireader_tpu/train/detector_train.py).

The reference trains its YOLO character detector externally through
ultralytics (inference.py:98 only loads ``best.pt``); the port trains the
YOLOv8-style detector of models/detector.py itself, on synthetic calligraphy
pages made with numpy ``RandomState`` (byte for byte the JAX package's).

Assignment (per scale, stride s):
  an anchor (cell centre) is positive for a GT box iff the centre lies
  inside the box AND all four ltrb distances are representable by this
  scale's DFL bins (< reg_max - 1 stride units): the scale range falls out
  of the distribution support. Ties pick the smallest GT.
Loss:
  cls: sigmoid BCE over every anchor (positives = 1), normalised by #pos
  box: distribution focal loss (CE against the two neighbouring integer bins
  of each ltrb target) on positive anchors.
The step runs in float32 with TF32 off (core.dtypes.exact_fp32), its
backward too; the optimizer is the port's own (train/e_it.Optimizer): clip by
global norm, then AdamW under a warmup-cosine schedule. Convolutions go to
cuDNN, as JAX leaves them to XLA.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from callireader_tpu_torch.core.config import DetectorConfig
from callireader_tpu_torch.core.dtypes import exact_fp32
from callireader_tpu_torch.models import detector as det
from callireader_tpu_torch.train import e_it

# the reference's fixture page and its labelme boxes (examples/0.jpg, 0.json),
# read from the root of the repository where it is placed
FIXTURE_DIR = Path(__file__).resolve().parents[2] / "examples"
FIXTURE_IMG = FIXTURE_DIR / "0.jpg"
FIXTURE_JSON = FIXTURE_DIR / "0.json"


@dataclasses.dataclass(frozen=True)
class DetTrainConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 5e-4
    total_steps: int = 500
    warmup: int = 20
    grad_clip: float = 10.0
    box_weight: float = 1.0
    cls_weight: float = 1.0


def _scale_targets(gt_boxes, gt_mask, Hs, Ws, stride, reg_max):
    """-> (pos (B, N) bool, ltrb_tgt (B, N, 4) stride units). N = Hs * Ws."""
    dev = gt_boxes.device
    cy, cx = torch.meshgrid(
        (torch.arange(Hs, dtype=torch.float32, device=dev) + 0.5) * stride,
        (torch.arange(Ws, dtype=torch.float32, device=dev) + 0.5) * stride,
        indexing="ij",
    )
    centers = torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1)  # (N, 2) px
    # ltrb of every (anchor, gt) pair, in stride units: (B, N, M, 4)
    lt = centers[None, :, None, :] - gt_boxes[:, None, :, :2]
    rb = gt_boxes[:, None, :, 2:] - centers[None, :, None, :]
    ltrb = torch.cat([lt, rb], dim=-1) / stride
    inside = (ltrb > 0).all(dim=-1)
    fits = ltrb.amax(dim=-1) < (reg_max - 1.01)
    valid = inside & fits & gt_mask[:, None, :]
    area = (gt_boxes[..., 2] - gt_boxes[..., 0]) * (gt_boxes[..., 3] - gt_boxes[..., 1])
    cost = torch.where(valid, area[:, None, :], torch.full_like(area[:, None, :], float("inf")))
    best = cost.argmin(dim=-1)  # (B, N), the first of equal costs
    pos = valid.any(dim=-1)
    B, N = best.shape
    tgt = ltrb.gather(2, best[:, :, None, None].expand(B, N, 1, 4))[:, :, 0]
    return pos, tgt


def _dfl(dist_logits, target, reg_max):
    """dist_logits (B, N, 4, reg_max); target (B, N, 4) in [0, reg_max - 1)."""
    t = target.clamp(0.0, reg_max - 1.001)
    li = t.floor().long()
    wl = (li + 1).float() - t
    wr = 1.0 - wl
    logp = torch.log_softmax(dist_logits.float(), dim=-1)
    pl = logp.gather(-1, li[..., None])[..., 0]
    pr = logp.gather(-1, (li + 1)[..., None])[..., 0]
    return -(wl * pl + wr * pr).mean(dim=-1)  # (B, N)


def _sigmoid_bce(logits, labels):
    """optax.sigmoid_binary_cross_entropy."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


def detector_loss(params, cfg: DetectorConfig, images, gt_boxes, gt_mask,
                  train_cfg: DetTrainConfig = DetTrainConfig()):
    """images (B, S, S, 3) in [0, 1] f32 (or uint8, normalised here so that
    page banks upload and store 4x smaller); gt_boxes (B, M, 4) xyxy px;
    gt_mask (B, M) -> (loss, {"loss", "n_pos", "cls", "box"})."""
    raw = det.forward_raw(params, cfg, images)
    cls_loss = box_loss = n_pos_total = 0.0
    for box_logits, cls_logits, stride in raw:
        B, Hs, Ws, _ = box_logits.shape
        pos, tgt = _scale_targets(gt_boxes, gt_mask, Hs, Ws, stride, cfg.reg_max)
        n_pos_total = n_pos_total + pos.sum()
        cls = cls_logits.reshape(B, Hs * Ws, cfg.num_classes).float()
        cls_loss = cls_loss + _sigmoid_bce(cls, pos.float()[..., None]).mean(dim=-1).sum()
        dfl = _dfl(box_logits.reshape(B, Hs * Ws, 4, cfg.reg_max), tgt, cfg.reg_max)
        box_loss = box_loss + torch.where(pos, dfl, torch.zeros_like(dfl)).sum()
    denom = n_pos_total.clamp(min=1).float()
    loss = train_cfg.cls_weight * cls_loss / denom + train_cfg.box_weight * box_loss / denom
    return loss, {"loss": loss, "n_pos": n_pos_total, "cls": cls_loss / denom,
                  "box": box_loss / denom}


def make_optimizer(train_cfg: DetTrainConfig) -> e_it.Optimizer:
    """clip_by_global_norm(grad_clip), then AdamW (eps 1e-8) under
    optax.warmup_cosine_decay_schedule(0, lr, warmup, total_steps)."""
    warmup = min(train_cfg.warmup, max(1, train_cfg.total_steps // 5))
    return e_it.Optimizer(
        e_it.warmup_cosine_schedule(train_cfg.learning_rate, warmup, train_cfg.total_steps),
        eps=1e-8, weight_decay=train_cfg.weight_decay, grad_clip=train_cfg.grad_clip)


def make_train_step(cfg: DetectorConfig, train_cfg: DetTrainConfig, tx: e_it.Optimizer):
    """``step(params, opt_state, images, gt_boxes, gt_mask) -> (params,
    opt_state, metrics)``; the leaves of ``params`` (each ``requires_grad``:
    ``e_it.clone_tree(tree, True)``) are updated in place."""

    def step(params, opt_state, images, gt_boxes, gt_mask):
        flat = e_it.flatten(params)
        with exact_fp32():
            loss, metrics = detector_loss(params, cfg, images, gt_boxes, gt_mask, train_cfg)
            grads = torch.autograd.grad(loss, list(flat.values()))
            tx.update(dict(zip(flat, grads)), opt_state, flat)
        return params, opt_state, {k: v.detach() for k, v in metrics.items()}

    return step


# ---------------------------------------------------------------------------
# synthetic calligraphy pages (training data without the private dataset;
# numpy only, the JAX package's generators unchanged)
# ---------------------------------------------------------------------------


def synth_pages(
    rng: np.random.RandomState, batch: int, size: int, max_boxes: int = 16,
    min_chars: int = 4,
):
    """Random ink-glyph pages like the CalliBench layout: paper background,
    dark multi-stroke glyphs in loose columns. Returns (images (B,S,S,3) f32
    [0,1], gt (B,M,4) xyxy px, mask (B,M))."""
    imgs = np.empty((batch, size, size, 3), np.float32)
    gt = np.zeros((batch, max_boxes, 4), np.float32)
    mask = np.zeros((batch, max_boxes), bool)
    for b in range(batch):
        page = np.full((size, size, 3), 235, np.uint8)
        page += rng.randint(0, 18, page.shape).astype(np.uint8)
        n = rng.randint(min_chars, max_boxes + 1)
        placed = 0
        for _ in range(n * 3):
            if placed >= n:
                break
            w = rng.randint(size // 12, size // 5)
            h = rng.randint(size // 12, size // 5)
            x0 = rng.randint(0, size - w)
            y0 = rng.randint(0, size - h)
            box = np.array([x0, y0, x0 + w, y0 + h], np.float32)
            # reject overlaps so GT boxes stay unambiguous
            if placed and (
                np.maximum(0, np.minimum(gt[b, :placed, 2], box[2]) - np.maximum(gt[b, :placed, 0], box[0]))
                * np.maximum(0, np.minimum(gt[b, :placed, 3], box[3]) - np.maximum(gt[b, :placed, 1], box[1]))
            ).max() > 0:
                continue
            glyph = np.full((h, w, 3), 245, np.uint8)
            for _s in range(5):
                sx, sy = rng.randint(0, max(1, w - 6)), rng.randint(0, max(1, h - 6))
                glyph[sy: sy + rng.randint(3, h - sy + 1), sx: sx + max(2, w // 8)] = rng.randint(10, 70)
                glyph[sy: sy + max(2, h // 8), sx: sx + rng.randint(3, w - sx + 1)] = rng.randint(10, 70)
            page[y0:y0 + h, x0:x0 + w] = glyph
            gt[b, placed] = box
            mask[b, placed] = True
            placed += 1
        imgs[b] = page.astype(np.float32) / 255.0
    return imgs, gt, mask


def _paint_strokes(
    mask: np.ndarray,
    rng: np.random.RandomState,
    n_strokes: int,
    x_lo: float,
    x_hi: float,
    y_lo: float,
    y_hi: float,
) -> None:
    """Paint bezier brush strokes confined to a sub-window of ``mask``."""
    s = mask.shape[0]
    yy, xx = np.mgrid[0:s, 0:s]
    span = np.array([x_hi - x_lo, y_hi - y_lo])
    org = np.array([x_lo, y_lo])
    for _ in range(n_strokes):
        p0 = (org + rng.uniform(0.05, 0.95, 2) * span) * s
        p1 = (org + rng.uniform(-0.2, 1.2, 2) * span) * s
        p2 = (org + rng.uniform(0.05, 0.95, 2) * span) * s
        r = rng.uniform(0.03, 0.09) * s + 0.6
        t = np.linspace(0, 1, max(8, int(2.5 * s)))[:, None]
        pts = ((1 - t) ** 2) * p0 + 2 * t * (1 - t) * p1 + (t**2) * p2
        pts = pts.clip(0, s - 1)
        # paint disks along the curve (vectorized per-point bounding windows)
        for cx, cy in pts[:: max(1, len(pts) // 40)]:
            x0, x1 = int(max(0, cx - r)), int(min(s, cx + r + 1))
            y0, y1 = int(max(0, cy - r)), int(min(s, cy + r + 1))
            d2 = (xx[y0:y1, x0:x1] - cx) ** 2 + (yy[y0:y1, x0:x1] - cy) ** 2
            mask[y0:y1, x0:x1] = np.maximum(
                mask[y0:y1, x0:x1], (d2 <= r * r).astype(np.float32)
            )


def make_glyph(rng: np.random.RandomState, s: int) -> np.ndarray:
    """Brush-stroke glyph: quadratic bezier strokes with varying thickness,
    rasterized into an (s, s) ink mask in [0, 1]. Half the glyphs are
    COMPOSITIONAL — two stroke clusters separated by an internal whitespace
    gap (left/right or top/bottom radicals), like real hanzi. Without the
    gap structure the detector learns "one connected ink blob = one char"
    and fragments real multi-radical characters into duplicate sub-boxes
    (measured on examples/0.jpg: 24/114 preds were within-char fragments,
    precision capped at 0.79 across every conf threshold)."""
    mask = np.zeros((s, s), np.float32)
    n = rng.randint(3, 8)
    split = rng.rand()
    if split < 0.25:  # left/right radicals with a vertical whitespace gap
        cut = rng.uniform(0.35, 0.65)
        gap = rng.uniform(0.04, 0.14)
        _paint_strokes(mask, rng, max(2, n // 2), 0.0, cut - gap / 2, 0.0, 1.0)
        _paint_strokes(mask, rng, max(2, n - n // 2), cut + gap / 2, 1.0, 0.0, 1.0)
    elif split < 0.5:  # top/bottom stack with a horizontal gap
        cut = rng.uniform(0.35, 0.65)
        gap = rng.uniform(0.04, 0.14)
        _paint_strokes(mask, rng, max(2, n // 2), 0.0, 1.0, 0.0, cut - gap / 2)
        _paint_strokes(mask, rng, max(2, n - n // 2), 0.0, 1.0, cut + gap / 2, 1.0)
    else:
        _paint_strokes(mask, rng, n, 0.0, 1.0, 0.0, 1.0)
    return mask


def make_glyph_bank(
    rng: np.random.RandomState, n: int = 200, size: int = 48
) -> np.ndarray:
    return np.stack([make_glyph(rng, size) for _ in range(n)])


def synth_calligraphy_pages(
    rng: np.random.RandomState,
    batch: int,
    size: int,
    max_boxes: int = 128,
    glyph_bank: np.ndarray = None,
):
    """Letterboxed portrait calligraphy pages at fixture statistics
    (examples/0.jpg: 788x2000 page, 6 columns, ~73 px chars -> ~23 px after
    the Detector's 640 letterbox): bright paper with texture, brush-stroke
    glyph columns (jittered size/position), red seal distractors that are
    NOT ground truth. Returns (imgs (B,S,S,3) uint8, gt (B,M,4) xyxy px,
    mask (B,M))."""
    if glyph_bank is None:
        glyph_bank = make_glyph_bank(rng)
    gs = glyph_bank.shape[1]
    imgs = np.empty((batch, size, size, 3), np.uint8)
    gt = np.zeros((batch, max_boxes, 4), np.float32)
    mask = np.zeros((batch, max_boxes), bool)
    for b in range(batch):
        canvas = np.full((size, size, 3), 114, np.uint8)  # letterbox gray
        aspect = rng.uniform(0.33, 0.55)  # portrait content region
        cw = int(size * aspect)
        x_off = (size - cw) // 2
        paper = rng.randint(228, 250)
        page = np.full((size, cw, 3), paper, np.int16)
        page += rng.randint(-8, 9, page.shape).astype(np.int16)  # texture
        n_cols = rng.randint(4, 8)
        col_w = cw / (n_cols + rng.uniform(0.5, 1.5))
        s0 = col_w * rng.uniform(0.55, 0.85)  # base char size, px
        placed = 0
        for c in range(n_cols):
            # right-to-left column order like the fixture
            x_c = cw - (c + 1) * col_w + rng.uniform(-2, 2)
            y = rng.uniform(0.02, 0.12) * size
            while y < size * rng.uniform(0.75, 0.98) and placed < max_boxes:
                s = int(np.clip(s0 * rng.uniform(0.6, 1.35), 6, 60))
                # rectangular chars: the fixture's labelme boxes span aspects
                # ~0.5-1.4 (median 76x74 but e.g. 48x25, 63x96); square-only
                # training biases the regressor toward square extents
                sh = int(np.clip(s * rng.uniform(0.65, 1.3), 6, 60))
                sw = s
                x0 = int(np.clip(x_c + rng.uniform(-0.15, 0.15) * col_w, 0, cw - sw))
                y0 = int(y)
                if y0 + sh >= size:
                    break
                g = glyph_bank[rng.randint(len(glyph_bank))]
                if (sh, sw) != (gs, gs):
                    iy = (np.arange(sh) * gs // sh).clip(0, gs - 1)
                    ix = (np.arange(sw) * gs // sw).clip(0, gs - 1)
                    g = g[iy][:, ix]
                ink = rng.randint(5, 80)
                region = page[y0 : y0 + sh, x0 : x0 + sw]
                region[:] = (region * (1 - g[..., None]) + ink * g[..., None]).astype(np.int16)
                gt[b, placed] = [x_off + x0, y0, x_off + x0 + sw, y0 + sh]
                mask[b, placed] = True
                placed += 1
                y += sh * rng.uniform(1.02, 1.35)
        # red seal distractors (stamps are not characters)
        for _ in range(rng.randint(0, 3)):
            ss = int(s0 * rng.uniform(0.6, 1.2))
            sx = rng.randint(0, max(1, cw - ss))
            sy = rng.randint(0, max(1, size - ss))
            seal = np.array([rng.randint(150, 210), rng.randint(25, 60), rng.randint(35, 70)])
            blob = rng.rand(ss, ss) > 0.45
            page[sy : sy + ss, sx : sx + ss][blob] = seal
        canvas[:, x_off : x_off + cw] = page.clip(0, 255).astype(np.uint8)
        imgs[b] = canvas
    return imgs, gt, mask


def _iou_matrix(pred: np.ndarray, gts: np.ndarray) -> np.ndarray:
    x1 = np.maximum(pred[:, None, 0], gts[None, :, 0])
    y1 = np.maximum(pred[:, None, 1], gts[None, :, 1])
    x2 = np.minimum(pred[:, None, 2], gts[None, :, 2])
    y2 = np.minimum(pred[:, None, 3], gts[None, :, 3])
    inter = np.maximum(0, x2 - x1) * np.maximum(0, y2 - y1)
    area_p = (pred[:, 2] - pred[:, 0]) * (pred[:, 3] - pred[:, 1])
    area_g = (gts[:, 2] - gts[:, 0]) * (gts[:, 3] - gts[:, 1])
    return inter / np.maximum(area_p[:, None] + area_g[None, :] - inter, 1e-9)


def _device(params):
    return params["backbone"]["stem"]["w"].device


@torch.no_grad()
def fixture_recall(params, cfg: DetectorConfig, image_path=FIXTURE_IMG, json_path=FIXTURE_JSON,
                   iou_thr: float = 0.5):
    """recall / precision @ IoU of the full Detector pipeline against the
    reference fixture's labelme GT boxes (inference.py:98 deployment check)
    -> (recall, precision, n_pred). Raises FileNotFoundError where the
    fixture is not in the repository; decodes the page with Pillow."""
    for path in (image_path, json_path):
        if not os.path.exists(path):
            raise FileNotFoundError(f"the detector fixture {path} is not in the repository")
    from PIL import Image

    img = np.asarray(Image.open(image_path).convert("RGB"))
    H, W = img.shape[:2]
    with open(json_path) as f:
        d = json.load(f)
    gts = np.array(
        [[p["points"][0][0] * W, p["points"][0][1] * H,
          p["points"][1][0] * W, p["points"][1][1] * H] for p in d["shapes"]],
        np.float32,
    )
    pred = det.Detector(params, cfg, _device(params))(img)
    if not pred:
        return 0.0, 0.0, 0
    iou = _iou_matrix(np.asarray(pred, np.float32), gts)
    recall = float((iou.max(axis=0) >= iou_thr).mean())
    precision = float((iou.max(axis=1) >= iou_thr).mean())
    return recall, precision, len(pred)


@torch.no_grad()
def detection_recall(params, cfg: DetectorConfig, image01: np.ndarray, gt_boxes: np.ndarray,
                     iou_thr: float = 0.5) -> float:
    """Fraction of GT boxes matched (IoU >= thr) by the Detector's full
    pipeline (forward + threshold + NMS) on one image in [0, 1]."""
    pred = det.Detector(params, cfg, _device(params))((image01 * 255).astype(np.uint8))
    if not pred:
        return 0.0
    iou = _iou_matrix(np.asarray(pred), np.asarray(gt_boxes))
    return float((iou.max(axis=0) >= iou_thr).sum()) / len(gt_boxes)
