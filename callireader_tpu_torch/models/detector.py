"""YOLOv8-style single-class character detector (PyTorch port of
callireader_tpu/models/detector.py).

CSP backbone + C2f + SPPF + PAN neck + decoupled DFL head, in float32 with
TF32 off (core.dtypes.exact_fp32). Convolutions go to ``F.conv2d`` (the JAX
package left them to XLA, outside Pallas); weights keep the JAX HWIO layout
and JAX's "SAME" padding, which is asymmetric for stride 2 (0 before, 1
after), so it is padded explicitly. Letterboxing is the PIL-compatible
bilinear of vision/resample.py; NMS runs on the host.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from callireader_tpu_torch.core.config import DetectorConfig
from callireader_tpu_torch.core.dtypes import exact_fp32
from callireader_tpu_torch.vision import resample

Params = Dict[str, Any]


def _same_pad(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Pad NCHW like XLA's "SAME": total = max((ceil(n/s)-1)*s + k - n, 0),
    low = total // 2."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: W then H
        out = -(-n // stride)
        total = max((out - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _conv_raw(p, x, stride=1):
    w = p["w"]  # (kh, kw, cin, cout)
    k = w.shape[0]
    y = F.conv2d(_same_pad(x, k, stride), w.permute(3, 2, 0, 1), stride=stride)
    return y + p["b"].reshape(1, -1, 1, 1)


def _conv(p, x, stride=1):
    return F.silu(_conv_raw(p, x, stride))


def _run_c2f(p, x, shortcut):
    y = _conv(p["cv1"], x)
    a, b = y.chunk(2, dim=1)
    outs = [a, b]
    h = b
    for blk in p["blocks"]:
        y2 = _conv(blk["cv2"], _conv(blk["cv1"], h))
        h = h + y2 if shortcut else y2
        outs.append(h)
    return _conv(p["cv2"], torch.cat(outs, dim=1))


def _sppf(p, x):
    y = _conv(p["cv1"], x)
    pools = [y]
    h = y
    for _ in range(3):
        h = F.max_pool2d(h, 5, stride=1, padding=2)
        pools.append(h)
    return _conv(p["cv2"], torch.cat(pools, dim=1))


def _upsample2(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _head_branch(p, x):
    return _conv_raw(p["out"], _conv(p["cv2"], _conv(p["cv1"], x)))


def forward_features(params: Params, x: torch.Tensor):
    """x (B, 3, S, S) float in [0, 1] -> P3, P4, P5 features (NCHW)."""
    b = params["backbone"]
    x = _conv(b["stem"], x, 2)
    x = _conv(b["down1"], x, 2)
    x = _run_c2f(b["c2f1"], x, True)
    x = _conv(b["down2"], x, 2)
    p3 = _run_c2f(b["c2f2"], x, True)
    x = _conv(b["down3"], p3, 2)
    p4 = _run_c2f(b["c2f3"], x, True)
    x = _conv(b["down4"], p4, 2)
    x = _run_c2f(b["c2f4"], x, True)
    p5 = _sppf(b["sppf"], x)
    n = params["neck"]
    u4 = _run_c2f(n["c2f_p4"], torch.cat([_upsample2(p5), p4], dim=1), False)
    u3 = _run_c2f(n["c2f_p3"], torch.cat([_upsample2(u4), p3], dim=1), False)
    d4 = _run_c2f(n["c2f_n4"], torch.cat([_conv(n["down_p3"], u3, 2), u4], dim=1), False)
    d5 = _run_c2f(n["c2f_n5"], torch.cat([_conv(n["down_p4"], d4, 2), p5], dim=1), False)
    return u3, d4, d5


def forward(params: Params, cfg: DetectorConfig, x_nhwc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, S, 3) uint8 letterboxed pages -> (boxes_xyxy (B, N, 4) in
    input px, scores (B, N)) over all N anchor candidates, in the JAX order."""
    with exact_fp32():
        x = x_nhwc.float() / 255.0
        feats = forward_features(params, x.permute(0, 3, 1, 2).contiguous())
        h = params["head"]
        all_boxes, all_scores = [], []
        for feat, name, stride in zip(feats, ("p3", "p4", "p5"), (8, 16, 32)):
            box_logits = _head_branch(h[name]["box"], feat).permute(0, 2, 3, 1)
            cls_logits = _head_branch(h[name]["cls"], feat).permute(0, 2, 3, 1)
            B, Hs, Ws, _ = box_logits.shape
            dist = torch.softmax(box_logits.reshape(B, Hs * Ws, 4, cfg.reg_max), dim=-1)
            bins = torch.arange(cfg.reg_max, dtype=torch.float32, device=x.device)
            ltrb = (dist * bins).sum(dim=-1)
            cy, cx = torch.meshgrid(
                torch.arange(Hs, dtype=torch.float32, device=x.device) + 0.5,
                torch.arange(Ws, dtype=torch.float32, device=x.device) + 0.5,
                indexing="ij",
            )
            centers = torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1)
            x1y1 = (centers - ltrb[..., :2]) * stride
            x2y2 = (centers + ltrb[..., 2:]) * stride
            all_boxes.append(torch.cat([x1y1, x2y2], dim=-1))
            all_scores.append(torch.sigmoid(cls_logits).amax(dim=-1).reshape(B, Hs * Ws))
        return torch.cat(all_boxes, dim=1), torch.cat(all_scores, dim=1)


def nms_numpy(boxes: np.ndarray, scores: np.ndarray, iou_thr: float, max_det: int) -> np.ndarray:
    """Greedy NMS. boxes (N,4) xyxy; returns kept indices."""
    order = scores.argsort()[::-1]
    keep = []
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = np.maximum(0, x2 - x1) * np.maximum(0, y2 - y1)
    while order.size > 0 and len(keep) < max_det:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0, xx2 - xx1) * np.maximum(0, yy2 - yy1)
        iou = inter / np.maximum(areas[i] + areas[order[1:]] - inter, 1e-9)
        order = order[1:][iou <= iou_thr]
    return np.asarray(keep, np.int64)


def letterbox(image: np.ndarray, size: int) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Keep-aspect resize (PIL BILINEAR semantics) + gray pad to (size, size).
    Returns (padded uint8, scale, (pad_x, pad_y))."""
    h, w = image.shape[:2]
    scale = min(size / h, size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    resized = resample.pil_resize(image, (nw, nh), "bilinear")
    out = np.full((size, size, 3), 114, np.uint8)
    px, py = (size - nw) // 2, (size - nh) // 2
    out[py:py + nh, px:px + nw] = resized
    return out, scale, (px, py)


def load_npz(path: str, device) -> Params:
    """Inverse of the JAX package's detector.save_npz ('/'-joined key paths,
    numeric segments are list indices; f16 is storage only -> f32)."""
    data = np.load(path)
    root: Dict[str, Any] = {}
    for key in data.files:
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        a = data[key]
        if a.dtype == np.float16:
            a = a.astype(np.float32)
        node[parts[-1]] = torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def unflatten(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [unflatten(node[k]) for k in sorted(node, key=int)]
        return {k: unflatten(v) for k, v in node.items()}

    return unflatten(root)


class Detector:
    """image array -> list of xyxy boxes, split into dispatch (letterbox +
    upload + forward, no readback), fetch (one readback) and postprocess
    (conf filter + NMS + unletterbox on the host)."""

    def __init__(self, params: Params, cfg: DetectorConfig, device):
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device)

    def __call__(self, image_array: np.ndarray) -> List[List[float]]:
        return self.batch([image_array])[0]

    def dispatch(self, images: List[np.ndarray]):
        metas = [letterbox(im, self.cfg.img_size) for im in images]
        stack = torch.from_numpy(np.stack([m[0] for m in metas])).to(self.device)
        boxes, scores = forward(self.params, self.cfg, stack)
        return boxes, scores, metas

    def fetch(self, handle):
        boxes, scores, metas = handle
        return boxes.cpu().numpy(), scores.cpu().numpy(), metas

    def postprocess(self, images: List[np.ndarray], fetched) -> List[List[List[float]]]:
        cfg = self.cfg
        all_boxes, all_scores, metas = fetched
        out: List[List[List[float]]] = []
        for i, (image_array, (_, scale, (px, py))) in enumerate(zip(images, metas)):
            boxes, scores = all_boxes[i], all_scores[i]
            m = scores >= cfg.conf_threshold
            boxes, scores = boxes[m], scores[m]
            if len(boxes) == 0:
                out.append([])
                continue
            keep = nms_numpy(boxes, scores, cfg.iou_threshold, cfg.max_detections)
            boxes = boxes[keep].copy()
            boxes[:, [0, 2]] = (boxes[:, [0, 2]] - px) / scale
            boxes[:, [1, 3]] = (boxes[:, [1, 3]] - py) / scale
            h, w = image_array.shape[:2]
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
            out.append(boxes.tolist())
        return out

    def batch(self, images: List[np.ndarray]) -> List[List[List[float]]]:
        return self.postprocess(images, self.fetch(self.dispatch(images)))
