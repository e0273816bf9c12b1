"""OrderFormer reading-order regressor (PyTorch port of
callireader_tpu/models/orderformer.py).

Linear(4 -> E) embed, post-LN encoder layers (torch TransformerEncoderLayer
semantics: ReLU FFN, no padding mask over the 50 box slots), Linear(E -> 1)
rank scores, in float32 with full-precision matmuls. The host half (input
normalisation, double-argsort rank decode, the sliding-window-of-3 row
re-permutation) is copied unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from callireader_tpu_torch.core.config import OrderFormerConfig
from callireader_tpu_torch.core.dtypes import FP32_POLICY, exact_fp32
from callireader_tpu_torch.models.internvit import layer_norm

Params = Dict[str, Any]
LN_EPS = 1e-5


def forward(params: Params, cfg: OrderFormerConfig, x: torch.Tensor) -> torch.Tensor:
    """x (B, max_boxes, 4) -> rank scores (B, max_boxes, 1), fp32."""
    with exact_fp32():
        x = x.float()
        B, S, _ = x.shape
        H, E = cfg.num_heads, cfg.model_dim
        Dh = E // H
        x = x @ params["embed_kernel"] + params["embed_bias"]
        lp = params["layers"]
        for i in range(cfg.num_layers):
            qkv = x @ lp["in_proj_kernel"][i] + lp["in_proj_bias"][i]
            q, k, v = (t.reshape(B, S, H, Dh).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
            a = torch.softmax((q @ k.transpose(-1, -2)) / (Dh**0.5), dim=-1)
            ctx = (a @ v).transpose(1, 2).reshape(B, S, E)
            ctx = ctx @ lp["out_proj_kernel"][i] + lp["out_proj_bias"][i]
            x = layer_norm(x + ctx, lp["norm1_scale"][i], lp["norm1_bias"][i], LN_EPS, FP32_POLICY)
            h = torch.relu(x @ lp["ff1_kernel"][i] + lp["ff1_bias"][i])
            h = h @ lp["ff2_kernel"][i] + lp["ff2_bias"][i]
            x = layer_norm(x + h, lp["norm2_scale"][i], lp["norm2_bias"][i], LN_EPS, FP32_POLICY)
        return x @ params["decode_kernel"] + params["decode_bias"]


# ---------------------------------------------------------------------------
# host-side predict pipeline (copied)
# ---------------------------------------------------------------------------


def _decode_ranks(scores: np.ndarray, n: int) -> np.ndarray:
    """models/model.py:327-332 — double argsort => 1-based ranks."""
    flat = scores.reshape(-1)[:n]
    order = np.argsort(flat, kind="stable")
    ranks = np.argsort(order, kind="stable")
    return ranks + 1


def _ordered_permute(b1, b2, b3):
    """models/model.py:493-513 — right-to-left x order when three boxes sit on
    one visual row of similar size, else keep order."""
    hs = [b1[3] - b1[1], b2[3] - b2[1], b3[3] - b3[1]]
    c = [[(b[0] + b[2]) / 2, (b[1] + b[3]) / 2] for b in (b1, b2, b3)]
    s = [(b[2] - b[0]) * (b[3] - b[1]) for b in (b1, b2, b3)]
    ymax_diff = max(
        abs(c[0][1] - c[1][1]), abs(c[0][1] - c[2][1]), abs(c[1][1] - c[2][1])
    )
    if ymax_diff < min(hs) and (max(s) > 0 and min(s) / max(s) > 0.7):
        vals = [c[0][0], c[1][0], c[2][0]]
    else:
        vals = [3, 2, 1]
    idx = sorted(range(3), key=lambda i: vals[i], reverse=True)
    return idx


def postprocess(results: Dict[int, List[float]], width: float, height: float) -> Dict[int, List[float]]:
    """Sliding-window-of-3 re-permutation (models/model.py:492-526)."""
    keys = list(results.keys())
    boxes = [
        [b[0] / width, b[1] / height, b[2] / width, b[3] / height]
        for b in results.values()
    ]
    for i in range(len(keys) - 2):
        order = _ordered_permute(boxes[i], boxes[i + 1], boxes[i + 2])
        j = keys[i]
        boxes[i], boxes[i + 1], boxes[i + 2] = (
            boxes[i + order[0]], boxes[i + order[1]], boxes[i + order[2]]
        )
        results[j], results[j + 1], results[j + 2] = (
            results[j + order[0]], results[j + order[1]], results[j + order[2]]
        )
    return results


def _prep_inputs(cfg: OrderFormerConfig, shapes: List[Dict], w: float, h: float):
    """shapes -> (model input row (max_boxes, input_dim), ordered flat labels)
    — the host half of predict (models/model.py:419-457)."""
    entries = []
    xs, ys = [], []
    for obj in shapes:
        p = obj["points"]
        flat = [p[0][0], p[0][1], p[1][0], p[1][1]]
        xs.extend([p[0][0] / w, p[1][0] / w])
        ys.extend([p[0][1] / h, p[1][1] / h])
        entries.append(flat)
    xmin, ymin = min(xs), min(ys)
    norm = []
    for i, flat in enumerate(entries):
        coord = [
            xs[2 * i] - xmin, ys[2 * i] - ymin, xs[2 * i + 1] - xmin, ys[2 * i + 1] - ymin
        ]
        norm.append([coord, flat])
    # unique ordering: sort by squared distance of box center to origin
    norm.sort(key=lambda x: ((x[0][0] + x[0][2]) / 2) ** 2 + ((x[0][1] + x[0][3]) / 2) ** 2)

    n = min(len(norm), cfg.max_boxes)
    row = np.zeros((cfg.max_boxes, cfg.input_dim), np.float32)
    labels = []
    for i, (coord, flat) in enumerate(norm[:n]):
        row[i] = coord
        labels.append(flat)
    return row, labels


def _decode_result(scores_row, labels, w, h) -> Dict[int, List[float]]:
    ranks = _decode_ranks(scores_row[None], len(labels))
    results = {int(r): l for r, l in zip(ranks, labels)}
    results = dict(sorted(results.items()))
    results = postprocess(results, w, h)
    return dict(sorted(results.items()))


def predict_batch_dispatch(params: Params, cfg: OrderFormerConfig, pages: List):
    """Host input prep + one forward for all pages' column sets (no readback)."""
    rows, metas = [], []
    for shapes, w, h in pages:
        if not shapes:
            metas.append(None)
            continue
        row, labels = _prep_inputs(cfg, shapes, w, h)
        metas.append((len(rows), labels, w, h))
        rows.append(row)
    scores = None
    if rows:
        dev = params["embed_kernel"].device
        scores = forward(params, cfg, torch.from_numpy(np.stack(rows)).to(dev))
    return scores, metas, len(pages)


def predict_batch_fetch(handle) -> List[Dict[int, List[float]]]:
    """The (B, max_boxes, 1) score readback + rank decode."""
    scores_dev, metas, n_pages = handle
    if scores_dev is None:
        return [{} for _ in range(n_pages)]
    scores = scores_dev.cpu().numpy()
    out = []
    for meta in metas:
        if meta is None:
            out.append({})
            continue
        i, labels, w, h = meta
        out.append(_decode_result(scores[i], labels, w, h))
    return out


def predict_batch(params: Params, cfg: OrderFormerConfig, pages: List) -> List[Dict[int, List[float]]]:
    return predict_batch_fetch(predict_batch_dispatch(params, cfg, pages))


def predict(params, cfg, shapes, image_width, image_height) -> Dict[int, List[float]]:
    return predict_batch(params, cfg, [(shapes, image_width, image_height)])[0]
