"""OrderFormer reading-order regressor (PyTorch port of
callireader_tpu/models/orderformer.py).

Linear(4 -> E) embed, post-LN encoder layers (torch TransformerEncoderLayer
semantics: ReLU FFN, no padding mask over the 50 box slots), Linear(E -> 1)
rank scores, in float32 with full-precision matmuls. The host half (input
normalisation, double-argsort rank decode, the sliding-window-of-3 row
re-permutation) is copied unchanged. Training (models/model.py:351-418):
MSE on the rank scores, AdamW over cosine warm restarts on the port's own
optimizer (train/e_it.py), and the exact-order evaluation.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from callireader_tpu_torch.core.config import OrderFormerConfig
from callireader_tpu_torch.core.dtypes import FP32_POLICY, exact_fp32, require_device
from callireader_tpu_torch.models.internvit import layer_norm
from callireader_tpu_torch.train import e_it
from callireader_tpu_torch.utils.profiling import SPANS, readback, upload

Params = Dict[str, Any]
LN_EPS = 1e-5


def init_params(cfg: OrderFormerConfig, generator: torch.Generator, dtype=torch.float32,
                device="cuda") -> Params:
    """The JAX tree: Glorot-uniform kernels with JAX's fans (a stacked
    (L, in, out) kernel counts L into both), zero biases, unit norms."""
    L, E, F = cfg.num_layers, cfg.model_dim, cfg.ff_dim
    dev = require_device(device)

    def xavier(*shape):
        fan_in = fan_out = math.prod(shape[:-2])
        fan_in, fan_out = fan_in * shape[-2], fan_out * shape[-1]
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        x = torch.rand(shape, generator=generator, dtype=torch.float32, device=dev)
        return ((2 * x - 1) * bound).to(dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=dev)

    return {
        "embed_kernel": xavier(cfg.input_dim, E), "embed_bias": zeros(E),
        "layers": {
            "in_proj_kernel": xavier(L, E, 3 * E), "in_proj_bias": zeros(L, 3 * E),
            "out_proj_kernel": xavier(L, E, E), "out_proj_bias": zeros(L, E),
            "norm1_scale": ones(L, E), "norm1_bias": zeros(L, E),
            "norm2_scale": ones(L, E), "norm2_bias": zeros(L, E),
            "ff1_kernel": xavier(L, E, F), "ff1_bias": zeros(L, F),
            "ff2_kernel": xavier(L, F, E), "ff2_bias": zeros(L, E),
        },
        "decode_kernel": xavier(E, cfg.output_dim), "decode_bias": zeros(cfg.output_dim),
    }


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
    """Host input prep + one forward for all pages' column sets (no
    readback), the span ``order_dispatch`` (device time: the forward)."""
    with SPANS.span("order_dispatch"):
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
            x = upload(torch.from_numpy(np.stack(rows)), params["embed_kernel"].device)
            with SPANS.device("order_dispatch"):
                scores = forward(params, cfg, x)
    return scores, metas, len(pages)


def predict_batch_fetch(handle) -> List[Dict[int, List[float]]]:
    """The (B, max_boxes, 1) score readback + rank decode."""
    scores_dev, metas, n_pages = handle
    if scores_dev is None:
        return [{} for _ in range(n_pages)]
    scores = readback(scores_dev).numpy()
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


# ---------------------------------------------------------------------------
# training / evaluation (models/model.py:351-418: AdamW + cosine warm
# restarts, MSE on rank scores; eval reports avg loss + order accuracy)
# ---------------------------------------------------------------------------


def mse_loss(params: Params, cfg: OrderFormerConfig, boxes: torch.Tensor,
             ranks: torch.Tensor) -> torch.Tensor:
    """boxes (B, max_boxes, 4), ranks (B, max_boxes, 1) float targets (0
    rows beyond each sample's box count, matching the padded inputs)."""
    pred = forward(params, cfg, boxes)
    return ((pred - ranks.to(pred.dtype)) ** 2).mean()


def warm_restarts(lr: float, t0: int, t_mult: int, total_steps: int):
    """Cosine warm restarts as the JAX trainer joins them: periods t0,
    t0 * t_mult, ... until they cover total_steps, each from lr down to
    1e-6."""
    schedules, boundaries, t, pos = [], [], t0, 0
    while pos < total_steps:
        schedules.append(e_it.cosine_schedule(lr, t, alpha=1e-6 / lr))
        pos += t
        boundaries.append(pos)
        t *= t_mult
    return e_it.join_schedules(schedules, boundaries[:-1])


def make_train_step(cfg: OrderFormerConfig, lr: float = 2e-4, weight_decay: float = 0.0,
                    t0: int = 10, t_mult: int = 2, total_steps: int = 1000):
    """-> (train_step, tx): AdamW (eps 1e-8, no clipping) over
    ``warm_restarts``. ``train_step(params, opt_state, boxes, ranks) ->
    (params, opt_state, loss)`` updates the leaves of ``params`` in place."""
    tx = e_it.Optimizer(warm_restarts(lr, t0, t_mult, total_steps), eps=1e-8,
                        weight_decay=weight_decay)

    def train_step(params, opt_state, boxes, ranks):
        flat = e_it.flatten(params)
        with exact_fp32():
            loss = mse_loss(params, cfg, boxes, ranks)
            grads = torch.autograd.grad(loss, list(flat.values()))
            tx.update(dict(zip(flat, grads)), opt_state, flat)
        return params, opt_state, loss.detach()

    return train_step, tx


def train_orderformer(params: Params, cfg: OrderFormerConfig, boxes: np.ndarray,
                      ranks: np.ndarray, *, batch_size: int = 4, lr: float = 2e-4,
                      weight_decay: float = 0.0, epochs: int = 10, seed: int = 0,
                      verbose: bool = False) -> Tuple[Params, float]:
    """boxes (N, max_boxes, 4) / ranks (N, max_boxes, 1) -> (the params of
    the epoch with the lowest mean loss, that loss). Trains a copy on the
    device of ``params`` (the caller's tree is left as it was); the data is
    uploaded once and each batch gathered there."""
    n = len(boxes)
    steps = max(1, n // batch_size) * epochs
    train_step, tx = make_train_step(cfg, lr, weight_decay, total_steps=steps)
    params = e_it.clone_tree(params, True)
    opt_state = tx.init(e_it.flatten(params))
    dev = params["embed_kernel"].device
    d_boxes, d_ranks = torch.from_numpy(boxes).to(dev), torch.from_numpy(ranks).to(dev)
    rng = np.random.RandomState(seed)
    best, best_params = float("inf"), params
    for ep in range(epochs):
        order = rng.permutation(n)
        total, nb = 0.0, 0
        for i in range(0, n - batch_size + 1, batch_size):
            idx = torch.from_numpy(order[i:i + batch_size]).to(dev)
            params, opt_state, loss = train_step(params, opt_state, d_boxes[idx], d_ranks[idx])
            total += float(loss)
            nb += 1
        avg = total / max(nb, 1)
        if verbose:
            print(f"epoch {ep + 1}/{epochs} loss {avg:.5f}")
        if avg < best:
            best, best_params = avg, e_it.clone_tree(params, False)
    return best_params, best


@torch.no_grad()
def evaluate_orderformer(params: Params, cfg: OrderFormerConfig, boxes: np.ndarray,
                         ranks: np.ndarray, counts: np.ndarray) -> Dict[str, float]:
    """Avg MSE + exact-order accuracy (fraction of samples whose decoded
    permutation matches the target ranks; models/model.py:390-418)."""
    dev = params["embed_kernel"].device
    pred = forward(params, cfg, torch.from_numpy(boxes).to(dev)).cpu().numpy()
    mse = float(np.mean((pred - ranks) ** 2))
    correct = 0
    for i in range(len(boxes)):
        n = int(counts[i])
        correct += int(np.array_equal(_decode_ranks(pred[i], n), _decode_ranks(ranks[i], n)))
    return {"loss": mse, "order_accuracy": correct / max(len(boxes), 1)}
