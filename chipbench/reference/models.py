"""Plain float32 versions of every model the cells run: InternViT, the
pixel-shuffle projector, the perceiver resampler with cosine VQ and the
Gaussian denorm, the YOLO-style detector, OrderFormer and InternLM2 (with
LoRA deltas for the e-IT step). Plain torch operations only: no kernel, no
cache, no bucketing; every product in float32 with TF32 off (``exact``).
Weights are read from the trees the benchmark drew, in the port's layout
(stacked layers, kernels stored (in, out)); nothing here reads what the
program derived from them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from chipbench.reference import resample

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def exact():
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    mm, cd = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, cd
        torch.set_float32_matmul_precision(prec)


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def layer_norm(x, scale, bias, eps):
    return F.layer_norm(x, (x.shape[-1],), f32(scale), f32(bias), eps)


# ------------------------------------------------------------------ ViT


def vit(p, cfg: Dict, pixels: torch.Tensor) -> torch.Tensor:
    """InternViT: (B, H, W, 3) uint8 tiles -> last hidden (B, 1 + patches, E).
    Pre-norm layers with layer scale, exact-erf GELU; the tiles are at the
    tower's native size, so the position table is used as drawn."""
    P, E, H = cfg["patch_size"], cfg["hidden_size"], cfg["num_attention_heads"]
    eps = cfg.get("layer_norm_eps", 1e-6)
    B, Hp, Wp, C = pixels.shape
    if Hp != cfg["image_size"] or Wp != cfg["image_size"]:
        raise ValueError(f"tiles of {Hp}x{Wp}, the tower's native size is {cfg['image_size']}")
    mean = torch.tensor(IMAGENET_MEAN, device=pixels.device)
    std = torch.tensor(IMAGENET_STD, device=pixels.device)
    x = (pixels.float() / 255.0 - mean) / std
    g = Hp // P
    x = x.reshape(B, g, P, g, P, C).permute(0, 1, 3, 5, 2, 4).reshape(B, g * g, C * P * P)
    x = x @ f32(p["patch_embed"]["kernel"]) + f32(p["patch_embed"]["bias"])
    x = torch.cat([f32(p["cls_token"]).expand(B, 1, E), x], dim=1) + f32(p["pos_embed"])
    lp = p["layers"]
    D = E // H
    for i in range(cfg["num_hidden_layers"]):
        h = layer_norm(x, lp["norm1_scale"][i], lp["norm1_bias"][i], eps)
        qkv = (h @ f32(lp["qkv_kernel"][i]) + f32(lp["qkv_bias"][i])).reshape(B, -1, 3, H, D)
        q, k, v = (qkv[:, :, j].transpose(1, 2) for j in range(3))
        a = torch.softmax((q @ k.transpose(-1, -2)) * D ** -0.5, dim=-1)
        ctx = (a @ v).transpose(1, 2).reshape(B, -1, E)
        ctx = ctx @ f32(lp["proj_kernel"][i]) + f32(lp["proj_bias"][i])
        x = x + ctx * f32(lp["ls1"][i])
        h = layer_norm(x, lp["norm2_scale"][i], lp["norm2_bias"][i], eps)
        h = F.gelu(h @ f32(lp["fc1_kernel"][i]) + f32(lp["fc1_bias"][i]))
        x = x + (h @ f32(lp["fc2_kernel"][i]) + f32(lp["fc2_bias"][i])) * f32(lp["ls2"][i])
    return x


def projector(p, hidden: torch.Tensor) -> torch.Tensor:
    """Drop CLS, pixel shuffle x0.5 (version 2), LN -> Linear -> GELU -> Linear."""
    x = hidden[:, 1:]
    B, S, E = x.shape
    n = int(round(S ** 0.5))
    x = x.reshape(B, n, n // 2, E * 2).permute(0, 2, 1, 3)
    x = x.reshape(B, n // 2, n // 2, E * 4).permute(0, 2, 1, 3).reshape(B, -1, E * 4)
    x = layer_norm(x, p["ln_scale"], p["ln_bias"], 1e-5)
    x = F.gelu(x @ f32(p["fc1_kernel"]) + f32(p["fc1_bias"]))
    return x @ f32(p["fc2_kernel"]) + f32(p["fc2_bias"])


def resampler(p, cfg: Dict, x: torch.Tensor) -> torch.Tensor:
    """Perceiver resampler: (B, tokens, dim) -> (B, num_learns, out_dim or dim)."""
    B = x.shape[0]
    H, Dh, nl, dim = cfg["heads"], cfg["dim_head"], cfg["num_learns"], cfg["dim"]
    learns = f32(p["learns"]).expand(B, nl, dim)
    lp = p["layers"]

    def heads(t):
        return t.reshape(B, t.shape[1], H, Dh).transpose(1, 2)

    for i in range(cfg["depth"]):
        xm = layer_norm(x, lp["norm_media_scale"][i], lp["norm_media_bias"][i], 1e-5)
        ln = layer_norm(learns, lp["norm_learns_scale"][i], lp["norm_learns_bias"][i], 1e-5)
        q = heads(ln @ f32(lp["to_q"][i]))
        k, v = (heads(t) for t in (torch.cat([xm, ln], 1) @ f32(lp["to_kv"][i])).chunk(2, -1))
        a = torch.softmax((q * Dh ** -0.5) @ k.transpose(-1, -2), dim=-1)
        learns = (a @ v).transpose(1, 2).reshape(B, nl, H * Dh) @ f32(lp["to_out"][i]) + learns
        h = layer_norm(learns, lp["ff_norm_scale"][i], lp["ff_norm_bias"][i], 1e-5)
        h = F.gelu(h @ f32(lp["ff1"][i]) + f32(lp["ff1_bias"][i]))
        learns = learns + h @ f32(lp["ff2"][i]) + f32(lp["ff2_bias"][i])
    learns = layer_norm(learns, p["norm_scale"], p["norm_bias"], 1e-5)
    if "out_kernel" in p:
        learns = learns @ f32(p["out_kernel"]) + f32(p["out_bias"])
    return learns


def vq_denorm(align, out: torch.Tensor) -> torch.Tensor:
    """Cosine VQ against the token table, then out * sigma[idx] + mu[idx]:
    (B, n, E) -> (B * n, E)."""
    x = F.normalize(out, dim=-1)
    table = F.normalize(f32(align["normed_emb"]), dim=-1)
    idx = torch.einsum("bne,ve->bnv", x, table).argmax(-1)
    y = out * f32(align["sigma"])[idx][..., None] + f32(align["mu"])[idx][..., None]
    return y.reshape(-1, y.shape[-1])


# ------------------------------------------------------------- detector


def _same_pad(x, k, stride):
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def _conv_raw(p, x, stride=1):
    w = p["w"]
    y = F.conv2d(_same_pad(x, w.shape[0], stride), f32(w).permute(3, 2, 0, 1), stride=stride)
    return y + f32(p["b"]).reshape(1, -1, 1, 1)


def _conv(p, x, stride=1):
    return F.silu(_conv_raw(p, x, stride))


def _c2f(p, x, shortcut):
    a, b = _conv(p["cv1"], x).chunk(2, dim=1)
    outs, h = [a, b], b
    for blk in p["blocks"]:
        y = _conv(blk["cv2"], _conv(blk["cv1"], h))
        h = h + y if shortcut else y
        outs.append(h)
    return _conv(p["cv2"], torch.cat(outs, dim=1))


def _sppf(p, x):
    pools = [_conv(p["cv1"], x)]
    for _ in range(3):
        pools.append(F.max_pool2d(pools[-1], 5, stride=1, padding=2))
    return _conv(p["cv2"], torch.cat(pools, dim=1))


def _up(x):
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def detector(p, reg_max: int, pages_u8: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, S, 3) uint8 letterboxed pages -> (boxes xyxy (B, N, 4), scores
    (B, N)) over every anchor of the three scales (DFL box decode)."""
    b, n = p["backbone"], p["neck"]
    x = pages_u8.float().permute(0, 3, 1, 2) / 255.0
    x = _conv(b["down1"], _conv(b["stem"], x, 2), 2)
    x = _c2f(b["c2f1"], x, True)
    p3 = _c2f(b["c2f2"], _conv(b["down2"], x, 2), True)
    p4 = _c2f(b["c2f3"], _conv(b["down3"], p3, 2), True)
    p5 = _sppf(b["sppf"], _c2f(b["c2f4"], _conv(b["down4"], p4, 2), True))
    u4 = _c2f(n["c2f_p4"], torch.cat([_up(p5), p4], 1), False)
    u3 = _c2f(n["c2f_p3"], torch.cat([_up(u4), p3], 1), False)
    d4 = _c2f(n["c2f_n4"], torch.cat([_conv(n["down_p3"], u3, 2), u4], 1), False)
    d5 = _c2f(n["c2f_n5"], torch.cat([_conv(n["down_p4"], d4, 2), p5], 1), False)
    boxes, scores = [], []
    for feat, name, stride in zip((u3, d4, d5), ("p3", "p4", "p5"), (8, 16, 32)):
        hp = p["head"][name]
        box = _conv_raw(hp["box"]["out"], _conv(hp["box"]["cv2"], _conv(hp["box"]["cv1"], feat)))
        cls = _conv_raw(hp["cls"]["out"], _conv(hp["cls"]["cv2"], _conv(hp["cls"]["cv1"], feat)))
        B, _, Hs, Ws = box.shape
        dist = torch.softmax(box.permute(0, 2, 3, 1).reshape(B, Hs * Ws, 4, reg_max), -1)
        ltrb = (dist * torch.arange(reg_max, dtype=torch.float32, device=x.device)).sum(-1)
        cy, cx = torch.meshgrid(torch.arange(Hs, device=x.device, dtype=torch.float32) + 0.5,
                                torch.arange(Ws, device=x.device, dtype=torch.float32) + 0.5,
                                indexing="ij")
        c = torch.stack([cx.reshape(-1), cy.reshape(-1)], -1)
        boxes.append(torch.cat([(c - ltrb[..., :2]) * stride, (c + ltrb[..., 2:]) * stride], -1))
        scores.append(torch.sigmoid(cls.permute(0, 2, 3, 1)).amax(-1).reshape(B, Hs * Ws))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def letterbox(image: np.ndarray, size: int):
    """Keep-aspect PIL-bilinear resize, gray (114) pad to size x size."""
    h, w = image.shape[:2]
    scale = min(size / h, size / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = np.full((size, size, 3), 114, np.uint8)
    px, py = (size - nw) // 2, (size - nh) // 2
    out[py:py + nh, px:px + nw] = resample.pil_resize(image, (nw, nh), "bilinear")
    return out, scale, (px, py)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thr: float, max_det: int) -> List[int]:
    """Greedy NMS, highest score first."""
    order = scores.argsort()[::-1]
    keep: List[int] = []
    area = np.maximum(0, boxes[:, 2] - boxes[:, 0]) * np.maximum(0, boxes[:, 3] - boxes[:, 1])
    while order.size and len(keep) < max_det:
        i, rest = order[0], order[1:]
        keep.append(int(i))
        iw = np.maximum(0, np.minimum(boxes[i, 2], boxes[rest, 2]) - np.maximum(boxes[i, 0], boxes[rest, 0]))
        ih = np.maximum(0, np.minimum(boxes[i, 3], boxes[rest, 3]) - np.maximum(boxes[i, 1], boxes[rest, 1]))
        inter = iw * ih
        order = rest[inter / np.maximum(area[i] + area[rest] - inter, 1e-9) <= iou_thr]
    return keep


# ----------------------------------------------------------- OrderFormer


def orderformer(p, cfg: Dict, x: torch.Tensor) -> torch.Tensor:
    """Post-norm transformer encoder over normalised column boxes ->
    rank scores (B, boxes, 1)."""
    B, S, _ = x.shape
    H, E = cfg["num_heads"], cfg["model_dim"]
    D = E // H
    x = x.float() @ f32(p["embed_kernel"]) + f32(p["embed_bias"])
    lp = p["layers"]
    for i in range(cfg["num_layers"]):
        qkv = x @ f32(lp["in_proj_kernel"][i]) + f32(lp["in_proj_bias"][i])
        q, k, v = (t.reshape(B, S, H, D).transpose(1, 2) for t in qkv.chunk(3, -1))
        ctx = (torch.softmax(q @ k.transpose(-1, -2) / D ** 0.5, -1) @ v)
        ctx = ctx.transpose(1, 2).reshape(B, S, E) @ f32(lp["out_proj_kernel"][i])
        x = layer_norm(x + ctx + f32(lp["out_proj_bias"][i]), lp["norm1_scale"][i],
                       lp["norm1_bias"][i], 1e-5)
        h = torch.relu(x @ f32(lp["ff1_kernel"][i]) + f32(lp["ff1_bias"][i]))
        h = h @ f32(lp["ff2_kernel"][i]) + f32(lp["ff2_bias"][i])
        x = layer_norm(x + h, lp["norm2_scale"][i], lp["norm2_bias"][i], 1e-5)
    return x @ f32(p["decode_kernel"]) + f32(p["decode_bias"])


# -------------------------------------------------------------- InternLM2

Weight = Callable[[str, Optional[int]], torch.Tensor]


def plain_weight(tree) -> Weight:
    """Leaf ``name`` (of layer ``i``) in float32."""
    def get(name: str, i: Optional[int] = None) -> torch.Tensor:
        return f32(tree["layers"][name][i] if i is not None else tree[name])
    return get


def quantized_weight(tree, levels: int) -> Weight:
    """The control's weights: each LLM matrix rounded to ``levels`` symmetric
    steps per output channel (absmax / levels; 7 is int4), the vocabulary
    tables per row; norms as drawn."""
    def get(name: str, i: Optional[int] = None) -> torch.Tensor:
        w = f32(tree["layers"][name][i] if i is not None else tree[name])
        if "norm" in name:
            return w
        dim = 1 if name in ("tok_embeddings", "output") else 0
        s = w.abs().amax(dim=dim, keepdim=True).clamp_min(1e-8) / levels
        return torch.clamp(torch.round(w / s), -levels, levels) * s
    return get


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE on (..., S, D) at integer positions (S,)."""
    D = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cat([ang.cos(), ang.cos()], -1), torch.cat([ang.sin(), ang.sin()], -1)
    return x * cos + torch.cat([-x[..., D // 2:], x[..., :D // 2]], -1) * sin


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def llm_layer(W: Weight, cfg: Dict, i: int, x: torch.Tensor, positions: torch.Tensor,
              segments: torch.Tensor, lora: Optional[Dict] = None) -> torch.Tensor:
    """One decoder layer over (B, S, E): GQA attention with RoPE, causal
    within equal segment ids (-1: pad, attends nothing); SwiGLU MLP.
    ``lora``: {name: (A (L, in, r), B (L, r, out)), "scale": s}."""
    B, S, E = x.shape
    Hq, Hkv, eps = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["rms_norm_eps"]
    D = E // Hq

    def lin(h, name):
        y = h @ W(name, i)
        if lora is not None and name in lora:
            a, b = lora[name]
            y = y + ((h @ a[i].float()) @ b[i].float()) * lora["scale"]
        return y

    h = rms_norm(x, W("attn_norm", i), eps)
    q = lin(h, "wq").reshape(B, S, Hq, D).transpose(1, 2)
    k = lin(h, "wk").reshape(B, S, Hkv, D).transpose(1, 2)
    v = lin(h, "wv").reshape(B, S, Hkv, D).transpose(1, 2)
    q, k = rope(q, positions, cfg["rope_theta"]), rope(k, positions, cfg["rope_theta"])
    k = k.repeat_interleave(Hq // Hkv, dim=1)
    v = v.repeat_interleave(Hq // Hkv, dim=1)
    idx = torch.arange(S, device=x.device)
    allowed = ((idx[None, :] <= idx[:, None])[None]
               & (segments[:, :, None] == segments[:, None, :]) & (segments[:, None, :] >= 0))
    ctx = torch.empty_like(q)
    for j in range(0, Hq, 8):  # heads in groups: the fp32 scores of all 32 at once are large
        s = (q[:, j:j + 8] @ k[:, j:j + 8].transpose(-1, -2)) * D ** -0.5
        s = s.masked_fill(~allowed[:, None], float("-inf"))
        ctx[:, j:j + 8] = torch.nan_to_num(torch.softmax(s, -1)) @ v[:, j:j + 8]
    x = x + lin(ctx.transpose(1, 2).reshape(B, S, E), "wo")
    h = rms_norm(x, W("ffn_norm", i), eps)
    return x + lin(F.silu(lin(h, "w1")) * lin(h, "w3"), "w2")


def llm_hidden(W: Weight, cfg: Dict, embeds: torch.Tensor, positions: torch.Tensor,
               segments: Optional[torch.Tensor] = None, lora=None,
               layer_fn: Callable = llm_layer) -> torch.Tensor:
    """(B, S, E) float32 input embeddings -> final normed hidden (B, S, E)."""
    B, S, _ = embeds.shape
    if segments is None:
        segments = torch.zeros((B, S), dtype=torch.int64, device=embeds.device)
    x = embeds
    for i in range(cfg["num_hidden_layers"]):
        x = layer_fn(W, cfg, i, x, positions, segments, lora)
    return rms_norm(x, W("norm", None), cfg["rms_norm_eps"])


def llm_logits(W: Weight, hidden: torch.Tensor, vocab: int) -> torch.Tensor:
    """LM head over the real vocabulary rows -> float32 logits."""
    return hidden @ W("output", None)[:vocab].T

