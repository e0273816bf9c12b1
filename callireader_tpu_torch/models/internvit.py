"""InternViT-style vision encoder (PyTorch port of callireader_tpu/models/internvit.py).

Same parameter tree as the JAX package (layers stacked on axis 0, kernels
stored (in, out)), so ``runtime.weights.from_jax_params`` moves weights over
unchanged. NHWC pixels; the stride == kernel patch conv is a reshape and one
matmul; pre-norm layers with layer-scale ls1/ls2 and exact-erf GELU.
Attention goes through ``kernels.vit_attention`` straight from the packed
(B, S, 3E) projection. bf16 weights only (the W8A8 path is not ported).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from callireader_tpu_torch.core.config import VisionConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.kernels.vit_attention import attention_from_packed_qkv_nomax
from callireader_tpu_torch.vision import resample

Params = Dict[str, Any]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def layer_norm(x, scale, bias, eps: float, policy: DTypePolicy) -> torch.Tensor:
    xf = x.to(policy.norm_dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(policy.norm_dtype) + bias.to(policy.norm_dtype)
    return y.to(policy.compute_dtype)


def normalize_uint8(pixel_values: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """On-device ImageNet normalisation of raw uint8 NHWC tiles."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=dtype, device=pixel_values.device)
    std = torch.tensor(IMAGENET_STD, dtype=dtype, device=pixel_values.device)
    x = pixel_values.to(dtype) / 255.0
    return (x - mean) / std


def _patchify(pixel_values: torch.Tensor, patch: int) -> torch.Tensor:
    """NHWC (B,H,W,C) -> (B, H/p * W/p, C*p*p) in torch conv flatten order
    (c, kh, kw)."""
    B, H, W, C = pixel_values.shape
    x = pixel_values.reshape(B, H // patch, patch, W // patch, patch, C)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, gh, gw, C, kh, kw)
    return x.reshape(B, (H // patch) * (W // patch), C * patch * patch)


def interp_pos_embed(pos_embed: torch.Tensor, grid_h: int, grid_w: int, base_grid: int) -> torch.Tensor:
    """Bicubic-resize patch position embeddings, CLS kept as-is, with
    jax.image.resize("bicubic") semantics (vision/resample.py)."""
    if grid_h == base_grid and grid_w == base_grid:
        return pos_embed
    cls, rest = pos_embed[:, :1], pos_embed[:, 1:]
    E = rest.shape[-1]
    grid = rest.reshape(base_grid, base_grid, E).float()
    wy = resample.jax_resize_weights(base_grid, grid_h, pos_embed.device)
    wx = resample.jax_resize_weights(base_grid, grid_w, pos_embed.device)
    resized = torch.einsum("yi,ijE,xj->yxE", wy, grid, wx)
    resized = resized.reshape(1, grid_h * grid_w, E).to(pos_embed.dtype)
    return torch.cat([cls, resized], dim=1)


def forward(
    params: Params,
    cfg: VisionConfig,
    pixel_values: torch.Tensor,  # (B, H, W, C) NHWC, uint8 or float
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
) -> torch.Tensor:
    """Returns the last hidden state (B, 1 + num_patches, E)."""
    B, H, W, _ = pixel_values.shape
    P = cfg.patch_size
    gh, gw = H // P, W // P
    base = cfg.image_size // P
    cd = policy.compute_dtype

    if pixel_values.dtype == torch.uint8:
        pixel_values = normalize_uint8(pixel_values, policy.norm_dtype)
    x = _patchify(pixel_values.to(cd), P)
    x = x @ params["patch_embed"]["kernel"].to(cd) + params["patch_embed"]["bias"].to(cd)
    cls = params["cls_token"].to(cd).expand(B, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1)
    x = x + interp_pos_embed(params["pos_embed"], gh, gw, base).to(cd)

    lp = params["layers"]
    Hn = cfg.num_attention_heads
    eps = cfg.layer_norm_eps
    for i in range(cfg.num_hidden_layers):
        h = layer_norm(x, lp["norm1_scale"][i], lp["norm1_bias"][i], eps, policy)
        qkv = h @ lp["qkv_kernel"][i].to(cd) + lp["qkv_bias"][i].to(cd)
        ctx = attention_from_packed_qkv_nomax(qkv.contiguous(), Hn)
        ctx = ctx @ lp["proj_kernel"][i].to(cd) + lp["proj_bias"][i].to(cd)
        x = x + ctx * lp["ls1"][i].to(cd)

        h = layer_norm(x, lp["norm2_scale"][i], lp["norm2_bias"][i], eps, policy)
        h = h @ lp["fc1_kernel"][i].to(cd) + lp["fc1_bias"][i].to(cd)
        h = F.gelu(h, approximate="none")
        h = h @ lp["fc2_kernel"][i].to(cd) + lp["fc2_bias"][i].to(cd)
        x = x + h * lp["ls2"][i].to(cd)
    return x
