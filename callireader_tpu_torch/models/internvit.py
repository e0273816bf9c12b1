"""InternViT-style vision encoder (PyTorch port of callireader_tpu/models/internvit.py).

Same parameter tree as the JAX package (layers stacked on axis 0, kernels
stored (in, out)), so ``runtime.weights.from_jax_params`` moves weights over
unchanged. NHWC pixels; the stride == kernel patch conv is a reshape and one
matmul; pre-norm layers with layer-scale ls1/ls2 and exact-erf GELU.
Attention goes through ``kernels.vit_attention`` straight from the packed
(B, S, 3E) projection. The layer linears run W8A8 where the tree holds
int8 leaves (runtime/quantize.quantize_vit_int8, ``--quant int8-all``).

Training (the CalliAlign trainer, train/callialign_train.py) reaches the
same forward with ``lora`` deltas over the four big matrices, ``remat``
(``torch.utils.checkpoint`` per layer) and the differentiable plain
attention (``attn_impl="reference"``): the kernel has no backward, and its wrapper raises on an input that requires grad.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from callireader_tpu_torch.core.config import VisionConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.kernels.vit_attention import (
    attention_from_packed_qkv_nomax, vit_attention_reference,
)
from callireader_tpu_torch.utils.profiling import upload
from callireader_tpu_torch.vision import resample

Params = Dict[str, Any]

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VIT_LORA_MATS = ("qkv", "proj", "fc1", "fc2")


def logical_axes(cfg: VisionConfig) -> Params:
    """Logical sharding annotations, the tree of the params
    (core/partition.py)."""
    del cfg
    lx = {
        "norm1_scale": ("stack", "norm"), "norm1_bias": ("stack", "norm"),
        "norm2_scale": ("stack", "norm"), "norm2_bias": ("stack", "norm"),
        "qkv_kernel": ("stack", "vit_embed", "qkv"), "qkv_bias": ("stack", "qkv"),
        "proj_kernel": ("stack", "qkv", "vit_embed"), "proj_bias": ("stack", "norm"),
        "fc1_kernel": ("stack", "vit_embed", "vit_mlp"), "fc1_bias": ("stack", "vit_mlp"),
        "fc2_kernel": ("stack", "vit_mlp", "vit_embed"), "fc2_bias": ("stack", "norm"),
        "ls1": ("stack", "norm"), "ls2": ("stack", "norm"),
    }
    return {
        "patch_embed": {"kernel": ("patch", "vit_embed"), "bias": ("norm",)},
        "cls_token": (None, None, "vit_embed"),
        "pos_embed": (None, None, "vit_embed"),
        "layers": lx,
    }


def layer_norm(x, scale, bias, eps: float, policy: DTypePolicy) -> torch.Tensor:
    xf = x.to(policy.norm_dtype)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(policy.norm_dtype) + bias.to(policy.norm_dtype)
    return y.to(policy.compute_dtype)


def normalize_uint8(pixel_values: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """On-device ImageNet normalisation of raw uint8 NHWC tiles."""
    mean = upload(torch.tensor(IMAGENET_MEAN, dtype=dtype), pixel_values.device)
    std = upload(torch.tensor(IMAGENET_STD, dtype=dtype), pixel_values.device)
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


def quantize_rows(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-token absmax / 127 -> (int8 codes, fp32 scale (..., 1)), the JAX
    _mm's arithmetic: fp32 division, round half to even, clip to +-127."""
    amax = torch.linalg.vector_norm(h, ord=float("inf"), dim=-1, keepdim=True).float()
    hs = torch.clamp(amax, min=1e-6) / 127.0
    # h / hs promotes to fp32: the same values as h.float() / hs, one pass
    hq = torch.div(h, hs).round_().clamp_(-127, 127).to(torch.int8)
    return hq, hs


def int8_product(hq: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 x (K, N) int8 -> (..., N) exact int32 sums, by
    torch._int_mm on either device (a library int8 product: the JAX package
    runs this one as an XLA dot, no Pallas kernel). On CUDA it needs more
    than 16 rows, so fewer are zero-padded, and it is fast over a
    column-major ``q`` (runtime/quantize.quantize_vit_int8 stores it so)."""
    x = hq.reshape(-1, hq.shape[-1])
    m = x.shape[0]
    if x.is_cuda and m <= 16:
        x = torch.cat([x, x.new_zeros((17 - m, x.shape[1]))])
    return torch._int_mm(x, q)[:m].reshape(*hq.shape[:-1], q.shape[-1])


def _linear(lp: Params, i: int, h: torch.Tensor, name: str, lora: Optional[Params] = None,
            lora_scale: float = 1.0) -> torch.Tensor:
    """Layer ``i``'s ``name`` linear: bf16 (or the compute dtype), or W8A8 on
    ``{name}_kernel_q`` + ``{name}_kernel_scale``: the activations quantized
    per token, an int8 x int8 -> int32 product, then the activation scale
    times the weight scale, and the bias. ``lora``: {name_a: (L, in, r),
    name_b: (L, r, out)} adds ``lora_scale * (h @ A) @ B`` in the compute
    dtype before the bias, as the JAX linear does."""
    cd = h.dtype
    q = lp.get(f"{name}_kernel_q")
    if q is None:
        y = h @ lp[f"{name}_kernel"][i].to(cd)
    else:
        hq, hs = quantize_rows(h)
        # int32 * fp32 promotes to fp32: (y * hs) * scale in fp32, as in JAX
        y = torch.mul(int8_product(hq, q[i]), hs).mul_(lp[f"{name}_kernel_scale"][i]).to(cd)
    if lora is not None:
        d = (h @ lora[f"{name}_a"][i].to(cd)) @ lora[f"{name}_b"][i].to(cd)
        y = y + (lora_scale * d).to(y.dtype)
    if q is None:
        return y + lp[f"{name}_bias"][i].to(cd)
    return y.add_(lp[f"{name}_bias"][i].to(cd))


def _layer(lp: Params, i: int, x: torch.Tensor, cfg: VisionConfig, policy: DTypePolicy,
           attend, lora: Optional[Params], lora_scale: float) -> torch.Tensor:
    eps = cfg.layer_norm_eps
    cd = policy.compute_dtype
    h = layer_norm(x, lp["norm1_scale"][i], lp["norm1_bias"][i], eps, policy)
    qkv = _linear(lp, i, h, "qkv", lora, lora_scale)
    ctx = attend(qkv.contiguous(), cfg.num_attention_heads)
    ctx = _linear(lp, i, ctx, "proj", lora, lora_scale)
    x = x + ctx * lp["ls1"][i].to(cd)

    h = layer_norm(x, lp["norm2_scale"][i], lp["norm2_bias"][i], eps, policy)
    h = _linear(lp, i, h, "fc1", lora, lora_scale)
    h = F.gelu(h, approximate="none")
    h = _linear(lp, i, h, "fc2", lora, lora_scale)
    return x + h * lp["ls2"][i].to(cd)


def forward(
    params: Params,
    cfg: VisionConfig,
    pixel_values: torch.Tensor,  # (B, H, W, C) NHWC, uint8 or float
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
    attn_impl: Optional[str] = None,
    lora: Optional[Params] = None,
    lora_scale: float = 1.0,
    remat: bool = False,
) -> torch.Tensor:
    """Returns the last hidden state (B, 1 + num_patches, E).

    Attention runs through kernels.vit_attention (the kernel on the card,
    its plain version on CPU tensors) unless ``attn_impl="reference"`` asks
    for the plain version, which autograd can differentiate. ``lora``: {name_a: (L, in, r), name_b: (L, r, out)}
    deltas over the VIT_LORA_MATS matrices (the JAX forward's functional
    LoRA). ``remat``: each layer under ``torch.utils.checkpoint``, its
    activations recomputed in the backward (``jax.checkpoint`` of the JAX
    scan body)."""
    if attn_impl not in (None, "reference"):
        raise ValueError(f"attn_impl {attn_impl!r}: the port has the kernel (None) and "
                         f"'reference'")
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

    attend = vit_attention_reference if attn_impl == "reference" else attention_from_packed_qkv_nomax
    lp = params["layers"]
    for i in range(cfg.num_hidden_layers):
        if remat:
            x = checkpoint(_layer, lp, i, x, cfg, policy, attend, lora, lora_scale,
                           use_reentrant=False)
        else:
            x = _layer(lp, i, x, cfg, policy, attend, lora, lora_scale)
    return x
