"""Pixel-shuffle projector "mlp1" (PyTorch port of callireader_tpu/models/projector.py).

ViT hidden (B, 1 + S, E_vit) -> (B, S/4, out): drop CLS, pixel-shuffle x0.5
(ps v2), LayerNorm -> Linear -> GELU -> Linear. The tile tower's projector
outputs the LLM width; the compact char tower's projects to the resampler
width (its ``fc*`` shapes carry ``out_dim``).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from callireader_tpu_torch.core.config import VLMConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.models.internvit import layer_norm

Params = Dict[str, Any]


def pixel_shuffle(x: torch.Tensor, scale_factor: float, ps_version: str = "v2") -> torch.Tensor:
    """x (N, W, H, C) -> (N, W*s, H*s, C/s^2), the reference's view/permute."""
    n, w, h, c = x.shape
    x = x.reshape(n, w, int(h * scale_factor), int(c / scale_factor))
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(n, int(h * scale_factor), int(w * scale_factor), int(c / (scale_factor**2)))
    if ps_version != "v1":
        x = x.permute(0, 2, 1, 3)
    return x


def extract_feature(
    projector_params: Params,
    vit_hidden: torch.Tensor,
    cfg: VLMConfig,
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
) -> torch.Tensor:
    """-> (B, num_image_token, out)."""
    x = vit_hidden[:, 1:, :]
    B, S, E = x.shape
    hw = int(S**0.5)
    x = pixel_shuffle(x.reshape(B, hw, hw, E), cfg.downsample_ratio, cfg.ps_version)
    x = x.reshape(B, -1, x.shape[-1])
    p = projector_params
    cd = policy.compute_dtype
    x = layer_norm(x, p["ln_scale"], p["ln_bias"], 1e-5, policy)
    x = x @ p["fc1_kernel"].to(cd) + p["fc1_bias"].to(cd)
    x = F.gelu(x, approximate="none")
    return x @ p["fc2_kernel"].to(cd) + p["fc2_bias"].to(cd)
