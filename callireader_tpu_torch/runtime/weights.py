"""Parameters of the port: conversion from the JAX tree, seeded random init,
and the committed trained assets.

The port keeps the JAX package's parameter tree (same keys, layers stacked
on axis 0, kernels (in, out), detector convolutions HWIO), so
``from_jax_params`` is a leaf-wise numpy -> torch move. ``init_params``
draws every component at full width from one ``torch.Generator`` (the
numbers differ from jax.random's; a torch seed is its own reference). The
loaders read the npz assets under callireader_tpu/assets by path.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from callireader_tpu_torch.core.config import (
    DetectorConfig, LLMConfig, OrderFormerConfig, ResamplerConfig, VisionConfig,
    VLMConfig,
)
from callireader_tpu_torch.models import detector as detector_mod
from callireader_tpu_torch.runtime import quantize

ASSETS_DIR = Path(__file__).resolve().parents[2] / "callireader_tpu" / "assets"

# ------------------------------------------------------------ JAX -> torch


def _to_tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def from_jax_params(tree, *, device):
    """JAX param pytree (dicts/lists of arrays) -> the same tree of torch
    tensors on ``device``, dtypes kept (int8 weights and their fp32 scales
    cross unchanged)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax_params(v, device=device) for v in tree]
    return _to_tensor(tree, device)


# ------------------------------------------------------------ random init


class _Init:
    def __init__(self, generator: torch.Generator, device, dtype):
        self.g, self.device, self.dtype = generator, device, dtype

    def normal(self, shape, std=1.0, dtype=None):
        x = torch.randn(shape, generator=self.g, dtype=torch.float32, device=self.device)
        return (x * std).to(dtype or self.dtype)

    def uniform(self, shape, bound, dtype=torch.float32):
        x = torch.rand(shape, generator=self.g, dtype=torch.float32, device=self.device)
        return ((2 * x - 1) * bound).to(dtype)

    def zeros(self, shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self.dtype, device=self.device)

    def ones(self, shape, dtype=None):
        return torch.ones(shape, dtype=dtype or self.dtype, device=self.device)


def init_llm(r: _Init, cfg: LLMConfig) -> Dict[str, Any]:
    L, E, M = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, D, V = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.vocab_size
    return {
        "tok_embeddings": r.normal((V, E), 0.02),
        "layers": {
            "attn_norm": r.ones((L, E)), "ffn_norm": r.ones((L, E)),
            "wq": r.normal((L, E, Hq * D), 0.02), "wk": r.normal((L, E, Hkv * D), 0.02),
            "wv": r.normal((L, E, Hkv * D), 0.02), "wo": r.normal((L, Hq * D, E), 0.02),
            "w1": r.normal((L, E, M), 0.02), "w3": r.normal((L, E, M), 0.02),
            "w2": r.normal((L, M, E), 0.02),
        },
        "norm": r.ones((E,)),
        "output": r.normal((V, E), 0.02),
    }


def init_vision(r: _Init, cfg: VisionConfig) -> Dict[str, Any]:
    L, E, M = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    P, C, s = cfg.patch_size, cfg.num_channels, cfg.initializer_range
    return {
        "patch_embed": {"kernel": r.normal((C * P * P, E), s), "bias": r.zeros((E,))},
        "cls_token": r.normal((1, 1, E), s),
        "pos_embed": r.normal((1, cfg.num_patches + 1, E), s),
        "layers": {
            "norm1_scale": r.ones((L, E)), "norm1_bias": r.zeros((L, E)),
            "norm2_scale": r.ones((L, E)), "norm2_bias": r.zeros((L, E)),
            "qkv_kernel": r.normal((L, E, 3 * E), s), "qkv_bias": r.zeros((L, 3 * E)),
            "proj_kernel": r.normal((L, E, E), s), "proj_bias": r.zeros((L, E)),
            "fc1_kernel": r.normal((L, E, M), s), "fc1_bias": r.zeros((L, M)),
            "fc2_kernel": r.normal((L, M, E), s), "fc2_bias": r.zeros((L, E)),
            "ls1": r.ones((L, E)), "ls2": r.ones((L, E)),
        },
    }


def init_projector(r: _Init, cfg: VLMConfig, vit_hidden: int = 0, out_dim: int = 0):
    vit_e = vit_hidden or cfg.vision.hidden_size
    llm_e = out_dim or cfg.llm.hidden_size
    in_dim = vit_e * int(1 / cfg.downsample_ratio) ** 2
    return {
        "ln_scale": r.ones((in_dim,)), "ln_bias": r.zeros((in_dim,)),
        "fc1_kernel": r.normal((in_dim, llm_e), 0.02), "fc1_bias": r.zeros((llm_e,)),
        "fc2_kernel": r.normal((llm_e, llm_e), 0.02), "fc2_bias": r.zeros((llm_e,)),
    }


def init_resampler(r: _Init, cfg: ResamplerConfig) -> Dict[str, Any]:
    E, L, inner, F = cfg.dim, cfg.depth, cfg.dim_head * cfg.heads, cfg.ff_mult * cfg.dim
    out = {} if cfg.out_dim is None else {
        "out_kernel": r.normal((E, cfg.out_dim), 0.02), "out_bias": r.zeros((cfg.out_dim,)),
    }
    return {
        **out,
        "learns": r.normal((cfg.num_learns, E)),
        "layers": {
            "norm_media_scale": r.ones((L, E)), "norm_media_bias": r.zeros((L, E)),
            "norm_learns_scale": r.ones((L, E)), "norm_learns_bias": r.zeros((L, E)),
            "to_q": r.normal((L, E, inner), 0.02), "to_kv": r.normal((L, E, 2 * inner), 0.02),
            "to_out": r.normal((L, inner, E), 0.02),
            "ff_norm_scale": r.ones((L, E)), "ff_norm_bias": r.zeros((L, E)),
            "ff1": r.normal((L, E, F), 0.02), "ff1_bias": r.zeros((L, F)),
            "ff2": r.normal((L, F, E), 0.02), "ff2_bias": r.zeros((L, E)),
        },
        "norm_scale": r.ones((E,)), "norm_bias": r.zeros((E,)),
    }


def init_orderformer(r: _Init, cfg: OrderFormerConfig) -> Dict[str, Any]:
    L, E, F = cfg.num_layers, cfg.model_dim, cfg.ff_dim
    f32 = torch.float32

    def xavier(shape):
        fan_in, fan_out = shape[-2], shape[-1]
        return r.uniform(shape, math.sqrt(6.0 / (fan_in + fan_out)), f32)

    return {
        "embed_kernel": xavier((cfg.input_dim, E)), "embed_bias": r.zeros((E,), f32),
        "layers": {
            "in_proj_kernel": xavier((L, E, 3 * E)), "in_proj_bias": r.zeros((L, 3 * E), f32),
            "out_proj_kernel": xavier((L, E, E)), "out_proj_bias": r.zeros((L, E), f32),
            "norm1_scale": r.ones((L, E), f32), "norm1_bias": r.zeros((L, E), f32),
            "norm2_scale": r.ones((L, E), f32), "norm2_bias": r.zeros((L, E), f32),
            "ff1_kernel": xavier((L, E, F)), "ff1_bias": r.zeros((L, F), f32),
            "ff2_kernel": xavier((L, F, E)), "ff2_bias": r.zeros((L, E), f32),
        },
        "decode_kernel": xavier((E, cfg.output_dim)),
        "decode_bias": r.zeros((cfg.output_dim,), f32),
    }


def _det_channels(cfg: DetectorConfig) -> List[int]:
    w, mc = cfg.width_mult, cfg.max_channels
    return [max(8, int(64 * w)), max(8, int(128 * w)), max(8, int(256 * w)),
            max(8, int(512 * w)), max(8, int(min(1024, mc) * w))]


def init_detector(r: _Init, cfg: DetectorConfig) -> Dict[str, Any]:
    """The JAX detector tree (HWIO convs, post-BN-fold biases)."""
    ch = _det_channels(cfg)
    n3, n6 = (max(1, round(n * cfg.depth_mult)) for n in (3, 6))

    def conv(cin, cout, k):
        return {"w": r.uniform((k, k, cin, cout), 1.0 / math.sqrt(cin * k * k)),
                "b": r.zeros((cout,), torch.float32)}

    def c2f(cin, cout, n):
        c = cout // 2
        return {"cv1": conv(cin, cout, 1), "cv2": conv((2 + n) * c, cout, 1),
                "blocks": [{"cv1": conv(c, c, 3), "cv2": conv(c, c, 3)} for _ in range(n)]}

    def branch(cin, mid, cout):
        return {"cv1": conv(cin, mid, 3), "cv2": conv(mid, mid, 3), "out": conv(mid, cout, 1)}

    box_c = max(16, ch[2] // 4, 4 * cfg.reg_max)
    cls_c = max(ch[2], min(cfg.num_classes, 100))
    return {
        "backbone": {
            "stem": conv(3, ch[0], 3), "down1": conv(ch[0], ch[1], 3),
            "c2f1": c2f(ch[1], ch[1], n3), "down2": conv(ch[1], ch[2], 3),
            "c2f2": c2f(ch[2], ch[2], n6), "down3": conv(ch[2], ch[3], 3),
            "c2f3": c2f(ch[3], ch[3], n6), "down4": conv(ch[3], ch[4], 3),
            "c2f4": c2f(ch[4], ch[4], n3),
            "sppf": {"cv1": conv(ch[4], ch[4] // 2, 1), "cv2": conv(ch[4] // 2 * 4, ch[4], 1)},
        },
        "neck": {
            "c2f_p4": c2f(ch[4] + ch[3], ch[3], n3), "c2f_p3": c2f(ch[3] + ch[2], ch[2], n3),
            "down_p3": conv(ch[2], ch[2], 3), "c2f_n4": c2f(ch[2] + ch[3], ch[3], n3),
            "down_p4": conv(ch[3], ch[3], 3), "c2f_n5": c2f(ch[3] + ch[4], ch[4], n3),
        },
        "head": {
            f"p{i}": {"box": branch(cin, box_c, 4 * cfg.reg_max),
                      "cls": branch(cin, cls_c, cfg.num_classes)}
            for i, cin in zip((3, 4, 5), (ch[2], ch[3], ch[4]))
        },
    }


def init_params(cfg: VLMConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device="cuda", *, llm_int8: bool = False) -> Dict[str, Any]:
    """Seeded full-width random init of the whole engine tree (the JAX
    engine's ``init_all_params`` layout). Detector and OrderFormer are fp32.
    ``llm_int8``: the LLM is drawn directly as int8 + scales in the fused
    layout (runtime/quantize.init_llm_int8), never as a bf16 tree."""
    r = _Init(generator, device, dtype)
    V, E = cfg.llm.vocab_size, cfg.llm.hidden_size
    llm = (quantize.init_llm_int8(cfg.llm, generator, dtype=dtype, device=device) if llm_int8
           else init_llm(r, cfg.llm))
    out = {
        "llm": llm,
        "vision": init_vision(r, cfg.vision),
        "projector": init_projector(r, cfg),
        "resampler": init_resampler(r, cfg.resampler),
        "orderformer": init_orderformer(r, cfg.orderformer),
        "detector": init_detector(r, cfg.detector),
        "align": {
            "normed_emb": r.normal((V, E)),
            "mu": r.zeros((V,), torch.float32),
            "sigma": r.ones((V,), torch.float32),
        },
    }
    if cfg.char_vision is not None:
        out["char_vision"] = init_vision(r, cfg.char_vision)
        out["char_projector"] = init_projector(
            r, cfg, vit_hidden=cfg.char_vision.hidden_size, out_dim=cfg.resampler.dim)
    return out


# ------------------------------------------------------------ trained assets

CHAR_VISION_V3 = VisionConfig(
    hidden_size=256, intermediate_size=1024, num_hidden_layers=6,
    num_attention_heads=8, image_size=224, patch_size=14,
)
CHAR_RESAMPLER_V3 = ResamplerConfig(
    dim=512, depth=3, dim_head=64, heads=8, num_learns=3, ff_mult=2, out_dim=4096,
)


def asset_version(path) -> int:
    z = np.load(path, allow_pickle=False)
    return json.loads(str(z["meta"])).get("version", 1)


def v3_configs(meta: Dict) -> Tuple[VisionConfig, ResamplerConfig]:
    """The compact tower's architecture from the asset meta (shipping
    defaults where the meta is silent)."""
    return (dataclasses.replace(CHAR_VISION_V3, **meta.get("char_vision", {})),
            dataclasses.replace(CHAR_RESAMPLER_V3, **meta.get("char_resampler", {})))


def load_v3_asset(path, dtype, device) -> Tuple[Dict, Dict]:
    """callialign.npz v3 -> ({char_vision, char_projector, resampler}, meta)."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    stack: Dict = {}
    for k in z.files:
        if not k.startswith("v3/"):
            continue
        node = stack
        parts = k[3:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(z[k].astype(np.float32)).to(device, dtype)
    return stack, meta


def apply_v3_asset(cfg: VLMConfig, path, dtype, device):
    """-> (stack params, cfg with the asset's compact char_vision and
    resampler, meta)."""
    stack, meta = load_v3_asset(path, dtype, device)
    vcfg, rcfg = v3_configs(meta)
    return stack, dataclasses.replace(cfg, char_vision=vcfg, resampler=rcfg), meta


def overlay_trained_assets(params: Dict, cfg: VLMConfig, *, dtype, device) -> Tuple[VLMConfig, List[str]]:
    """The committed detector, OrderFormer and compact CalliAlign tower over a
    random init, where the preset's architecture matches them (the JAX
    cli/common._overlay_trained_assets rule). Returns (cfg, loaded names)."""
    loaded = []
    det_d, of_d = DetectorConfig(), OrderFormerConfig()
    if all(getattr(cfg.detector, f) == getattr(det_d, f) for f in
           ("num_classes", "depth_mult", "width_mult", "max_channels", "reg_max", "img_size")):
        path = ASSETS_DIR / "detector_640.npz"
        if path.exists():
            params["detector"] = detector_mod.load_npz(str(path), device)
            loaded.append("detector")
    if all(getattr(cfg.orderformer, f) == getattr(of_d, f) for f in
           ("input_dim", "model_dim", "num_heads", "num_layers", "output_dim", "ff_dim")):
        path = ASSETS_DIR / "orderformer.npz"
        if path.exists():
            params["orderformer"] = detector_mod.load_npz(str(path), device)
            loaded.append("orderformer")
    ca = ASSETS_DIR / "callialign.npz"
    if (cfg.resampler == ResamplerConfig() and cfg.char_vision is None
            and cfg.llm.hidden_size == 4096 and ca.exists() and asset_version(ca) >= 3):
        stack, cfg, _meta = apply_v3_asset(cfg, ca, dtype, device)
        params.update(stack)
        loaded.append("callialign")
    return cfg, loaded
