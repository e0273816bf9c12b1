"""Perceiver resampler, the CalliAlign core (PyTorch port of
callireader_tpu/models/resampler.py).

(B, N, dim) media features -> (B, num_learns, dim): per layer the learned
queries cross-attend over concat(media, learns), then a LayerNorm-MLP; a
final LayerNorm and, for the compact tower, a dim -> out_dim projection into
the token-table space. The attention here is a (3 x ~260) product per head:
plain torch ops, as the JAX package left it to XLA. ``lora`` adds the
CalliAlign trainer's functional deltas over LORA_MATS.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from callireader_tpu_torch.core.config import ResamplerConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.models.internvit import layer_norm

Params = Dict[str, Any]
LN_EPS = 1e-5
LORA_MATS = ("to_q", "to_kv", "to_out", "ff1", "ff2")


def logical_axes(cfg: ResamplerConfig) -> Params:
    """Logical sharding annotations (core/partition.py)."""
    out = {} if cfg.out_dim is None else {
        "out_kernel": ("embed", None), "out_bias": (None,),
    }
    return {
        **out,
        "learns": (None, "embed"),
        "layers": {
            "norm_media_scale": ("stack", "norm"), "norm_media_bias": ("stack", "norm"),
            "norm_learns_scale": ("stack", "norm"), "norm_learns_bias": ("stack", "norm"),
            "to_q": ("stack", "embed", "qkv"),
            "to_kv": ("stack", "embed", "qkv"),
            "to_out": ("stack", "qkv", "embed"),
            "ff_norm_scale": ("stack", "norm"), "ff_norm_bias": ("stack", "norm"),
            "ff1": ("stack", "embed", "mlp"), "ff1_bias": ("stack", "mlp"),
            "ff2": ("stack", "mlp", "embed"), "ff2_bias": ("stack", "norm"),
        },
        "norm_scale": ("norm",), "norm_bias": ("norm",),
    }


def forward(
    params: Params,
    cfg: ResamplerConfig,
    x: torch.Tensor,
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
    lora: Optional[Params] = None,
    lora_scale: float = 1.0,
) -> torch.Tensor:
    """-> (B, num_learns, dim or out_dim). ``lora``: {name_a: (L, in, r),
    name_b: (L, r, out)} float32 deltas over the LORA_MATS matrices, applied
    as ``(h @ A) @ B`` in float32 and added in the compute dtype, as the JAX
    forward does (the trainer never materialises the merged matrices)."""
    B = x.shape[0]
    H, Dh = cfg.heads, cfg.dim_head
    scale = Dh**-0.5
    cd = policy.compute_dtype
    x = x.to(cd)
    learns = params["learns"].to(cd).expand(B, cfg.num_learns, cfg.dim)
    lp = params["layers"]

    def heads(t):
        return t.reshape(B, t.shape[1], H, Dh).transpose(1, 2)

    def mm(h, i, name):
        out = h @ lp[name][i].to(cd)
        if lora is not None:
            d = (h.float() @ lora[name + "_a"][i]) @ lora[name + "_b"][i]
            out = out + (lora_scale * d).to(out.dtype)
        return out

    for i in range(cfg.depth):
        xm = layer_norm(x, lp["norm_media_scale"][i], lp["norm_media_bias"][i], LN_EPS, policy)
        ln = layer_norm(learns, lp["norm_learns_scale"][i], lp["norm_learns_bias"][i], LN_EPS, policy)
        q = mm(ln, i, "to_q")
        kv = mm(torch.cat([xm, ln], dim=1), i, "to_kv")
        k, v = kv.chunk(2, dim=-1)
        q, k, v = heads(q), heads(k), heads(v)
        sim = (q * scale).float() @ k.float().transpose(-1, -2)
        sim = sim - sim.amax(dim=-1, keepdim=True).detach()
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, -1, H * Dh)
        learns = mm(out, i, "to_out") + learns

        h = layer_norm(learns, lp["ff_norm_scale"][i], lp["ff_norm_bias"][i], LN_EPS, policy)
        h = mm(h, i, "ff1") + lp["ff1_bias"][i].to(cd)
        h = F.gelu(h, approximate="none")
        h = mm(h, i, "ff2") + lp["ff2_bias"][i].to(cd)
        learns = learns + h
    learns = layer_norm(learns, params["norm_scale"], params["norm_bias"], LN_EPS, policy)
    if cfg.out_dim is not None:
        learns = learns @ params["out_kernel"].to(cd) + params["out_bias"].to(cd)
    return learns


# ---------------------------------------------------------------------------
# MLP-resampler ablation variants (reference perceiver_resampler.py:102-154;
# not on the main CalliAlign path, kept for checkpoint/ablation parity). The
# ``init_*`` draw N(0, 0.02) in float32 from ``generator`` and cast;
# from_jax_params carries the JAX package's trees of these as they are.
# ---------------------------------------------------------------------------


def init_ff2(generator: torch.Generator, input_dim: int, output_dim: int, mult: int = 4,
             dtype=torch.float32, device="cpu") -> Params:
    """FeedForward_2: LayerNorm -> Linear(in, in*mult) -> GELU -> Linear(in*mult, out)."""
    def normal(shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * 0.02).to(dtype)

    return {
        "norm_scale": torch.ones((input_dim,), dtype=dtype, device=device),
        "norm_bias": torch.zeros((input_dim,), dtype=dtype, device=device),
        "w1": normal((input_dim, input_dim * mult)),
        "b1": torch.zeros((input_dim * mult,), dtype=dtype, device=device),
        "w2": normal((input_dim * mult, output_dim)),
        "b2": torch.zeros((output_dim,), dtype=dtype, device=device),
    }


def ff2(params: Params, x: torch.Tensor, *, policy: DTypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    h = layer_norm(x, params["norm_scale"], params["norm_bias"], LN_EPS, policy)
    h = h @ params["w1"].to(h.dtype) + params["b1"].to(h.dtype)
    h = F.gelu(h, approximate="none")
    return h @ params["w2"].to(h.dtype) + params["b2"].to(h.dtype)


def init_mlp_resampler(generator: torch.Generator, num_tokens: int = 256, mult: int = 4,
                       dtype=torch.float32, device="cpu") -> Params:
    """MLP variant: squeezes the 256 patch tokens down to 3 along the token
    axis (reference :102-115 permutes, runs two FeedForward_2 over tokens)."""
    return {
        "ff1": init_ff2(generator, num_tokens, num_tokens, mult, dtype, device),
        "ff2": init_ff2(generator, num_tokens, 3, mult, dtype, device),
    }


def mlp_resampler(params: Params, x: torch.Tensor, *,
                  policy: DTypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """(B, N, E) -> (B, 3, E): token-axis MLP."""
    h = x.transpose(1, 2)  # (B, E, N)
    h = ff2(params["ff1"], h, policy=policy)
    h = ff2(params["ff2"], h, policy=policy)
    return h.transpose(1, 2)


def init_mlp_6763(generator: torch.Generator, input_dim: int, output_dim: int, mult: int = 2,
                  dtype=torch.float32, device="cpu") -> Params:
    return {
        "ff1": init_ff2(generator, input_dim, output_dim, mult, dtype, device),
        "ff2": init_ff2(generator, output_dim, output_dim, mult, dtype, device),
    }


def mlp_6763(params: Params, x: torch.Tensor, *, policy: DTypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """(B, N, E) -> (B, output_dim): flatten then two FeedForward_2 blocks
    (reference :117-128; classifier-style ablation head)."""
    h = x.reshape(x.shape[0], -1)
    h = ff2(params["ff1"], h, policy=policy)
    return ff2(params["ff2"], h, policy=policy)
