"""The draws of the MLA-MoE page cell (``configs/moonlight_16b_a3b_bf16.json``)
that ``weights.py`` has no stream for: the Moonlight LLM in the published
block's layout, and the compact char tower drawn at the LLM's width (the
committed CalliAlign asset reads out at 4096). Each component has its own
generator, (seed, component) -> its stream, on the device, in bf16 (the
correction bias in fp32). The program gets these trees and derives its own
layout (fused expert gate / up, the absorbed halves of W_kv_b); the plain
reference draws the same trees again after the window.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from chipbench import weights

# beside weights.STREAMS (1 .. 6)
STREAMS = {"llm": 11, "char_vision": 12, "char_projector": 13, "resampler": 14}


class Draw(weights.Draw):
    """weights.Draw on a stream of this file's."""

    def __init__(self, seed: int, stream: str, device, dtype=torch.bfloat16):
        self.g = torch.Generator(device=device).manual_seed((int(seed) * 64 + STREAMS[stream]) % (1 << 63))
        self.device, self.dtype = device, dtype


def draw_llm(cfg: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The MLA-MoE LLM: N(0, 0.02) matrices, unit norms, the correction bias
    N(0, 1e-2) in fp32 (small beside the scores' spread, nonzero: it moves
    about one token's choice in two, so the selection path is exercised).
    Kernels (in, out), layers stacked; experts (layers, experts, in, out)."""
    r = Draw(seed, "llm", device, dtype)
    L, E, V, H = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["vocab_size"], cfg["num_attention_heads"]
    R, Dr = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    Dn, Dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    Ld = cfg["first_k_dense_replace"]
    Lm, n = L - Ld, cfg["n_routed_experts"]
    M, Me = cfg["intermediate_size"], cfg["moe_intermediate_size"]
    Ms = cfg["n_shared_experts"] * Me
    s = 0.02
    return {
        "tok_embeddings": r.normal((V, E), s),
        "layers": {
            "attn_norm": r.full((L, E), 1.0), "wq": r.normal((L, E, H * (Dn + Dr)), s),
            "wkv_a": r.normal((L, E, R + Dr), s), "kv_norm": r.full((L, R), 1.0),
            "wkv_b": r.normal((L, R, H * (Dn + Dv)), s), "wo": r.normal((L, H * Dv, E), s),
            "ffn_norm": r.full((L, E), 1.0),
        },
        "dense": {"w1": r.normal((Ld, E, M), s), "w3": r.normal((Ld, E, M), s), "w2": r.normal((Ld, M, E), s)},
        "moe": {
            "gate": r.normal((Lm, E, n), s), "gate_bias": r.normal((Lm, n), 1e-2, torch.float32),
            "w1": r.normal((Lm, n, E, Me), s), "w3": r.normal((Lm, n, E, Me), s),
            "w2": r.normal((Lm, n, Me, E), s),
            "shared_w1": r.normal((Lm, E, Ms), s), "shared_w3": r.normal((Lm, E, Ms), s),
            "shared_w2": r.normal((Lm, Ms, E), s),
        },
        "norm": r.full((E,), 1.0),
        "output": r.normal((V, E), s),
    }


def draw_char_tower(cfg: Dict, seed: int, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The compact char tower at the configuration's shapes (``char_tower``:
    its ``vision`` and ``resampler``): InternViT (N(0, 0.02), zero biases,
    unit norms and layer scales), its pixel-shuffle projector (4 E_vit ->
    resampler dim, twice), the perceiver resampler with its readout to the
    LLM's width -> {char_vision, char_projector, resampler}."""
    v, rc = cfg["char_tower"]["vision"], cfg["char_tower"]["resampler"]
    r = Draw(seed, "char_vision", device, dtype)
    L, E, M, P = v["num_hidden_layers"], v["hidden_size"], v["intermediate_size"], v["patch_size"]
    n = (v["image_size"] // P) ** 2 + 1
    vit = {
        "patch_embed": {"kernel": r.normal((3 * P * P, E), 0.02), "bias": r.full((E,), 0.0)},
        "cls_token": r.normal((1, 1, E), 0.02), "pos_embed": r.normal((1, n, E), 0.02),
        "layers": {
            "norm1_scale": r.full((L, E), 1.0), "norm1_bias": r.full((L, E), 0.0),
            "norm2_scale": r.full((L, E), 1.0), "norm2_bias": r.full((L, E), 0.0),
            "qkv_kernel": r.normal((L, E, 3 * E), 0.02), "qkv_bias": r.full((L, 3 * E), 0.0),
            "proj_kernel": r.normal((L, E, E), 0.02), "proj_bias": r.full((L, E), 0.0),
            "fc1_kernel": r.normal((L, E, M), 0.02), "fc1_bias": r.full((L, M), 0.0),
            "fc2_kernel": r.normal((L, M, E), 0.02), "fc2_bias": r.full((L, E), 0.0),
            "ls1": r.full((L, E), 1.0), "ls2": r.full((L, E), 1.0),
        },
    }
    r = Draw(seed, "char_projector", device, dtype)
    d, dim = 4 * E, rc["dim"]
    proj = {"ln_scale": r.full((d,), 1.0), "ln_bias": r.full((d,), 0.0),
            "fc1_kernel": r.normal((d, dim), 0.02), "fc1_bias": r.full((dim,), 0.0),
            "fc2_kernel": r.normal((dim, dim), 0.02), "fc2_bias": r.full((dim,), 0.0)}
    r = Draw(seed, "resampler", device, dtype)
    Lr, inner, F = rc["depth"], rc["dim_head"] * rc["heads"], rc["ff_mult"] * dim
    res = {
        "out_kernel": r.normal((dim, rc["out_dim"]), 0.02), "out_bias": r.full((rc["out_dim"],), 0.0),
        "learns": r.normal((rc["num_learns"], dim), 1.0),
        "layers": {
            "norm_media_scale": r.full((Lr, dim), 1.0), "norm_media_bias": r.full((Lr, dim), 0.0),
            "norm_learns_scale": r.full((Lr, dim), 1.0), "norm_learns_bias": r.full((Lr, dim), 0.0),
            "to_q": r.normal((Lr, dim, inner), 0.02), "to_kv": r.normal((Lr, dim, 2 * inner), 0.02),
            "to_out": r.normal((Lr, inner, dim), 0.02),
            "ff_norm_scale": r.full((Lr, dim), 1.0), "ff_norm_bias": r.full((Lr, dim), 0.0),
            "ff1": r.normal((Lr, dim, F), 0.02), "ff1_bias": r.full((Lr, F), 0.0),
            "ff2": r.normal((Lr, F, dim), 0.02), "ff2_bias": r.full((Lr, dim), 0.0),
        },
        "norm_scale": r.full((dim,), 1.0), "norm_bias": r.full((dim,), 0.0),
    }
    return {"char_vision": vit, "char_projector": proj, "resampler": res}
