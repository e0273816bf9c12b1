"""Operations and bytes of the MLA-MoE page cell's language model
(Moonlight-16B-A3B, ``configs/moonlight_16b_a3b_bf16.json``), from shapes
alone, as ``flops.py`` counts them: a product of (m, k) by (k, n) is
2 m k n operations; attention counts its products over the attended pairs
(causal pairs of the valid prompt tokens, the valid keys of a decode step),
never over padding; an expert layer counts the experts a token uses (its
``num_experts_per_tok`` routed and the shared ones) and the router; each
input byte is read once and each output byte written once. The one number
of the program read here is the expert layer's count of touched experts
(``moe.experts_touched``), which the caller passes in.
"""

from __future__ import annotations

from typing import Dict, Sequence

from chipbench import flops

PEAKS = flops.PEAKS


def _dims(cfg: Dict):
    return (cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"], cfg["qk_rope_head_dim"],
            cfg["qk_nope_head_dim"], cfg["v_head_dim"])


def attention_params(cfg: Dict, absorbed: bool) -> int:
    """A layer's attention projections a token: W_q, W_kv_a, W_o and W_kv_b
    (the prefill expands k_nope and v from the latents), or in its place
    W_kb and W_vb head by head (the decode's absorbed form)."""
    E, H, R, Dr, Dn, Dv = _dims(cfg)
    kv_b = H * Dn * R + H * R * Dv if absorbed else R * H * (Dn + Dv)
    return E * H * (Dn + Dr) + E * (R + Dr) + kv_b + H * Dv * E


def routed_params(cfg: Dict) -> int:
    """One routed expert's gate, up and down."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def ffn_params(cfg: Dict) -> int:
    """The feed-forward products a token uses over every layer: the dense
    layers' SwiGLU; in each expert layer its router, routed and shared experts."""
    E, n, k = cfg["hidden_size"], cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    Ld = cfg["first_k_dense_replace"]
    Lm = cfg["num_hidden_layers"] - Ld
    shared = 3 * E * cfg["n_shared_experts"] * cfg["moe_intermediate_size"]
    return Ld * 3 * E * cfg["intermediate_size"] + Lm * (E * n + k * routed_params(cfg) + shared)


def prefill_flops(cfg: Dict, lengths: Sequence[int]) -> float:
    """Prompts of ``lengths`` valid tokens, causal, with the LM head at each
    prompt's last position."""
    E, H, R, Dr, Dn, Dv = _dims(cfg)
    L = cfg["num_hidden_layers"]
    n = sum(lengths)
    per_token = L * attention_params(cfg, absorbed=False) + ffn_params(cfg)
    attention = 2.0 * flops.causal_pairs(lengths) * H * (Dn + Dr + Dv) * L
    return 2.0 * n * per_token + attention + 2.0 * len(lengths) * E * cfg["vocab_size"]


def decode_flops(cfg: Dict, lengths: Sequence[int], steps: int) -> float:
    """``steps`` tokens a row (prompts of ``lengths`` valid tokens): the
    absorbed form's products and the LM head a token, attention over the
    latent rows of the valid keys (scores over R + Dr, values over R)."""
    E, H, R, Dr, Dn, Dv = _dims(cfg)
    L = cfg["num_hidden_layers"]
    per_token = L * attention_params(cfg, absorbed=True) + ffn_params(cfg) + E * cfg["vocab_size"]
    keys = flops.decode_valid_keys(lengths, steps)
    return 2.0 * len(lengths) * steps * per_token + 2.0 * keys * H * (R + Dr + R) * L


def expert_prefill_flops(cfg: Dict, lengths: Sequence[int]) -> float:
    """The grouped expert kernel's products over a prefill's valid prompt
    tokens: each token's routed experts, every expert layer."""
    Lm = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    return 2.0 * sum(lengths) * cfg["num_experts_per_tok"] * routed_params(cfg) * Lm


def expert_decode_bytes(cfg: Dict, touched: int, tokens: int) -> float:
    """The grouped expert kernel's bytes over decode steps of ``tokens``
    (rows x steps) tokens: each touched (step, layer, expert)'s bf16 gate, up
    and down once, and each routed row in and out of both products."""
    E, Me = cfg["hidden_size"], cfg["moe_intermediate_size"]
    Lm = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    rows = tokens * cfg["num_experts_per_tok"] * Lm
    return 2.0 * (touched * routed_params(cfg) + rows * 2 * (E + Me))


def latent_decode_bytes(cfg: Dict, lengths: Sequence[int], steps: int) -> float:
    """The latent decode kernel's bytes over ``steps`` steps of rows whose
    prompts have ``lengths`` valid tokens, every layer: each valid key's bf16
    latent row once a step, the absorbed queries in and the latent outputs out."""
    E, H, R, Dr, Dn, Dv = _dims(cfg)
    keys = flops.decode_valid_keys(lengths, steps)
    qo = len(lengths) * steps * H * (R + Dr + R)
    return 2.0 * cfg["num_hidden_layers"] * (keys * (R + Dr) + qo)
