"""Operations and bytes that the cells' work needs, from shapes alone: the
yardstick of every roofline and mfu metric. A product of (m, k) by (k, n)
counts 2 m k n operations; attention counts its two products over the pairs
that are attended (causal pairs, the valid keys of a decode step), not over
padding; each input byte is read once and each output byte written once,
whatever a kernel reads again. Nothing here reads the program.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

PEAKS = {
    # NVIDIA H100 SXM data sheet, dense rates
    "bf16_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}


# ------------------------------------------------------------------ towers


def vit_flops(cfg: Dict, tiles: int) -> float:
    """InternViT forward over ``tiles`` images at the tower's native size:
    patch embed, per layer qkv / proj / fc1 / fc2 and the two attention
    products over every (query, key) pair of the 1 + patches tokens."""
    E, M, L = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    P, C = cfg["patch_size"], 3
    patches = (cfg["image_size"] // P) ** 2
    S = patches + 1
    per_layer = 2 * S * (E * 3 * E + E * E + 2 * E * M) + 2 * 2 * S * S * E
    return tiles * (2 * patches * C * P * P * E + L * per_layer)


def projector_flops(vit_hidden: int, out_dim: int, tokens: int, images: int) -> float:
    """Pixel-shuffle projector: (4 E_vit -> out) then (out -> out) per token."""
    return images * 2 * tokens * (4 * vit_hidden * out_dim + out_dim * out_dim)


def resampler_flops(cfg: Dict, media: int, crops: int) -> float:
    """Perceiver resampler over ``media`` tokens a crop, plus the out projection."""
    dim, inner, nl = cfg["dim"], cfg["heads"] * cfg["dim_head"], cfg["num_learns"]
    ff = cfg["ff_mult"] * dim
    kv = media + nl
    per_layer = 2 * (nl * dim * inner + kv * dim * 2 * inner + 2 * nl * kv * inner
                     + nl * inner * dim + 2 * nl * dim * ff)
    out = 2 * nl * dim * cfg["out_dim"] if cfg.get("out_dim") else 0
    return crops * (cfg["depth"] * per_layer + out)


def vq_flops(dim: int, vocab: int, rows: int) -> float:
    """Cosine similarity of each pseudo row against the token table."""
    return 2 * rows * dim * vocab


# --------------------------------------------------------------------- LLM


def llm_layer_params(cfg: Dict) -> int:
    E, M = cfg["hidden_size"], cfg["intermediate_size"]
    D = E // cfg["num_attention_heads"]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return E * (Hq + 2 * Hkv) * D + Hq * D * E + 3 * E * M


def causal_pairs(lengths: Iterable[int]) -> int:
    """(query, key) pairs of causal attention within segments of these lengths."""
    return sum(n * (n + 1) // 2 for n in lengths)


def attention_flops(cfg: Dict, pairs: int) -> float:
    """QK^T and PV over ``pairs`` attended pairs, every layer and query head."""
    D = cfg["hidden_size"] // cfg["num_attention_heads"]
    return 4.0 * pairs * cfg["num_attention_heads"] * D * cfg["num_hidden_layers"]


def prefill_flops(cfg: Dict, lengths: Sequence[int], vocab: int) -> float:
    """Prompts of ``lengths`` valid tokens (padding not counted), causal,
    with the LM head at each prompt's last position."""
    n = sum(lengths)
    return (2.0 * n * cfg["num_hidden_layers"] * llm_layer_params(cfg)
            + attention_flops(cfg, causal_pairs(lengths))
            + 2.0 * len(lengths) * cfg["hidden_size"] * vocab)


def decode_flops(cfg: Dict, lengths: Sequence[int], steps: int, vocab: int) -> float:
    """``steps`` tokens for each row whose prompt has ``lengths`` valid tokens:
    the products and LM head per token, attention over the valid keys."""
    rows = len(lengths)
    per_token = 2.0 * (cfg["num_hidden_layers"] * llm_layer_params(cfg) + cfg["hidden_size"] * vocab)
    keys = sum(n * steps + steps * (steps + 1) // 2 for n in lengths)
    return rows * steps * per_token + attention_flops(cfg, keys)


# ------------------------------------------------------- decode kernel bytes


def int8_kn_shapes(cfg: Dict):
    """(K, N) of the four fused weight-only products of one layer."""
    E, M = cfg["hidden_size"], cfg["intermediate_size"]
    D = E // cfg["num_attention_heads"]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    return [(E, (Hq + 2 * Hkv) * D), (Hq * D, E), (E, 2 * M), (M, E)]


def int8_kn_bytes(K: int, N: int, rows: int) -> int:
    """int8 weight, fp32 scale, bf16 rows in and out."""
    return K * N + 4 * N + 2 * rows * K + 2 * rows * N


def int8_nt_bytes(K: int, N: int, rows: int) -> int:
    """The LM head: int8 (N, K) table, fp32 per-row scale, bf16 rows in and out."""
    return N * K + 4 * N + 2 * rows * K + 2 * rows * N


def decode_step_int8_bytes(cfg: Dict, rows: int) -> int:
    """The (K, N) products of one decode step over every layer."""
    return cfg["num_hidden_layers"] * sum(int8_kn_bytes(K, N, rows) for K, N in int8_kn_shapes(cfg))


def flash_decode_bytes(cfg: Dict, valid_keys: int, rows: int, cache_len: int) -> int:
    """One layer's decode attention over ``valid_keys`` keys summed over the
    rows: bf16 K and V of the valid keys only, the bf16 query and output,
    the int32 validity row of each cache."""
    E = cfg["hidden_size"]
    D = E // cfg["num_attention_heads"]
    Hkv = cfg["num_key_value_heads"]
    return valid_keys * Hkv * D * 2 * 2 + 2 * 2 * rows * E + 4 * rows * cache_len


def decode_valid_keys(lengths: Sequence[int], steps: int) -> int:
    """Keys attended over ``steps`` decode steps, summed over the rows: step j
    of a row with a prompt of n valid tokens attends n + j + 1 keys."""
    return sum(n * steps + steps * (steps + 1) // 2 for n in lengths)


# ------------------------------------------------------------------ training


def lora_flops(cfg: Dict, rank: int, tokens: int, targets: Sequence[str]) -> Dict[str, float]:
    """LoRA adapters on ``targets`` over ``tokens`` tokens, every layer:
    forward (h A, then (h A) B), and backward: dX through both and dA, dB."""
    E, M = cfg["hidden_size"], cfg["intermediate_size"]
    D = E // cfg["num_attention_heads"]
    Hq, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dims = {"wq": (E, Hq * D), "wk": (E, Hkv * D), "wv": (E, Hkv * D), "wo": (Hq * D, E),
            "w1": (E, M), "w3": (E, M), "w2": (M, E)}
    fwd = sum(2.0 * tokens * rank * (dims[t][0] + dims[t][1]) for t in targets)
    return {"forward": cfg["num_hidden_layers"] * fwd,
            "backward": cfg["num_hidden_layers"] * 2 * fwd}


LORA_TARGETS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def eit_step_flops(cfg: Dict, step: Dict, rank: int) -> float:
    """One e-IT micro-step over its non-pad tokens (``step``: the rows'
    ``lengths`` and the ``tiles``): the frozen tile tower's forward; the
    projector's forward and weight gradient; the LLM's forward and the
    backward of its activations through the frozen base; attention over the
    causal pairs of each row (forward, and the backward's five products);
    the LoRA products with their input and weight gradients; the LM head
    forward and its input gradient. The recompute of remat is not counted."""
    v, llm = cfg["vision"], cfg["llm"]
    E, V, L = llm["hidden_size"], llm["vocab_size"], llm["num_hidden_layers"]
    n = sum(step["lengths"])
    lora = lora_flops(llm, rank, n, LORA_TARGETS)
    return (vit_flops(v, step["tiles"])
            + 2 * projector_flops(v["hidden_size"], E, cfg["num_image_token"], step["tiles"])
            + 2 * (2.0 * n * L * llm_layer_params(llm)) + 2 * (2.0 * n * E * V)
            + attention_flops(llm, causal_pairs(step["lengths"])) * (1 + 10 / 4)
            + lora["forward"] + lora["backward"])
