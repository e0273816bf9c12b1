"""InternLM2-style decoder (PyTorch port of callireader_tpu/models/internlm2.py).

GQA attention, rotate-half RoPE with the dynamic-NTK rule, SwiGLU MLP, fp32
RMSNorm statistics, untied LM head. Same parameter tree as the JAX package
(layers stacked on axis 0, kernels (in, out), vocab tables (V, E)), in bf16
or with int8 weight-only leaves (runtime/quantize.py): ``{name}_q`` +
``{name}_scale``, split (wq/wk/wv, w1/w3) or fused (wqkv, w13), int8 vocab
tables, optionally padded to a multiple of 128 (``pad_vocab``; logits of the
pad rows are set to the dtype's minimum).

int8 dispatch (the JAX rule, with no environment knob): a product of at most
32 rows with K and N multiples of 128 goes through the int8 kernels
(kernels/int8_matmul.py: the decode projections and the LM head); any other
(the prefill's layer projections) takes the JAX package's XLA form,
``(h @ q.to(h.dtype)) * scale.to(h.dtype)``, which rounds the product before
the scale.

Entry points: ``prefill`` (prompt -> last logits + a fresh cache; attention
through kernels.attention.flash_attention) and ``decode_step`` (one token;
kernels.decode_attention.flash_decode over the stacked cache). The KV cache
is one preallocated (L, B, Hkv, max_len, D) buffer per K and V that both
entry points write IN PLACE: prefill fills [0, S), each decode step writes
slot ``cache.length`` of every layer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from callireader_tpu_torch.core.config import LLMConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.kernels.attention import flash_attention
from callireader_tpu_torch.kernels.decode_attention import flash_decode
from callireader_tpu_torch.kernels.int8_matmul import BLOCK, MAX_ROWS, int8_matmul, int8_matmul_nt

Params = Dict[str, Any]


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, policy: DTypePolicy) -> torch.Tensor:
    xf = x.to(policy.norm_dtype)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y.to(x.dtype) * weight.to(x.dtype)).to(policy.compute_dtype)


def _inv_freq(cfg: LLMConfig, base, device) -> torch.Tensor:
    exps = torch.arange(0, cfg.head_dim, 2, dtype=torch.float32, device=device) / cfg.head_dim
    return 1.0 / (base ** exps)


def cos_sin_for(cfg: LLMConfig, positions: torch.Tensor, kv_seq_len: int):
    """RoPE tables (B, S, D) for integer positions (B, S). Dynamic NTK
    rescales the base once the run's sequence (max position + 1) exceeds
    max_position_embeddings, which can only happen when the cache capacity
    ``kv_seq_len`` does. (Linear scaling, set only by the JAX package's
    long-context training recipe, is not ported.)"""
    pos = positions.float()
    dev = positions.device
    if cfg.rope_scaling_type == "dynamic" and kv_seq_len > cfg.max_position_embeddings:
        f = cfg.rope_scaling_factor
        mpe = float(cfg.max_position_embeddings)
        seq = positions.max().float() + 1.0
        scaled = cfg.rope_theta * ((f * seq / mpe) - (f - 1)) ** (cfg.head_dim / (cfg.head_dim - 2))
        base = torch.where(seq > mpe, scaled, torch.full_like(scaled, cfg.rope_theta))
        inv = _inv_freq(cfg, base, dev)
    else:
        inv = _inv_freq(cfg, torch.tensor(cfg.rope_theta, dtype=torch.float32, device=dev), dev)
    freqs = pos[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, S, D); cos/sin (B, S, D); rotate-half, in fp32."""
    cos = cos[:, None].float()
    sin = sin[:, None].float()
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (L, B, Hkv, max_len, D)
    v: torch.Tensor
    length: int  # valid positions (the next write slot)

    @classmethod
    def create(cls, cfg: LLMConfig, batch: int, max_len: int, dtype, device) -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, cfg.num_key_value_heads, max_len, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def _layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves: views into the stacks, no copy (an int8 weight
    q[i] is the layer's (K, N) block in place, which the TPU needed a
    scalar-prefetch kernel for)."""
    return {k: v[i] for k, v in params["layers"].items()}


def _rows(h: torch.Tensor) -> int:
    return h.numel() // h.shape[-1]


def _int8_kernel_route(rows: int, K: int, N: int) -> bool:
    return rows <= MAX_ROWS and K % BLOCK == 0 and N % BLOCK == 0


def _int8_mm(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """h @ dequant(q (K, N), scale (N,) or (1, N)): the int8 kernel for few
    rows, else the XLA form."""
    K, N = q.shape
    rows = _rows(h)
    if _int8_kernel_route(rows, K, N):
        y = int8_matmul(h.reshape(rows, K).contiguous(), q, scale.reshape(N))
        return y.reshape(*h.shape[:-1], N)
    return (h @ q.to(h.dtype)) * scale.reshape(N).to(h.dtype)


def _proj(p: Dict[str, torch.Tensor], h: torch.Tensor, name: str) -> torch.Tensor:
    """Linear ``name``: bf16 ``p[name]``, or int8 ``{name}_q`` + ``{name}_scale``."""
    q = p.get(f"{name}_q")
    if q is None:
        return h @ p[name].to(h.dtype)
    return _int8_mm(h, q, p[f"{name}_scale"])


def _qkv(p, h, cfg: LLMConfig):
    B, S, _ = h.shape
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    if "wqkv_q" in p:
        q, k, v = torch.split(_proj(p, h, "wqkv"), [Hq * D, Hkv * D, Hkv * D], dim=-1)
    else:
        q, k, v = _proj(p, h, "wq"), _proj(p, h, "wk"), _proj(p, h, "wv")
    q = q.reshape(B, S, Hq, D).transpose(1, 2)
    k = k.reshape(B, S, Hkv, D).transpose(1, 2)
    v = v.reshape(B, S, Hkv, D).transpose(1, 2)
    return q, k, v


def _mlp(p, x, cfg: LLMConfig, policy: DTypePolicy):
    h = rms_norm(x, p["ffn_norm"], cfg.rms_norm_eps, policy)
    if "w13_q" in p:
        g, up = _proj(p, h, "w13").chunk(2, dim=-1)
    else:
        g, up = _proj(p, h, "w1"), _proj(p, h, "w3")
    return x + _proj(p, F.silu(g) * up, "w2")


def embed_tokens(params: Params, input_ids: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Token embedding lookup; int8 rows are dequantized after the gather."""
    ids = input_ids.long()
    if "tok_embeddings_q" in params:
        return params["tok_embeddings_q"][ids].to(dtype) * params["tok_embeddings_scale"][ids].to(dtype)
    return params["tok_embeddings"][ids].to(dtype)


def _logits(params: Params, x: torch.Tensor, policy: DTypePolicy, cfg: LLMConfig) -> torch.Tensor:
    if "output_q" in params:
        q, scale = params["output_q"], params["output_scale"]  # (V, E), (V, 1)
        N, K = q.shape
        rows = _rows(x)
        if _int8_kernel_route(rows, K, N):
            y = int8_matmul_nt(x.reshape(rows, K).contiguous(), q, scale.reshape(N))
            y = y.reshape(*x.shape[:-1], N).to(policy.logits_dtype)
        else:
            y = ((x @ q.T.to(x.dtype)) * scale[:, 0].to(x.dtype)).to(policy.logits_dtype)
    else:
        y = (x @ params["output"].to(x.dtype).T).to(policy.logits_dtype)
    if cfg.real_vocab_size is not None and cfg.real_vocab_size < y.shape[-1]:
        # padded vocab rows (pad_vocab) never win argmax
        y[..., cfg.real_vocab_size:] = torch.finfo(y.dtype).min
    return y


def pad_vocab(params: Params, cfg: LLMConfig, multiple: int) -> Tuple[Params, LLMConfig]:
    """Zero-pad the vocab tables to a multiple of ``multiple`` (92553 rows
    become 92672 at 128, which the LM-head kernel needs); the returned config
    records ``real_vocab_size`` so ``_logits`` masks the pad rows."""
    if cfg.vocab_size % multiple == 0:
        return params, cfg
    V = cfg.vocab_size
    Vp = -(-V // multiple) * multiple
    out = dict(params)
    for name in ("tok_embeddings", "output", "tok_embeddings_q", "output_q",
                 "tok_embeddings_scale", "output_scale"):
        if name in out:
            w = out[name]
            out[name] = torch.cat([w, w.new_zeros((Vp - V,) + tuple(w.shape[1:]))])
    return out, dataclasses.replace(
        cfg, vocab_size=Vp,
        real_vocab_size=cfg.real_vocab_size if cfg.real_vocab_size is not None else V,
    )


def prefill(
    params: Params,
    cfg: LLMConfig,
    *,
    inputs_embeds: torch.Tensor,  # (B, S, E)
    attention_mask: torch.Tensor,  # (B, S) 1 = valid, left-padded
    max_len: int,
    cache_dtype=torch.bfloat16,
    policy: DTypePolicy = DEFAULT_POLICY,
) -> Tuple[torch.Tensor, KVCache]:
    """Prompt -> (last logits (B, V), cache of capacity ``max_len`` with
    length S). Padded positions get segment id -1 and position 0."""
    x = inputs_embeds.to(policy.compute_dtype)
    B, S, _ = x.shape
    dev = x.device
    attention_mask = attention_mask.to(torch.int32)
    positions = torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
    segment_ids = torch.where(attention_mask > 0, 0, -1).to(torch.int32)
    cos, sin = cos_sin_for(cfg, positions, max(S, 1))
    cache = KVCache.create(cfg, B, max_len, cache_dtype, dev)

    for i in range(cfg.num_hidden_layers):
        p = _layer(params, i)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps, policy)
        q, k, v = _qkv(p, h, cfg)
        q = apply_rope(q, cos, sin).contiguous()
        k = apply_rope(k, cos, sin).contiguous()
        v = v.contiguous()
        ctx = flash_attention(q, k, v, causal=True,
                              q_segment_ids=segment_ids, kv_segment_ids=segment_ids)
        # in-place cache fill of this layer's prompt slots
        cache.k[i, :, :, :S] = k.to(cache_dtype)
        cache.v[i, :, :, :S] = v.to(cache_dtype)
        x = x + _proj(p, ctx.transpose(1, 2).reshape(B, S, -1), "wo")
        x = _mlp(p, x, cfg, policy)
    x = rms_norm(x[:, -1:], params["norm"], cfg.rms_norm_eps, policy)
    cache.length = S
    return _logits(params, x, policy, cfg)[:, 0], cache


def decode_step(
    params: Params,
    cfg: LLMConfig,
    *,
    input_ids: torch.Tensor,  # (B, 1)
    cache: KVCache,
    kv_valid_mask: Optional[torch.Tensor] = None,  # (B, max_len) 1 = attendable
    policy: DTypePolicy = DEFAULT_POLICY,
) -> Tuple[torch.Tensor, KVCache]:
    """One token for every row -> (logits (B, V), cache). Writes slot
    ``cache.length`` of every layer in place and advances ``cache.length``.

    RoPE uses ``cache.length`` (the bucket slot), as the JAX decode_step does
    when called without positions (generate.py); for left-padded rows that
    differs from the prefill's count of valid tokens (a caveat of the
    reference, kept for token parity)."""
    x = embed_tokens(params, input_ids, policy.compute_dtype)
    B, S, _ = x.shape
    dev = x.device
    max_len = cache.max_len
    slot = cache.length
    positions = torch.full((B, S), slot, dtype=torch.int64, device=dev)
    cos, sin = cos_sin_for(cfg, positions, max_len)
    if kv_valid_mask is None:
        kv_valid_mask = torch.zeros((B, max_len), dtype=torch.int32, device=dev)
        kv_valid_mask[:, : slot + 1] = 1
    else:
        kv_valid_mask = kv_valid_mask.to(torch.int32).clone()
        kv_valid_mask[:, slot] = 1  # the freshly written position

    for i in range(cfg.num_hidden_layers):
        p = _layer(params, i)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps, policy)
        q, k, v = _qkv(p, h, cfg)
        q = apply_rope(q, cos, sin).contiguous()
        k = apply_rope(k, cos, sin)
        # in-place single-slot cache write
        cache.k[i, :, :, slot] = k[:, :, 0].to(cache.k.dtype)
        cache.v[i, :, :, slot] = v[:, :, 0].to(cache.v.dtype)
        ctx = flash_decode(q, cache.k, cache.v, i, kv_valid_mask)
        x = x + _proj(p, ctx.transpose(1, 2).reshape(B, S, -1), "wo")
        x = _mlp(p, x, cfg, policy)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps, policy)
    cache.length = slot + 1
    return _logits(params, x, policy, cfg)[:, 0], cache
