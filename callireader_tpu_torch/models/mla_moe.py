"""DeepSeek-V3-style decoder: multi-head latent attention (MLA) and sparse
experts (the LLM of Moonlight-16B-A3B; core/config.MLAMoEConfig). No JAX
counterpart: the JAX package has InternLM2 only.

A layer (H heads, latent width R = kv_lora_rank, Dn / Dr / Dv the no-RoPE,
RoPE and value widths of a head, Dqk = Dn + Dr):

    h = RMSNorm(x)
    q = h W_q                          (H, Dqk) a token: [q_nope | q_pe]
    [c_kv | k_pe] = h W_kv_a           R + Dr, one RoPE key for all heads
    c_kv = RMSNorm(c_kv)               (its own eps, ``kv_norm_eps``)
    [k_nope | v] = c_kv W_kv_b         (H, Dn + Dv)
    softmax((q_nope k_nope + rope(q_pe) rope(k_pe)) / sqrt(Dqk)) v, then W_o
    x += attention; h = RMSNorm(x)
    x += SwiGLU(h)                                  (the first layers: dense)
    x += sum_i w_i SwiGLU_i(h) + SwiGLU_shared(h)  (the rest: experts)

RoPE is pairwise: it rotates (x[2i], x[2i + 1]) by position x theta^(-2i/Dr)
(the published code de-interleaves the pairs first and rotates halves; both
give the same dot products, and the port keeps the pairs in place).

Routing (``noaux_tc``, sigmoid scores): s = sigmoid(h W_g) in fp32; the
experts are the top k of s + b, b a bias that moves the selection only; the
weights are s at the chosen experts over their sum (plus 1e-20), times
``routed_scaling_factor``; with ``n_group`` = ``topk_group`` = 1 the group
step selects every expert and is left out. Each expert's output is rounded
to the activations' dtype, weighted and summed in fp32 (the published
``moe_infer``), then the shared experts' output is added.

The cache holds one latent row a token and layer, [RMSNorm(c_kv) | rope(k_pe)]
(R + Dr = 576 at Moonlight): ``LatentCache.kv`` (L, B, max_len, R + Dr).
``prefill`` runs the non-absorbed form: k_nope and v expanded from the
latents for the prompt (kernels/mla_prefill.py: Dqk 192, Dv 128, one query
head a key head). ``decode_step_at`` runs the absorbed form over the cache:
q_lat,h = q_nope,h W_kb,h^T (R wide) joined to rope(q_pe,h), one pass over
each row's latent rows for all heads (kernels/mla_decode.py), and
o_h = (sum_j p_j c_kv,j) W_vb,h. The routed experts of both run in the
grouped expert kernel (kernels/moe_experts.py); the rest are bf16 products.

Parameters (kernels (in, out), vocab tables (V, E)), as drawn
(``init_params``, the published block's layout)::

    tok_embeddings (V, E), norm (E,), output (V, E)
    layers: attn_norm (L, E), wq (L, E, H Dqk), wkv_a (L, E, R + Dr),
            kv_norm (L, R), wkv_b (L, R, H (Dn + Dv)), wo (L, H Dv, E),
            ffn_norm (L, E)
    dense:  w1, w3 (Ld, E, M), w2 (Ld, M, E)
    moe:    gate (Lm, E, n), gate_bias (Lm, n) fp32, w1, w3 (Lm, n, E, Me),
            w2 (Lm, n, Me, E), shared_w1, shared_w3 (Lm, E, Ms), shared_w2 (Lm, Ms, E)

and as served (``prepare``, in place of a tree as drawn): the router in
fp32, the experts' gate and up fused into ``moe.w13`` (Lm, n, E, 2 Me), eight gate columns
then the eight up columns of the same outputs (the layout whose SwiGLU the
grouped kernel finishes in registers), and W_kv_b's halves per head for the
absorbed decode, ``layers.wkb_t`` (L, H, Dn, R) and ``layers.wvb``
(L, H, R, Dv).

Nothing on the decode step copies host data to the card or reads the card
from the host: the routing's top-k, the experts' grouping (a stable sort and
a prefix sum on the device) and the kernels' grids (sized on the host from
the token count alone) let a CUDA graph capture the step. The counters of
the expert layer are ``MOE_ROWS`` (the routed (token, expert) rows, a launch
count that graph replays keep true) and ``EXPERTS_TOUCHED`` (the (decode
step, layer, expert) triples with a row, a device tally read back with the
tokens); each prefill layer's routed block is the device span
``prefill_experts``.

No mesh: the tensor-parallel and paged serving routes are InternLM2's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from callireader_tpu_torch.core.config import MLAMoEConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.kernels._build import LaunchCount
from callireader_tpu_torch.kernels.mla_decode import latent_decode
from callireader_tpu_torch.kernels.mla_prefill import mla_prefill_attention
from callireader_tpu_torch.kernels.moe_experts import moe_experts
from callireader_tpu_torch.models.internlm2 import DECODE_STEPS, _fixed_inv_freq, _logits, embed_tokens, rms_norm
from callireader_tpu_torch.utils.profiling import SPANS, DeviceTally

Params = Dict[str, Any]
MOE_ROWS = LaunchCount("moe.rows")
EXPERTS_TOUCHED = DeviceTally("moe.experts_touched")
PREFILL_CHUNK = 8192  # tokens a routed block of the prefill takes at once (bounds its temporaries)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("the MLA-MoE LLM runs on one device: no tensor-parallel mesh")


# ---------------------------------------------------------------- params


def init_params(r, cfg: MLAMoEConfig) -> Params:
    """The drawn tree (the published layout): N(0, 0.02) matrices, unit
    norms, a small nonzero correction bias N(0, 1e-2) in fp32. ``r`` is a
    runtime/weights._Init (normal, ones, zeros)."""
    L, E, V, H = cfg.num_hidden_layers, cfg.hidden_size, cfg.vocab_size, cfg.num_attention_heads
    R, Dr, Dn, Dv = cfg.kv_lora_rank, cfg.qk_rope_head_dim, cfg.qk_nope_head_dim, cfg.v_head_dim
    Ld, Lm, n = cfg.first_k_dense_replace, cfg.moe_layers, cfg.n_routed_experts
    M, Me = cfg.intermediate_size, cfg.moe_intermediate_size
    Ms = cfg.n_shared_experts * Me
    s = 0.02
    return {
        "tok_embeddings": r.normal((V, E), s),
        "layers": {
            "attn_norm": r.ones((L, E)), "wq": r.normal((L, E, H * (Dn + Dr)), s),
            "wkv_a": r.normal((L, E, R + Dr), s), "kv_norm": r.ones((L, R)),
            "wkv_b": r.normal((L, R, H * (Dn + Dv)), s), "wo": r.normal((L, H * Dv, E), s),
            "ffn_norm": r.ones((L, E)),
        },
        "dense": {"w1": r.normal((Ld, E, M), s), "w3": r.normal((Ld, E, M), s),
                  "w2": r.normal((Ld, M, E), s)},
        "moe": {
            "gate": r.normal((Lm, E, n), s), "gate_bias": r.normal((Lm, n), 1e-2, torch.float32),
            "w1": r.normal((Lm, n, E, Me), s), "w3": r.normal((Lm, n, E, Me), s),
            "w2": r.normal((Lm, n, Me, E), s),
            "shared_w1": r.normal((Lm, E, Ms), s), "shared_w3": r.normal((Lm, E, Ms), s),
            "shared_w2": r.normal((Lm, Ms, E), s),
        },
        "norm": r.ones((E,)),
        "output": r.normal((V, E), s),
    }


def fuse_w13(w1: torch.Tensor, w3: torch.Tensor) -> torch.Tensor:
    """(..., E, Me) gate and up -> (..., E, 2 Me): eight gate columns, then
    the eight up columns of the same outputs, in turn."""
    *lead, E, Me = w1.shape
    if Me % 8:
        raise ValueError(f"expert width {Me} is not a multiple of 8")
    g = w1.reshape(*lead, E, Me // 8, 1, 8)
    u = w3.reshape(*lead, E, Me // 8, 1, 8)
    return torch.cat([g, u], dim=-2).reshape(*lead, E, 2 * Me)


def prepare(params: Params, cfg: MLAMoEConfig) -> Params:
    """The served tree from a drawn one, in place: the fused copy of the
    experts' w1 / w3 is made a layer at a time, then the drawn pair is
    dropped (the peak holds the experts' gate and up twice)."""
    moe, layers = params["moe"], params["layers"]
    if "w13" not in moe:
        w1, w3 = moe.pop("w1"), moe.pop("w3")
        Lm = w1.shape[0]
        w13 = torch.empty((Lm, *w1.shape[1:-1], 2 * w1.shape[-1]), dtype=w1.dtype, device=w1.device)
        for i in range(Lm):
            w13[i] = fuse_w13(w1[i], w3[i])
        del w1, w3
        moe["w13"] = w13
    moe["gate"] = moe["gate"].float()  # the router runs in fp32: cast once, not a step
    if "wkb_t" not in layers:
        L, H, R = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.kv_lora_rank
        Dn, Dv = cfg.qk_nope_head_dim, cfg.v_head_dim
        b = layers["wkv_b"].reshape(L, R, H, Dn + Dv)
        layers["wkb_t"] = b[..., :Dn].permute(0, 2, 3, 1).contiguous()  # (L, H, Dn, R)
        layers["wvb"] = b[..., Dn:].permute(0, 2, 1, 3).contiguous()  # (L, H, R, Dv)
    return params


def _served(params: Params) -> None:
    if "w13" not in params["moe"] or "wkb_t" not in params["layers"]:
        raise ValueError("the MLA-MoE tree is not prepared: models/mla_moe.prepare(params, cfg)")


# ----------------------------------------------------------------- pieces


def rope_tables(cfg: MLAMoEConfig, positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) (..., Dr / 2) fp32 at integer ``positions`` (...)."""
    ang = positions.float()[..., None] * _fixed_inv_freq(cfg.qk_rope_head_dim, float(cfg.rope_theta),
                                                         positions.device)
    return torch.cos(ang), torch.sin(ang)


def rope_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Pairwise RoPE of x (..., Dr), cos / sin broadcast to (..., Dr / 2):
    (x0, x1) -> (x0 c - x1 s, x1 c + x0 s), in fp32, rounded once."""
    xf = x.float().unflatten(-1, (-1, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x1 * cos + x0 * sin], dim=-1)
    return out.flatten(-2).to(x.dtype)


def _layer(params: Params, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i] for k, v in params["layers"].items()}


def _mm(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h @ w in h's dtype (a no-op cast for the bf16 tree of a bf16 run)."""
    return h @ w.to(h.dtype)


def _swiglu(h, w1, w3, w2):
    return _mm(F.silu(_mm(h, w1)) * _mm(h, w3), w2)


def ffn(params: Params, cfg: MLAMoEConfig, i: int, x: torch.Tensor, policy: DTypePolicy,
        decode: bool) -> torch.Tensor:
    """x + layer i's SwiGLU (dense) or its experts, x (T, E): the block
    ``prefill`` (``decode`` False) and the decode step (True) run, which the
    benchmark's expert probe also calls on a served tree."""
    h = rms_norm(x, params["layers"]["ffn_norm"][i], cfg.rms_norm_eps, policy)
    if i < cfg.first_k_dense_replace:
        p = {k: v[i] for k, v in params["dense"].items()}
        return x + _swiglu(h, p["w1"], p["w3"], p["w2"])
    p = {k: v[i - cfg.first_k_dense_replace] for k, v in params["moe"].items()}
    if decode:
        y = _experts(p, cfg, h, decode=True)
    else:
        with SPANS.device("prefill_experts"):
            y = torch.cat([_experts(p, cfg, h[j:j + PREFILL_CHUNK], decode=False)
                           for j in range(0, h.shape[0], PREFILL_CHUNK)])
    shared = _swiglu(h, p["shared_w1"], p["shared_w3"], p["shared_w2"])
    return x + (y + shared)


def route(p: Dict[str, torch.Tensor], cfg: MLAMoEConfig, h: torch.Tensor):
    """h (T, E) -> (experts (T, k) int64, weights (T, k) fp32)."""
    s = torch.sigmoid(h.float() @ p["gate"].float())  # a no-op cast on a prepared tree
    sel = torch.topk(s + p["gate_bias"].float(), cfg.num_experts_per_tok, dim=-1).indices
    w = s.gather(1, sel)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return sel, w * cfg.routed_scaling_factor


def _experts(p, cfg: MLAMoEConfig, h: torch.Tensor, decode: bool) -> torch.Tensor:
    sel, w = route(p, cfg, h)
    MOE_ROWS.launches += sel.numel()
    return moe_experts(h, sel, w, p["w13"], p["w2"],
                       tally=EXPERTS_TOUCHED.acc(h.device) if decode else None)


# ------------------------------------------------------------------ cache


@dataclasses.dataclass
class LatentCache:
    kv: torch.Tensor  # (L, B, max_len, R + Dr)
    length: int  # valid positions (the next write slot)

    @classmethod
    def create(cls, cfg: MLAMoEConfig, batch: int, max_len: int, dtype, device,
               mesh=None) -> "LatentCache":
        _no_mesh(mesh)
        return cls(torch.zeros((cfg.num_hidden_layers, batch, max_len, cfg.latent_dim),
                               dtype=dtype, device=device), 0)

    @property
    def max_len(self) -> int:
        return self.kv.shape[2]


KVCache = LatentCache  # the name runtime/generate.py's families share


# ---------------------------------------------------------------- forward


def _attend_full(p, cfg: MLAMoEConfig, h: torch.Tensor, cos, sin, segment_ids, policy: DTypePolicy):
    """The non-absorbed attention over a whole sequence: h (B, S, E) ->
    (context (B, S, H Dv), latent rows (B, S, R + Dr))."""
    B, S, _ = h.shape
    H, R, Dn, Dv = cfg.num_attention_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.v_head_dim
    q = _mm(h, p["wq"]).view(B, S, H, -1)
    kva = _mm(h, p["wkv_a"])
    c = rms_norm(kva[..., :R].contiguous(), p["kv_norm"], cfg.kv_norm_eps, policy)
    k_pe = rope_pairs(kva[..., R:], cos, sin)
    q = torch.cat([q[..., :Dn], rope_pairs(q[..., Dn:], cos[:, :, None], sin[:, :, None])], dim=-1)
    kv = _mm(c, p["wkv_b"]).view(B, S, H, Dn + Dv)
    k = torch.cat([kv[..., :Dn], k_pe[:, :, None].expand(B, S, H, k_pe.shape[-1])], dim=-1)
    ctx = mla_prefill_attention(q, k.contiguous(), kv[..., Dn:], segment_ids,
                                scale=cfg.qk_head_dim ** -0.5)
    return ctx.reshape(B, S, H * Dv), torch.cat([c, k_pe], dim=-1)


def _stack(params: Params, cfg: MLAMoEConfig, x: torch.Tensor, positions: torch.Tensor,
           segment_ids: torch.Tensor, policy: DTypePolicy, cache: Optional[LatentCache]) -> torch.Tensor:
    """Every layer over x (B, S, E) -> the final normed hidden (B, S, E);
    writes the latent rows into ``cache`` [0, S) when given."""
    B, S, E = x.shape
    cos, sin = rope_tables(cfg, positions)
    for i in range(cfg.num_hidden_layers):
        p = _layer(params, i)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps, policy)
        ctx, rows = _attend_full(p, cfg, h, cos, sin, segment_ids, policy)
        if cache is not None:
            cache.kv[i, :, :S] = rows.to(cache.kv.dtype)
        x = x + _mm(ctx, p["wo"])
        x = ffn(params, cfg, i, x.reshape(B * S, E), policy, decode=False).view(B, S, E)
    return rms_norm(x, params["norm"], cfg.rms_norm_eps, policy)


def forward(params: Params, cfg: MLAMoEConfig, *, input_ids: Optional[torch.Tensor] = None,
            inputs_embeds: Optional[torch.Tensor] = None, positions: Optional[torch.Tensor] = None,
            segment_ids: Optional[torch.Tensor] = None,
            policy: DTypePolicy = DEFAULT_POLICY) -> torch.Tensor:
    """The full-sequence forward (no cache, causal within equal segment ids)
    -> logits (B, S, V). Inference only."""
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids, policy.compute_dtype)
    x = inputs_embeds.to(policy.compute_dtype)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if segment_ids is None:
        segment_ids = torch.zeros((B, S), dtype=torch.int32, device=x.device)
    return _logits(params, _stack(params, cfg, x, positions, segment_ids, policy, None), policy, cfg)


def prefill(params: Params, cfg: MLAMoEConfig, *, inputs_embeds: torch.Tensor,
            attention_mask: torch.Tensor, max_len: int, cache_dtype=torch.bfloat16,
            policy: DTypePolicy = DEFAULT_POLICY, cache: Optional[LatentCache] = None,
            mesh=None) -> Tuple[torch.Tensor, LatentCache]:
    """Prompt (left-padded) -> (last logits (B, V), the latent cache of
    capacity ``max_len`` with length S), as models/internlm2.prefill: pads
    take position 0 and segment id -1."""
    _no_mesh(mesh)
    _served(params)
    x = inputs_embeds.to(policy.compute_dtype)
    B, S, _ = x.shape
    attention_mask = attention_mask.to(torch.int32)
    positions = torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
    segment_ids = torch.where(attention_mask > 0, 0, -1).to(torch.int32)
    if cache is None:
        cache = LatentCache.create(cfg, B, max_len, cache_dtype, x.device)
    elif cache.kv.shape[1] != B or cache.max_len != max_len or cache.kv.dtype != cache_dtype:
        raise ValueError(f"the cache holds {cache.kv.shape[1]} rows x {cache.max_len} slots of "
                         f"{cache.kv.dtype}, the prefill {B} x {max_len} of {cache_dtype}")
    EXPERTS_TOUCHED.acc(x.device)  # made before any decode graph captures an add into it
    h = _stack(params, cfg, x, positions, segment_ids, policy, cache)
    cache.length = S
    return _logits(params, h[:, -1], policy, cfg), cache


def decode_step_at(params: Params, cfg: MLAMoEConfig, *, input_ids: torch.Tensor,
                   cache: LatentCache, kv_valid: torch.Tensor, slot: torch.Tensor,
                   policy: DTypePolicy = DEFAULT_POLICY, mesh=None) -> torch.Tensor:
    """One token a row at cache slot ``slot`` ((1,) int64 on the device:
    the write slot and the RoPE position, as InternLM2's decode_step_at) ->
    logits (B, V). Marks ``kv_valid[:, slot]``, writes each layer's latent
    row and attends the marked slots, all in place."""
    _no_mesh(mesh)
    DECODE_STEPS.launches += 1
    B = input_ids.shape[0]
    H, R, Dn = cfg.num_attention_heads, cfg.kv_lora_rank, cfg.qk_nope_head_dim
    kv_valid.index_fill_(1, slot, 1)
    x = embed_tokens(params, input_ids[:, 0], policy.compute_dtype)  # (B, E)
    cos, sin = rope_tables(cfg, slot)  # (1, Dr / 2)
    rows = torch.arange(B, device=x.device)
    for i in range(cfg.num_hidden_layers):
        p = _layer(params, i)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps, policy)
        q = _mm(h, p["wq"]).view(B, H, -1)
        kva = _mm(h, p["wkv_a"])
        c = rms_norm(kva[:, :R].contiguous(), p["kv_norm"], cfg.kv_norm_eps, policy)
        cache.kv[i, rows, slot.expand(B)] = torch.cat([c, rope_pairs(kva[:, R:], cos, sin)], -1).to(
            cache.kv.dtype)
        q_lat = torch.bmm(q[..., :Dn].transpose(0, 1), p["wkb_t"].to(h.dtype)).transpose(0, 1)  # (B, H, R)
        q_full = torch.cat([q_lat, rope_pairs(q[..., Dn:], cos[:, None], sin[:, None])], dim=-1)
        o_lat = latent_decode(q_full.to(cache.kv.dtype), cache.kv[i], kv_valid, slot, R,
                              cfg.qk_head_dim ** -0.5)  # (B, H, R)
        o = torch.bmm(o_lat.transpose(0, 1).to(h.dtype), p["wvb"].to(h.dtype)).transpose(0, 1)  # (B, H, Dv)
        x = x + _mm(o.reshape(B, -1), p["wo"])
        x = ffn(params, cfg, i, x, policy, decode=True)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps, policy)
    return _logits(params, x, policy, cfg)
