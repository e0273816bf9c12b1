"""InternLM2-style decoder (PyTorch port of callireader_tpu/models/internlm2.py).

GQA attention, rotate-half RoPE with the dynamic-NTK rule, SwiGLU MLP, fp32
RMSNorm statistics (kernels/rmsnorm.py, forward and backward), untied LM head. Same parameter tree as the JAX package
(layers stacked on axis 0, kernels (in, out), vocab tables (V, E)), in bf16
or with int8 weight-only leaves (runtime/quantize.py): ``{name}_q`` +
``{name}_scale``, split (wq/wk/wv, w1/w3) or fused (wqkv, w13), int8 vocab
tables, optionally padded to a multiple of 128 (``pad_vocab``; logits of the
pad rows are set to the dtype's minimum).

int8 dispatch (the JAX rule, with no environment knob): a product of at most
32 rows with K and N multiples of 128 goes through the int8 kernels
(kernels/int8_matmul.py: the decode projections and the LM head); any other
(the prefill's layer projections, and any product whose activation autograd
tracks, since the kernels have no backward) takes the JAX package's XLA form,
``(h @ q.to(h.dtype)) * scale.to(h.dtype)``, which rounds the product before
the scale.

LoRA adapters (train/lora.py) are extra leaves ``{name}_lora_a`` (in, r),
``{name}_lora_b`` (r, out) and ``lora_scale`` in the layer stack; ``_proj``
adds ``((h @ a) @ b) * scale`` in ``h``'s dtype, as the JAX ``_proj`` does.

Entry points: ``forward`` (the full-sequence forward of training, no cache;
attention through kernels.attention_bwd.flash_attention_trainable, which
autograd differentiates; ``remat=True`` recomputes each layer in the
backward), ``prefill`` (prompt -> last logits + a fresh or caller-owned
cache; attention through kernels.attention.flash_attention) and
``decode_step`` (one token; kernels.decode_attention.flash_decode over the
stacked cache, the token's RoPE and cache write one kernels.rope_kv launch a
layer). The KV cache is one preallocated (L, B, Hkv, max_len, D)
buffer per K and V that both entry points write IN PLACE: prefill fills
[0, S), each decode step writes slot ``cache.length`` of every layer.
``decode_step_at`` is the same step with its slot in a device tensor, so a
CUDA graph of it (runtime/decode_graph.py) reads the slot anew at each
replay. For serving: ``prefill_with_prefix`` (suffix-only prefill over a
cached prefix KV) and ``decode_step_multislot`` (every slot of a
caller-owned cache advances one token at its own position).

Nothing on the decode step copies host data to the card, reads the card
from the host or allocates outside PyTorch's allocator, so the step can be
captured in a CUDA graph; ``DECODE_STEPS`` counts the decode steps run (a
``LaunchCount``, kept true under replays).

Under a mesh (``mesh=``, core/partition.Mesh) the inference entry points run
tensor parallel, with the collectives GSPMD inserts in the JAX package
written out (parallel/spmd.py): each rank holds its block of every leaf
(``spmd.shard_tree`` by ``spmd.llm_logical_axes``); wq / wk / wv and w1 / w3
are column-parallel (a rank's Hq/t and Hkv/t heads, its M/t of the mlp), wo
and w2 row-parallel, their partial sums added by an ``all_reduce`` over
"tensor"; the embedding and the LM head are vocab-parallel where "tensor"
divides the vocabulary (a rank looks up its rows and the ``all_reduce`` adds
them; the head's logits are gathered); a leaf sharded over "fsdp" is
gathered for its layer and dropped after it. The KV cache holds the rank's
KV heads (``KVCache.create(..., mesh=)``). The fused int8 layout does not
shard (runtime/quantize.unfuse_llm_int8). On the card the decode graphs
capture the NCCL collectives with the rest of the step.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from callireader_tpu_torch.core import partition
from callireader_tpu_torch.core.config import LLMConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.kernels import rmsnorm as k_rmsnorm
from callireader_tpu_torch.kernels._build import LaunchCount
from callireader_tpu_torch.kernels.attention import flash_attention
from callireader_tpu_torch.kernels.attention_bwd import flash_attention_trainable
from callireader_tpu_torch.kernels.decode_attention import flash_decode
from callireader_tpu_torch.kernels.int8_matmul import BLOCK, MAX_ROWS, int8_matmul, int8_matmul_nt
from callireader_tpu_torch.kernels.rope_kv import apply_rope, rope_kv
from callireader_tpu_torch.parallel import spmd

Params = Dict[str, Any]
DECODE_STEPS = LaunchCount("decode_step")


def logical_axes(cfg: LLMConfig) -> Params:
    """Logical sharding annotations, the tree of the dense params
    (core/partition.py)."""
    del cfg
    return {
        "tok_embeddings": ("vocab", "embed"),
        "layers": {
            "attn_norm": ("stack", "norm"),
            "ffn_norm": ("stack", "norm"),
            "wq": ("stack", "embed", "qkv"),
            "wk": ("stack", "embed", "qkv"),
            "wv": ("stack", "embed", "qkv"),
            "wo": ("stack", "qkv", "embed"),
            "w1": ("stack", "embed", "mlp"),
            "w3": ("stack", "embed", "mlp"),
            "w2": ("stack", "mlp", "embed"),
        },
        "norm": ("norm",),
        "output": ("vocab", "embed"),
    }


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, policy: DTypePolicy) -> torch.Tensor:
    """The JAX package's rms_norm, y = T(T(x * r) * T(w)) with fp32 statistics
    (T = x's dtype): the ``"model"`` mode of kernels.rmsnorm, a CUDA kernel
    on the card. Under autograd it is ``RMSNormFn``, whose backward is the
    kernel's too."""
    if policy.norm_dtype != torch.float32:
        raise ValueError(f"RMSNorm statistics are fp32, the policy asks {policy.norm_dtype}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        y = k_rmsnorm.rms_norm_trainable(x, weight, eps, "model")
    else:
        y = k_rmsnorm.rms_norm(x, weight, eps, "model")
    return y if y.dtype == policy.compute_dtype else y.to(policy.compute_dtype)


def _inv_freq(cfg: LLMConfig, base, device) -> torch.Tensor:
    exps = torch.arange(0, cfg.head_dim, 2, dtype=torch.float32, device=device) / cfg.head_dim
    return 1.0 / (base ** exps)


@functools.lru_cache(maxsize=None)
def _fixed_inv_freq(head_dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The RoPE frequencies at the configured base, made once per (width,
    base, device): a host scalar copied to the card on every step would be a
    copy that a CUDA graph capture refuses. A normal tensor (not an inference
    one), so that training may read it too."""
    with torch.inference_mode(False):
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
        return 1.0 / (torch.tensor(theta, dtype=torch.float32, device=device) ** exps)


def cos_sin_for(cfg: LLMConfig, positions: torch.Tensor, kv_seq_len: int):
    """RoPE tables (B, S, D) for integer positions (B, S). "linear" divides
    the positions by the factor (the long-context training recipe,
    ``prepare_long_context``); "dynamic" NTK rescales the base once the
    run's sequence (max position + 1) exceeds max_position_embeddings, which
    can only happen when the cache capacity ``kv_seq_len`` does."""
    pos = positions.float()
    dev = positions.device
    if cfg.rope_scaling_type == "linear":
        pos = pos / cfg.rope_scaling_factor
    if cfg.rope_scaling_type == "dynamic" and kv_seq_len > cfg.max_position_embeddings:
        f = cfg.rope_scaling_factor
        mpe = float(cfg.max_position_embeddings)
        seq = positions.max().float() + 1.0
        scaled = cfg.rope_theta * ((f * seq / mpe) - (f - 1)) ** (cfg.head_dim / (cfg.head_dim - 2))
        base = torch.where(seq > mpe, scaled, torch.full_like(scaled, cfg.rope_theta))
        inv = _inv_freq(cfg, base, dev)
    else:
        inv = _fixed_inv_freq(cfg.head_dim, float(cfg.rope_theta), dev)
    freqs = pos[..., None] * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def prepare_long_context(cfg: LLMConfig, max_length: int) -> LLMConfig:
    """Enlarge the usable context with linear RoPE scaling, the
    `_prepare_for_long_context_training` recipe (train/xtuner/model/sft.py:
    161-184, reward.py:186): factor = ceil(max_length / max_position_embeddings),
    applied only when the target exceeds the native window."""
    if max_length <= cfg.max_position_embeddings:
        return cfg
    factor = float(math.ceil(max_length / cfg.max_position_embeddings))
    return dataclasses.replace(cfg, rope_scaling_type="linear", rope_scaling_factor=factor,
                               max_position_embeddings=max_length)


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # (L, B, Hkv, max_len, D)
    v: torch.Tensor
    length: int  # valid positions (the next write slot)

    @classmethod
    def create(cls, cfg: LLMConfig, batch: int, max_len: int, dtype, device,
               mesh=None) -> "KVCache":
        shape = (cfg.num_hidden_layers, batch, kv_heads(cfg, mesh), max_len, cfg.head_dim)
        return cls(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def kv_heads(cfg: LLMConfig, mesh=None) -> int:
    """The KV heads a rank holds: all of them, or Hkv / tensor."""
    return cfg.num_key_value_heads // (1 if mesh is None else mesh.axis_size("tensor"))


_COLUMN = ("wq", "wk", "wv", "w1", "w3")
_ROW = ("wo", "w2")


def _io_dims(cfg: LLMConfig) -> Dict[str, Tuple[int, int]]:
    E, M = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    return {"wq": (E, q), "wk": (E, kv), "wv": (E, kv), "wo": (q, E),
            "w1": (E, M), "w3": (E, M), "w2": (M, E)}


def _layer_leaf(name: str, local: Tuple[int, ...], cfg: LLMConfig, T) -> Tuple[tuple, tuple]:
    """(the whole stacked leaf's shape, the spec a rank's layer product
    wants: column-parallel out dims and row-parallel in dims over "tensor"),
    from the shape ``local`` a rank holds."""
    io, L = _io_dims(cfg), cfg.num_hidden_layers
    base, _, kind = name.partition("_")
    if base in ("wqkv", "w13"):
        raise ValueError("the fused int8 layout does not shard over a mesh: "
                         "runtime/quantize.unfuse_llm_int8 first")
    if base not in io:  # the norms, lora_scale: whole on every rank
        return local, (None,) * (len(local) - 1)
    K, N = io[base]
    col = base in _COLUMN
    if kind in ("", "q"):
        return (L, K, N), ((None, T) if col else (T, None))
    if kind == "scale":
        return (L, 1, N), ((None, T) if col else (None, None))
    if kind == "lora_a":
        return (L, K, local[-1]), ((None, None) if col else (T, None))
    if kind == "lora_b":
        return (L, local[-2], N), ((None, T) if col else (None, None))
    raise KeyError(name)


class _TP:
    """The tensor-parallel layout of a tree: per leaf, the spec it is
    stored in (``spmd.llm_logical_axes`` on the whole shapes, which the
    config gives) and the spec its product wants. Built from the leaves'
    names and the shapes a rank holds (``_tp``)."""

    def __init__(self, layers: Tuple[Tuple[str, tuple], ...], top: Tuple[Tuple[str, tuple], ...],
                 cfg: LLMConfig, mesh):
        t = mesh.axis_size("tensor")
        if cfg.num_attention_heads % t or cfg.num_key_value_heads % t or cfg.intermediate_size % t:
            raise ValueError(f"tensor={t} does not divide {cfg.num_attention_heads}:"
                             f"{cfg.num_key_value_heads} heads and mlp {cfg.intermediate_size}")
        self.mesh, T = mesh, ("tensor" if t > 1 else None)
        axes = spmd.llm_logical_axes(cfg, {"layers": dict(layers), **dict(top)})
        self.layers = {}
        for name, shape in layers:
            full, want = _layer_leaf(name, shape, cfg, T)
            have = self._stored(full, axes["layers"][name], shape, name)
            self.layers[name] = (have[1:], want)
        # vocab-parallel where "tensor" divides the vocabulary
        self.vocab_axis = T if cfg.vocab_size % t == 0 else None
        self.top = {}
        for name, shape in top:
            if name == "norm":
                continue
            full = (cfg.vocab_size, shape[1] if name.endswith("_scale") else cfg.hidden_size)
            self.top[name] = (self._stored(full, axes[name], shape, name), (self.vocab_axis, None))

    def _stored(self, full, axes, shape, name):
        spec = partition.spec_for_shape(full, axes, mesh=self.mesh)
        want = tuple(n // (self.mesh.axis_size(a) if a else 1) for n, a in
                     zip(full, spec + (None,) * (len(full) - len(spec))))
        if shape != want:
            raise ValueError(f"{name}: a rank holds {shape}, its block of {full} "
                             f"under {spec} is {want} (spmd.shard_tree shards a whole tree)")
        return spec

    def layer(self, params: Params, i: int) -> Dict[str, torch.Tensor]:
        return {k: spmd.relayout(v[i], *self.layers[k], self.mesh)
                for k, v in params["layers"].items()}

    def leaf(self, params: Params, name: str) -> torch.Tensor:
        return spmd.relayout(params[name], *self.top[name], self.mesh)


@functools.lru_cache(maxsize=16)
def _layout(layers, top, cfg: LLMConfig, mesh) -> _TP:
    return _TP(layers, top, cfg, mesh)


def _tp(params: Params, cfg: LLMConfig, mesh) -> Optional[_TP]:
    """The layout of ``params`` under ``mesh``, built once for each config,
    mesh and set of leaf names and shapes: a decode step only reads its
    leaves' shapes."""
    if mesh is None:
        return None
    layers = tuple((k, tuple(v.shape)) for k, v in params["layers"].items())
    top = tuple((k, tuple(v.shape)) for k, v in params.items() if k != "layers")
    return _layout(layers, top, cfg, mesh)


def _layer(params: Params, i: int, tp: Optional[_TP] = None) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s leaves: views into the stacks, no copy (an int8 weight
    q[i] is the layer's (K, N) block in place, which the TPU needed a
    scalar-prefetch kernel for); under a mesh, the rank's blocks its
    products want (fsdp-sharded leaves gathered for this layer)."""
    if tp is not None:
        return tp.layer(params, i)
    return {k: v[i] for k, v in params["layers"].items()}


def _rows(h: torch.Tensor) -> int:
    return h.numel() // h.shape[-1]


def _int8_kernel_route(h: torch.Tensor, K: int, N: int) -> bool:
    """The int8 kernels take few rows with K, N multiples of 128. An ``h``
    that autograd tracks (training over an int8 base) takes the XLA form:
    the kernels have no backward."""
    if h.requires_grad and torch.is_grad_enabled():
        return False
    return _rows(h) <= MAX_ROWS and K % BLOCK == 0 and N % BLOCK == 0


def _int8_mm(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """h @ dequant(q (K, N), scale (N,) or (1, N)): the int8 kernel for few
    rows, else the XLA form."""
    K, N = q.shape
    rows = _rows(h)
    if _int8_kernel_route(h, K, N):
        y = int8_matmul(h.reshape(rows, K).contiguous(), q, scale.reshape(N))
        return y.reshape(*h.shape[:-1], N)
    return (h @ q.to(h.dtype)) * scale.reshape(N).to(h.dtype)


def _proj(p: Dict[str, torch.Tensor], h: torch.Tensor, name: str,
          tp: Optional[_TP] = None) -> torch.Tensor:
    """Linear ``name``: bf16 ``p[name]``, or int8 ``{name}_q`` + ``{name}_scale``;
    plus the LoRA adapter ``{name}_lora_a/b`` where the layer has one. Under
    a mesh a row-parallel product's partial sums are added over "tensor"."""
    q = p.get(f"{name}_q")
    y = h @ p[name].to(h.dtype) if q is None else _int8_mm(h, q, p[f"{name}_scale"])
    a = p.get(f"{name}_lora_a")
    if a is not None:
        y = y + ((h @ a.to(h.dtype)) @ p[f"{name}_lora_b"].to(h.dtype)) * p["lora_scale"].to(h.dtype)
    if tp is not None and name in _ROW:
        y = spmd.all_reduce(y, tp.mesh, "tensor")
    return y


def _qkv(p, h, cfg: LLMConfig):
    """-> q (B, Hq, S, D), k and v (B, Hkv, S, D): the heads the layer's
    leaves hold (a rank's Hq/t and Hkv/t under a mesh)."""
    B, S, _ = h.shape
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    if "wqkv_q" in p:
        q, k, v = torch.split(_proj(p, h, "wqkv"), [Hq * D, Hkv * D, Hkv * D], dim=-1)
    else:
        q, k, v = _proj(p, h, "wq"), _proj(p, h, "wk"), _proj(p, h, "wv")
    q = q.reshape(B, S, -1, D).transpose(1, 2)
    k = k.reshape(B, S, -1, D).transpose(1, 2)
    v = v.reshape(B, S, -1, D).transpose(1, 2)
    return q, k, v


def _mlp(p, x, cfg: LLMConfig, policy: DTypePolicy, tp: Optional[_TP] = None):
    h = rms_norm(x, p["ffn_norm"], cfg.rms_norm_eps, policy)
    if "w13_q" in p:
        g, up = _proj(p, h, "w13").chunk(2, dim=-1)
    else:
        g, up = _proj(p, h, "w1"), _proj(p, h, "w3")
    return x + _proj(p, F.silu(g) * up, "w2", tp)


def embed_tokens(params: Params, input_ids: torch.Tensor, dtype=torch.bfloat16,
                 mesh=None, cfg: Optional[LLMConfig] = None) -> torch.Tensor:
    """Token embedding lookup; int8 rows are dequantized after the gather.
    Under a mesh (``cfg`` given too) a vocab-parallel table: each rank
    looks up the ids in its rows, zeros elsewhere, and the ranks' rows are
    added over "tensor"."""
    ids = input_ids.long()
    q = "tok_embeddings_q" in params
    name = "tok_embeddings_q" if q else "tok_embeddings"
    if mesh is None:
        table = params[name]
    else:
        tp = _tp(params, cfg, mesh)
        table = tp.leaf(params, name)
        if tp.vocab_axis is not None:
            n = table.shape[0]
            local = ids - mesh.rank("tensor") * n
            inside = (local >= 0) & (local < n)
            local = local.clamp(0, n - 1)
            e = table[local].to(dtype)
            if q:
                e = e * tp.leaf(params, "tok_embeddings_scale")[local].to(dtype)
            return spmd.all_reduce(e * inside[..., None].to(dtype), mesh, "tensor")
        if q:
            return table[ids].to(dtype) * tp.leaf(params, "tok_embeddings_scale")[ids].to(dtype)
        return table[ids].to(dtype)
    if q:
        return table[ids].to(dtype) * params["tok_embeddings_scale"][ids].to(dtype)
    return table[ids].to(dtype)


def _logits(params: Params, x: torch.Tensor, policy: DTypePolicy, cfg: LLMConfig,
            tp: Optional[_TP] = None) -> torch.Tensor:
    """The LM head -> (..., V) logits; vocab-parallel under a mesh (each
    rank's V/t columns, gathered over "tensor")."""
    leaf = (lambda n: params[n]) if tp is None else (lambda n: tp.leaf(params, n))
    if "output_q" in params:
        q, scale = leaf("output_q"), leaf("output_scale")  # (V, E), (V, 1)
        N, K = q.shape
        rows = _rows(x)
        if _int8_kernel_route(x, K, N):
            y = int8_matmul_nt(x.reshape(rows, K).contiguous(), q, scale.reshape(N))
            y = y.reshape(*x.shape[:-1], N).to(policy.logits_dtype)
        else:
            y = ((x @ q.T.to(x.dtype)) * scale[:, 0].to(x.dtype)).to(policy.logits_dtype)
    else:
        y = (x @ leaf("output").to(x.dtype).T).to(policy.logits_dtype)
    if tp is not None and tp.vocab_axis is not None:
        y = spmd.all_gather(y, tp.mesh, "tensor", -1)
    if cfg.real_vocab_size is not None and cfg.real_vocab_size < y.shape[-1]:
        # padded vocab rows (pad_vocab) never win argmax; out of place, so
        # that autograd can differentiate through the logits
        pad = torch.arange(y.shape[-1], device=y.device) >= cfg.real_vocab_size
        y = y.masked_fill(pad, torch.finfo(y.dtype).min)
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


def _train_layer(p, x, cos, sin, segment_ids, cfg: LLMConfig, policy: DTypePolicy,
                 attn_override=None):
    """One decoder layer of the full-sequence forward (no cache)."""
    B, S, _ = x.shape
    h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps, policy)
    q, k, v = _qkv(p, h, cfg)
    q = apply_rope(q, cos, sin).contiguous()
    k = apply_rope(k, cos, sin).contiguous()
    if attn_override is not None:
        ctx = attn_override(q, k, v.contiguous())
    else:
        ctx = flash_attention_trainable(q, k, v.contiguous(), segment_ids, segment_ids, True, None)
    x = x + _proj(p, ctx.transpose(1, 2).reshape(B, S, -1), "wo")
    return _mlp(p, x, cfg, policy)


def forward(
    params: Params,
    cfg: LLMConfig,
    *,
    input_ids: Optional[torch.Tensor] = None,  # (B, S)
    inputs_embeds: Optional[torch.Tensor] = None,  # (B, S, E)
    positions: Optional[torch.Tensor] = None,  # (B, S), default 0..S-1
    segment_ids: Optional[torch.Tensor] = None,  # (B, S), pad -1
    policy: DTypePolicy = DEFAULT_POLICY,
    remat: bool = False,
    return_hidden: bool = False,
    attn_override: Optional[Callable] = None,
    rope_len: Optional[int] = None,
) -> torch.Tensor:
    """Full-sequence forward (training / eval) -> logits (B, S, V) in the
    policy's logits dtype, or the final hidden states if ``return_hidden``.
    Causal attention within equal segment ids. ``remat=True`` checkpoints
    each layer (its activations are recomputed in the backward), as
    ``jax.checkpoint`` does the JAX scan body. ``attn_override(q, k, v) ->
    ctx`` replaces the attention (Ulysses sequence parallelism, where ``x``
    is a rank's part of the sequence and ``rope_len`` the whole length the
    dynamic-NTK rule reads)."""
    if inputs_embeds is None:
        inputs_embeds = embed_tokens(params, input_ids, policy.compute_dtype)
    x = inputs_embeds.to(policy.compute_dtype)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
    cos, sin = cos_sin_for(cfg, positions, rope_len or S)
    # one unbind per stacked leaf: its backward stacks the 32 layers' grads
    # once, where indexing layer by layer would add a full-size zero tensor
    # per layer
    names = list(params["layers"])
    per_layer = zip(*(params["layers"][n].unbind(0) for n in names))
    for leaves in per_layer:
        p = dict(zip(names, leaves))
        if remat:
            x = checkpoint(_train_layer, p, x, cos, sin, segment_ids, cfg, policy, attn_override,
                           use_reentrant=False)
        else:
            x = _train_layer(p, x, cos, sin, segment_ids, cfg, policy, attn_override)
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps, policy)
    if return_hidden:
        return x
    return _logits(params, x, policy, cfg)


def prefill(
    params: Params,
    cfg: LLMConfig,
    *,
    inputs_embeds: torch.Tensor,  # (B, S, E)
    attention_mask: torch.Tensor,  # (B, S) 1 = valid, left-padded
    max_len: int,
    cache_dtype=torch.bfloat16,
    policy: DTypePolicy = DEFAULT_POLICY,
    cache: Optional[KVCache] = None,
    mesh=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Prompt -> (last logits (B, V), cache of capacity ``max_len`` with
    length S). Padded positions get segment id -1 and position 0. ``cache``:
    a caller-owned cache of that capacity (and ``cache_dtype``) to fill in
    place instead of a fresh one; its slots from S on keep what they held.
    ``mesh``: tensor parallel (the module docstring), the cache the rank's
    KV heads."""
    tp = _tp(params, cfg, mesh)
    x = inputs_embeds.to(policy.compute_dtype)
    B, S, _ = x.shape
    dev = x.device
    attention_mask = attention_mask.to(torch.int32)
    positions = torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
    segment_ids = torch.where(attention_mask > 0, 0, -1).to(torch.int32)
    cos, sin = cos_sin_for(cfg, positions, max(S, 1))
    if cache is None:
        cache = KVCache.create(cfg, B, max_len, cache_dtype, dev, mesh)
    elif cache.k.shape[1] != B or cache.max_len != max_len or cache.k.dtype != cache_dtype:
        raise ValueError(f"the cache holds {cache.k.shape[1]} rows x {cache.max_len} slots of "
                         f"{cache.k.dtype}, the prefill {B} x {max_len} of {cache_dtype}")

    for i in range(cfg.num_hidden_layers):
        p = _layer(params, i, tp)
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
        x = x + _proj(p, ctx.transpose(1, 2).reshape(B, S, -1), "wo", tp)
        x = _mlp(p, x, cfg, policy, tp)
        del p
    x = rms_norm(x[:, -1:], params["norm"], cfg.rms_norm_eps, policy)
    cache.length = S
    return _logits(params, x, policy, cfg, tp)[:, 0], cache


def decode_layers(
    params: Params,
    cfg: LLMConfig,
    *,
    input_ids: torch.Tensor,  # (B, 1)
    positions: torch.Tensor,  # (B, 1) RoPE position of each row's token
    kv_seq_len: int,  # cache capacity (the dynamic-NTK rule reads it)
    cache_k: torch.Tensor,  # (L, N, Hkv, T, D), written in place
    cache_v: torch.Tensor,
    write_rows: torch.Tensor,  # (B,) int64: the cache row of each row's token
    write_pos: torch.Tensor,  # (B,) int64: its position in that row
    attend: Callable[[int, torch.Tensor], torch.Tensor],
    policy: DTypePolicy = DEFAULT_POLICY,
    mesh=None,
) -> torch.Tensor:
    """The decoder stack for one new token per row -> logits (B, V). What
    differs between the decode entry points is where the cache lives: each
    layer's one ``rope_kv`` launch rotates the token's query and key and
    writes the key and its value to ``(layer, write_rows[b], :,
    write_pos[b])`` of ``cache_k`` / ``cache_v``, and ``attend(layer, q)``
    maps the RoPE'd query (B, Hq, 1, D) to the context of the same shape,
    reading what was just written. Under ``mesh`` the heads are the rank's
    (tensor parallel)."""
    DECODE_STEPS.launches += 1
    tp = _tp(params, cfg, mesh)
    x = embed_tokens(params, input_ids, policy.compute_dtype, mesh, cfg)
    B, S, _ = x.shape
    cos, sin = cos_sin_for(cfg, positions, kv_seq_len)
    for i in range(cfg.num_hidden_layers):
        p = _layer(params, i, tp)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps, policy)
        q, k, v = _qkv(p, h, cfg)
        q = rope_kv(q, k, v, cos, sin, cache_k[i], cache_v[i], write_rows, write_pos)
        ctx = attend(i, q)
        x = x + _proj(p, ctx.transpose(1, 2).reshape(B, S, -1), "wo", tp)
        x = _mlp(p, x, cfg, policy, tp)
        del p
    x = rms_norm(x, params["norm"], cfg.rms_norm_eps, policy)
    return _logits(params, x, policy, cfg, tp)[:, 0]


def decode_step(
    params: Params,
    cfg: LLMConfig,
    *,
    input_ids: torch.Tensor,  # (B, 1)
    cache: KVCache,
    kv_valid_mask: Optional[torch.Tensor] = None,  # (B, max_len) 1 = attendable
    policy: DTypePolicy = DEFAULT_POLICY,
    mesh=None,
) -> Tuple[torch.Tensor, KVCache]:
    """One token for every row -> (logits (B, V), cache). Writes slot
    ``cache.length`` of every layer in place and advances ``cache.length``:
    ``decode_step_at`` at that slot. An int32 ``kv_valid_mask`` gets the slot
    marked in place; None attends [0, slot].

    RoPE uses ``cache.length`` (the bucket slot), as the JAX decode_step does
    when called without positions (generate.py); for left-padded rows that
    differs from the prefill's count of valid tokens (a caveat of the
    reference, kept for token parity)."""
    B = input_ids.shape[0]
    dev = cache.k.device
    slot = cache.length
    if kv_valid_mask is None:
        kv_valid_mask = torch.zeros((B, cache.max_len), dtype=torch.int32, device=dev)
        kv_valid_mask[:, :slot] = 1
    logits = decode_step_at(
        params, cfg, input_ids=input_ids, cache=cache, kv_valid=kv_valid_mask.to(torch.int32),
        slot=torch.full((1,), slot, dtype=torch.int64, device=dev), policy=policy, mesh=mesh)
    cache.length = slot + 1
    return logits, cache


def decode_step_at(
    params: Params,
    cfg: LLMConfig,
    *,
    input_ids: torch.Tensor,  # (B, 1)
    cache: KVCache,
    kv_valid: torch.Tensor,  # (B, max_len) int32, 1 = attendable; slot marked in place
    slot: torch.Tensor,  # (1,) int64 on the cache's device: the write slot and RoPE position
    policy: DTypePolicy = DEFAULT_POLICY,
    mesh=None,
) -> torch.Tensor:
    """``decode_step`` with its slot read on the device -> logits (B, V):
    marks ``kv_valid[:, slot]``, writes the token's K/V at ``slot`` of every
    layer and attends the marked slots, all in place. ``cache.length`` is the
    host's bookkeeping and is left alone."""
    B = input_ids.shape[0]
    kv_valid.index_fill_(1, slot, 1)  # the freshly written position
    return decode_layers(
        params, cfg, input_ids=input_ids, positions=slot.view(1, 1).expand(B, 1),
        kv_seq_len=cache.max_len, cache_k=cache.k, cache_v=cache.v,
        write_rows=torch.arange(B, device=slot.device), write_pos=slot.expand(B), policy=policy,
        mesh=mesh, attend=_decode_attend(cache.k, cache.v, kv_valid))


def _decode_attend(cache_k, cache_v, kv_valid):
    return lambda i, q: flash_decode(q, cache_k, cache_v, i, kv_valid)


def prefill_with_prefix(
    params: Params,
    cfg: LLMConfig,
    *,
    inputs_embeds: torch.Tensor,  # (B, S, E) suffix rows, left-padded
    attention_mask: torch.Tensor,  # (B, S) 1 = valid
    prefix_k: torch.Tensor,  # (L, Hkv, P, D) cached prefix KV (RoPE'd at positions 0..P-1)
    prefix_v: torch.Tensor,
    max_len: int,
    cache_dtype=torch.bfloat16,
    policy: DTypePolicy = DEFAULT_POLICY,
    mesh=None,
) -> Tuple[torch.Tensor, KVCache]:
    """Chunked prefill over an already-computed prefix KV (the serving prefix
    cache): only the suffix tokens run through the layers; their queries
    attend the prefix in full and each other causally
    (``flash_attention(..., q_offset=P)``).

    Returns (last logits (B, V), cache) whose per-row region is laid out
    ``[pad | prefix | suffix]`` at ``[padlen, P + S)``, the contiguous
    left-padded region the multislot decode expects. Under ``mesh`` the
    prefix KV and the cache hold the rank's KV heads."""
    tp = _tp(params, cfg, mesh)
    x = inputs_embeds.to(policy.compute_dtype)
    B, S, _ = x.shape
    P = prefix_k.shape[2]
    dev = x.device
    attention_mask = attention_mask.to(torch.int32)
    # suffix positions continue the prefix's 0..P-1 (valid tokens only)
    positions = P + torch.clamp(torch.cumsum(attention_mask, dim=1) - 1, min=0)
    q_seg = torch.where(attention_mask > 0, 0, -1).to(torch.int32)
    kv_seg = torch.cat([torch.zeros((B, P), dtype=torch.int32, device=dev), q_seg], dim=1)
    cos, sin = cos_sin_for(cfg, positions, P + S)
    cache = KVCache.create(cfg, B, max_len, cache_dtype, dev, mesh)

    # a layer's keys come out as [prefix | pad | suffix] per row (the suffix
    # rows were left-padded); the cache wants [pad | prefix | suffix]: column
    # j reads prefix[j - padlen] inside [padlen, padlen + P) and its own
    # column beyond. Columns below padlen are dead (outside [start, length)).
    padlen = (attention_mask == 0).sum(dim=1)  # (B,)
    j = torch.arange(P + S, device=dev)[None]
    gidx = torch.where(j < padlen[:, None] + P,
                       torch.clamp(j - padlen[:, None], 0, P - 1), j)  # (B, P+S)
    Hkv, D = kv_heads(cfg, mesh), cfg.head_dim
    gidx = gidx[:, None, :, None].expand(B, Hkv, P + S, D)

    for i in range(cfg.num_hidden_layers):
        p = _layer(params, i, tp)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps, policy)
        q, k, v = _qkv(p, h, cfg)
        q = apply_rope(q, cos, sin).contiguous()
        k = apply_rope(k, cos, sin)
        kf = torch.cat([prefix_k[i].to(k.dtype)[None].expand(B, -1, -1, -1), k], dim=2)
        vf = torch.cat([prefix_v[i].to(v.dtype)[None].expand(B, -1, -1, -1), v], dim=2)
        ctx = flash_attention(q, kf, vf, causal=True, q_segment_ids=q_seg,
                              kv_segment_ids=kv_seg, q_offset=P)
        cache.k[i, :, :, :P + S] = torch.gather(kf, 2, gidx).to(cache_dtype)
        cache.v[i, :, :, :P + S] = torch.gather(vf, 2, gidx).to(cache_dtype)
        x = x + _proj(p, ctx.transpose(1, 2).reshape(B, S, -1), "wo", tp)
        x = _mlp(p, x, cfg, policy, tp)
        del p
    x = rms_norm(x[:, -1:], params["norm"], cfg.rms_norm_eps, policy)
    cache.length = P + S
    return _logits(params, x, policy, cfg, tp)[:, 0], cache


def decode_step_multislot(
    params: Params,
    cfg: LLMConfig,
    *,
    input_ids: torch.Tensor,  # (B, 1), one in-flight token per slot
    cache_k: torch.Tensor,  # (L, B, Hkv, max_len, D), written in place
    cache_v: torch.Tensor,
    lengths: torch.Tensor,  # (B,) tokens written per slot = this step's write position
    starts: Optional[torch.Tensor] = None,  # (B,) first attendable cache position
    policy: DTypePolicy = DEFAULT_POLICY,
    mesh=None,
) -> torch.Tensor:
    """Continuous-batching decode: every slot advances one token at its own
    position -> logits (B, V). Each layer scatters the new K/V to
    ``(layer, b, :, lengths[b], :)`` of the caller's cache IN PLACE and attends
    ``starts[b] <= pos <= lengths[b]``; RoPE uses the true position
    ``lengths - starts``. The caller advances ``lengths`` for its active
    slots; inactive slots compute garbage that the caller ignores, so their
    ``lengths`` must still index inside the cache."""
    B = input_ids.shape[0]
    dev = cache_k.device
    max_len = cache_k.shape[3]
    lengths = lengths.to(dev, torch.int64)
    slot_pos = torch.arange(max_len, device=dev)[None, :]
    valid = slot_pos <= lengths[:, None]
    positions = lengths[:, None]
    if starts is not None:
        # left-padded prompts: positions before `starts` hold masked pad k/v
        starts = starts.to(dev, torch.int64)
        valid = valid & (slot_pos >= starts[:, None])
        positions = (lengths - starts)[:, None]
    kv_valid = valid.to(torch.int32)
    return decode_layers(
        params, cfg, input_ids=input_ids, positions=positions, kv_seq_len=max_len,
        cache_k=cache_k, cache_v=cache_v, write_rows=torch.arange(B, device=dev),
        write_pos=lengths, policy=policy, mesh=mesh,
        attend=_decode_attend(cache_k, cache_v, kv_valid))
