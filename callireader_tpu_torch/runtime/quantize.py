"""int8 quantization (PyTorch port of callireader_tpu/runtime/quantize.py):
weight-only int8 for the LLM, and the W8A8 ViT of ``--quant int8-all``.

Scheme: symmetric per-output-channel absmax scales.
  w (.., in, out)  ->  q int8 (.., in, out), scale f32 (.., 1, out)
  y = (h @ q) * scale

Quantized leaves sit in the same tree as ``{name}_q`` + ``{name}_scale``
(the ViT's as ``{name}_kernel_q`` + ``{name}_kernel_scale``); models/internlm2
and models/internvit dispatch on their presence. The arithmetic is the JAX
package's (fp32 division by the scale, round half to even, clip to
[-127, 127]), so the same fp32 tree quantizes to the same bits in both.

``quantized_logical_axes`` / ``quantized_vit_logical_axes`` extend the
models' sharding annotations over the quantized leaves; a mesh takes the
unfused layout (``unfuse_llm_int8``).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch

from callireader_tpu_torch.core.config import LLMConfig

QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
VIT_QUANT_TARGETS = ("qkv", "proj", "fc1", "fc2")
FUSED = (("wqkv", ("wq", "wk", "wv")), ("w13", ("w1", "w3")))


def _quant(w: torch.Tensor, dims: Tuple[int, ...]) -> Tuple[torch.Tensor, torch.Tensor]:
    """absmax over ``dims`` -> (int8 q, fp32 scale with ``dims`` kept as 1)."""
    wf = w.float()
    absmax = wf.abs().amax(dim=dims, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_weight(w: torch.Tensor, axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax int8 along all dims except ``axis`` (the out-channel
    dim keeps its own scale)."""
    return _quant(w, tuple(i for i in range(w.ndim) if i != axis % w.ndim))


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantize_llm_int8(llm_params: Dict[str, Any]) -> Dict[str, Any]:
    """New LLM tree with int8 projections: the stacked (L, in, out) weights
    of ``QUANT_TARGETS`` get per-(layer, out) scales (L, 1, out); the vocab
    tables (V, E) per-row scales (V, 1)."""
    out = dict(llm_params)
    layers = dict(llm_params["layers"])
    for name in QUANT_TARGETS:
        layers[f"{name}_q"], layers[f"{name}_scale"] = _quant(layers.pop(name), (1,))
    out["layers"] = layers
    for name in ("tok_embeddings", "output"):
        out[f"{name}_q"], out[f"{name}_scale"] = _quant(out.pop(name), (1,))
    return out


def quantize_vit_int8(vision_params: Dict[str, Any],
                      targets: Sequence[str] = VIT_QUANT_TARGETS) -> Dict[str, Any]:
    """New ViT tree with int8 layer linears: the stacked ``{name}_kernel``
    (L, in, out) become ``{name}_kernel_q`` int8 and per-(layer, out-channel)
    ``{name}_kernel_scale`` fp32 (L, 1, out). Patch-embed, the norms and the
    layer scales stay as they are; models/internvit runs the quantized
    linears as W8A8. Each layer's (in, out) codes are laid out column-major
    (strides (in * out, 1, in)): torch._int_mm on the H100 takes 4.7-7x
    longer over a row-major right operand at the towers' shapes."""
    out = dict(vision_params)
    layers = dict(out["layers"])
    for name in targets:
        q, layers[f"{name}_kernel_scale"] = _quant(layers.pop(f"{name}_kernel"), (1,))
        layers[f"{name}_kernel_q"] = q.transpose(1, 2).contiguous().transpose(1, 2)
    out["layers"] = layers
    return out


def dequantize_llm_int8(llm_params: Dict[str, Any], targets: Sequence[str] = QUANT_TARGETS,
                        dtype=torch.bfloat16) -> Dict[str, Any]:
    """Inverse of quantize_llm_int8: ``{name}_q`` / ``{name}_scale`` leaves
    folded back to dense weights, q * scale in fp32 then ``dtype`` (the int8
    rounding of the original weights)."""
    out = dict(llm_params)
    layers = dict(out["layers"])
    for name in targets:
        q = layers.pop(f"{name}_q", None)
        if q is None:
            continue
        layers[name] = (q.float() * layers.pop(f"{name}_scale")).to(dtype)
    out["layers"] = layers
    for name in ("tok_embeddings", "output"):
        q = out.pop(f"{name}_q", None)
        if q is None:
            continue
        out[name] = (q.float() * out.pop(f"{name}_scale")).to(dtype)
    return out


def fuse_llm_int8(llm_params: Dict[str, Any]) -> Dict[str, Any]:
    """Concatenate the int8 Q/K/V (and gate/up) projections along the out
    axis into ``wqkv_q`` / ``w13_q`` (and their scales): 4 decode products a
    layer instead of 7. Per-out-channel scales concatenate losslessly and the
    output columns are independent, so splitting the fused output equals the
    separate products (bit for bit on the card: csrc/int8_matmul.cu fixes
    each column's summation order by K alone). Returns the tree unchanged
    when LoRA adapter leaves are present (they attach to the unfused names)
    or when there is nothing to fuse. Single-device layout: the fused out
    axis does not shard over a tensor mesh."""
    layers = llm_params.get("layers", {})
    if any(k.endswith("_lora_a") for k in layers):
        return llm_params
    layers = dict(layers)
    changed = False
    for fused, parts in FUSED:
        if f"{fused}_q" in layers or not all(f"{p}_q" in layers for p in parts):
            continue
        layers[f"{fused}_q"] = torch.cat([layers.pop(f"{p}_q") for p in parts], dim=-1)
        layers[f"{fused}_scale"] = torch.cat([layers.pop(f"{p}_scale") for p in parts], dim=-1)
        changed = True
    if not changed:
        return llm_params
    out = dict(llm_params)
    out["layers"] = layers
    return out


def unfuse_llm_int8(llm_params: Dict[str, Any], cfg: LLMConfig) -> Dict[str, Any]:
    """Inverse of fuse_llm_int8: ``wqkv_q`` / ``w13_q`` (and their scales)
    split back into wq/wk/wv and w1/w3 along the out axis, each a contiguous
    copy (the layout a tensor mesh shards). The unfused products give the
    same bits as the fused ones."""
    layers = dict(llm_params["layers"])
    if not any(f"{fused}_q" in layers for fused, _ in FUSED):
        return llm_params
    Hq, Hkv, D, M = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                     cfg.intermediate_size)
    widths = {"wqkv": (Hq * D, Hkv * D, Hkv * D), "w13": (M, M)}
    for fused, parts in FUSED:
        for suffix in ("_q", "_scale"):
            w = layers.pop(f"{fused}{suffix}", None)
            if w is None:
                continue
            for p, piece in zip(parts, torch.split(w, widths[fused], dim=-1)):
                layers[f"{p}{suffix}"] = piece.contiguous()
            del w, piece
    out = dict(llm_params)
    out["layers"] = layers
    return out


def quantized_logical_axes(axes: Dict[str, Any], params: Dict[str, Any]) -> Dict[str, Any]:
    """Extend an LLM logical-axis tree for quantized leaves: ``{name}_q``
    inherits the dense leaf's axes, its scale only the out-channel one; the
    fused leaves' out axis crosses q/k/v (gate/up), so it stays unsharded."""
    layers = dict(axes["layers"])
    for name in QUANT_TARGETS:
        if f"{name}_q" in params["layers"]:
            base = layers.pop(name, ("stack", "embed", "mlp"))
            layers[f"{name}_q"] = base
            layers[f"{name}_scale"] = ("stack", None, base[-1])
    for fused, dropped in FUSED:
        if f"{fused}_q" in params["layers"]:
            for p in dropped:
                layers.pop(p, None)
            layers[f"{fused}_q"] = ("stack", "embed", None)
            layers[f"{fused}_scale"] = ("stack", None, None)
    out = dict(axes)
    out["layers"] = layers
    for name in ("tok_embeddings", "output"):
        if f"{name}_q" in params:
            base = out.pop(name, ("vocab", "embed"))
            out[f"{name}_q"] = base
            out[f"{name}_scale"] = ("vocab", None)
    return out


def quantized_vit_logical_axes(axes: Dict[str, Any], params: Dict[str, Any]) -> Dict[str, Any]:
    """Extend a ViT logical-axis tree for quantized leaves."""
    layers = dict(axes["layers"])
    for name in VIT_QUANT_TARGETS:
        if f"{name}_kernel_q" in params["layers"]:
            base = layers.pop(f"{name}_kernel", ("stack", "vit_embed", None))
            layers[f"{name}_kernel_q"] = base
            layers[f"{name}_kernel_scale"] = ("stack", None, base[-1])
    out = dict(axes)
    out["layers"] = layers
    return out


def init_llm_int8(cfg: LLMConfig, generator: torch.Generator, *, dtype=torch.bfloat16,
                  device="cuda") -> Dict[str, Any]:
    """Seeded random LLM drawn directly as int8 + scales in the fused layout
    (the counterpart of the JAX ``init_llm_int8_device(fused=True)``, with a
    torch.Generator: other numbers, same tree, shapes and dtypes).

    Each layer of each stacked leaf is drawn as N(0, 0.02) in ``dtype``,
    reduced to its per-out-channel scales and rounded into a preallocated
    int8 stack, so the peak is the int8 tree plus one layer's fp32 draft,
    never the 15 GB bf16 tree of the 8B. The vocab tables go the same way in
    row blocks. Per-out-channel scales make drawing ``wqkv`` / ``w13`` whole
    the same as quantizing the parts and concatenating."""
    L, E, M = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, D, V = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim, cfg.vocab_size
    shapes = {"wqkv": (E, (Hq + 2 * Hkv) * D), "wo": (Hq * D, E), "w13": (E, 2 * M), "w2": (M, E)}

    def draw(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        return (w * 0.02).to(dtype)

    layers: Dict[str, Any] = {
        "attn_norm": torch.ones((L, E), dtype=dtype, device=device),
        "ffn_norm": torch.ones((L, E), dtype=dtype, device=device),
    }
    for name, (k, n) in shapes.items():
        q = torch.empty((L, k, n), dtype=torch.int8, device=device)
        s = torch.empty((L, 1, n), dtype=torch.float32, device=device)
        for i in range(L):
            q[i], s[i] = _quant(draw((k, n)), (0,))
        layers[f"{name}_q"], layers[f"{name}_scale"] = q, s
    out: Dict[str, Any] = {"layers": layers, "norm": torch.ones((E,), dtype=dtype, device=device)}
    rows = 8192
    for name in ("tok_embeddings", "output"):
        q = torch.empty((V, E), dtype=torch.int8, device=device)
        s = torch.empty((V, 1), dtype=torch.float32, device=device)
        for lo in range(0, V, rows):
            hi = min(V, lo + rows)
            q[lo:hi], s[lo:hi] = _quant(draw((hi - lo, E)), (1,))
        out[f"{name}_q"], out[f"{name}_scale"] = q, s
    return out


def param_bytes(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(param_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()
