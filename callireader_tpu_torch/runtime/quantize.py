"""Weight-only int8 quantization of the LLM (PyTorch port of
callireader_tpu/runtime/quantize.py, the LLM half).

Scheme: symmetric per-output-channel absmax scales.
  w (.., in, out)  ->  q int8 (.., in, out), scale f32 (.., 1, out)
  y = (h @ q) * scale

Quantized leaves sit in the same tree as ``{name}_q`` + ``{name}_scale``;
models/internlm2 dispatches on their presence. The arithmetic is the JAX
package's (fp32 division by the scale, round half to even, clip to
[-127, 127]), so the same fp32 tree quantizes to the same bits in both.

Not ported here: the sharding-axis helpers (they wait for the port's
parallel layer) and the W8A8 ViT of ``--quant int8-all``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from callireader_tpu_torch.core.config import LLMConfig

QUANT_TARGETS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
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
