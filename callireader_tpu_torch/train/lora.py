"""LoRA adapters for the LLM layer stack (PyTorch port of
callireader_tpu/train/lora.py).

Adapters are extra stacked leaves inside ``params["llm"]["layers"]``:
``{name}_lora_a`` (L, in, r), ``{name}_lora_b`` (L, r, out) and one
``lora_scale`` (L,) = alpha / r, which models/internlm2._proj picks up as
``y + ((h @ a) @ b) * scale``. No dropout: the JAX ``_proj`` has none.
``lora_logical_axes`` gives the leaves' sharding annotations
(core/partition.py).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

from callireader_tpu_torch.core.config import LLMConfig

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def add_lora(
    llm_params: Dict[str, Any],
    cfg: LLMConfig,
    generator: torch.Generator,
    *,
    rank: int = 128,
    alpha: float = 256.0,
    targets: Sequence[str] = DEFAULT_TARGETS,
    dtype=torch.float32,
) -> Dict[str, Any]:
    """A new params tree with LoRA leaves added: A ~ N(0, 1) / r drawn from
    ``generator`` (on the weights' device) in ``targets`` order, B = 0
    (peft-style: the adapters start as the identity)."""
    layers = dict(llm_params["layers"])
    L = cfg.num_hidden_layers
    for name in targets:
        w = layers[name]
        _, d_in, d_out = w.shape
        a = torch.randn((L, d_in, rank), generator=generator, dtype=torch.float32,
                        device=generator.device) * (1.0 / rank)
        layers[f"{name}_lora_a"] = a.to(dtype)
        layers[f"{name}_lora_b"] = torch.zeros((L, rank, d_out), dtype=dtype, device=w.device)
    layers["lora_scale"] = torch.full((L,), alpha / rank, dtype=dtype, device=generator.device)
    out = dict(llm_params)
    out["layers"] = layers
    return out


def lora_logical_axes(llm_axes: Dict[str, Any], targets: Sequence[str] = DEFAULT_TARGETS) -> Dict[str, Any]:
    """Extend the LLM logical-axis tree with LoRA leaf annotations (the JAX
    rule as it stands: the out dim of wq/wk/wv/wo's B is "qkv", of the
    others "mlp")."""
    layers = dict(llm_axes["layers"])
    for name in targets:
        layers[f"{name}_lora_a"] = ("stack", "embed", None)
        layers[f"{name}_lora_b"] = ("stack", None, "qkv" if name in ("wq", "wk", "wv", "wo") else "mlp")
    layers["lora_scale"] = ("stack",)
    out = dict(llm_axes)
    out["layers"] = layers
    return out


def lora_param_names(targets: Sequence[str] = DEFAULT_TARGETS) -> List[str]:
    names = [f"{n}_lora_{ab}" for n in targets for ab in ("a", "b")]
    return names + ["lora_scale"]


def merge_lora(llm_params: Dict[str, Any], targets: Sequence[str] = DEFAULT_TARGETS) -> Dict[str, Any]:
    """Fold the adapters into the dense weights (in fp32, stored back in each
    weight's dtype) and drop the LoRA leaves: peft's merge_and_unload."""
    layers = dict(llm_params["layers"])
    scale = layers.get("lora_scale")
    for name in targets:
        a = layers.pop(f"{name}_lora_a", None)
        b = layers.pop(f"{name}_lora_b", None)
        if a is None:
            continue
        delta = torch.einsum("lir,lro->lio", a.float(), b.float()) * scale[:, None, None].float()
        layers[name] = (layers[name].float() + delta).to(layers[name].dtype)
    layers.pop("lora_scale", None)
    out = dict(llm_params)
    out["layers"] = layers
    return out
