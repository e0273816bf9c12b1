"""LLaVA-family VLM wrapper (PyTorch port of callireader_tpu/models/llava.py):
vision tower + depth-N GELU MLP projector + LLM.

Parity target: train/xtuner/model/llava.py — a ViT, a ``ProjectorModel``
(depth-2 GELU MLP, :51-74) and an LLM; projected patch features are spliced
into the text embedding sequence at the ``<image>`` placeholder
(``prepare_inputs_labels_for_multimodal``, :302). The splice keeps the JAX
package's static shape: each row's single placeholder expands to
``n_patch`` feature rows, S' = S - 1 + n_patch for every row.

The tower is models/internvit.py (attention through kernels/vit_attention.py
on the card), the LLM models/internlm2.py (its training forward: attention
through kernels/attention_bwd.flash_attention_trainable, whose backward
gives the grads, and every norm through kernels/rmsnorm.py).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy, require_device
from callireader_tpu_torch.models import internlm2, internvit
from callireader_tpu_torch.runtime import weights

Params = Dict[str, Any]

IMAGE_TOKEN_INDEX = -200  # llava constant: the placeholder id in input_ids


def init_projector(generator: torch.Generator, visual_hidden: int, llm_hidden: int,
                   depth: int = 2, dtype=torch.bfloat16, device="cuda") -> Params:
    """mlp{depth}x_gelu projector (llava.py:51-74): Linear -> (GELU, Linear)*,
    kernels N(0, 0.02) drawn in fp32, zero biases."""
    r = weights._Init(generator, require_device(device), dtype)
    layers, d_in = [], visual_hidden
    for _ in range(depth):
        layers.append({"kernel": r.normal((d_in, llm_hidden), 0.02), "bias": r.zeros((llm_hidden,))})
        d_in = llm_hidden
    return {"layers": layers}


def projector_logical_axes(depth: int = 2) -> Params:
    """Logical sharding annotations of ``init_projector``'s tree."""
    return {"layers": [
        {"kernel": ("embed", "mlp"), "bias": ("mlp",)} for _ in range(depth)
    ]}


def project(params: Params, feats: torch.Tensor) -> torch.Tensor:
    h = feats
    for i, layer in enumerate(params["layers"]):
        if i:
            h = F.gelu(h, approximate="none")
        h = h @ layer["kernel"].to(h.dtype) + layer["bias"].to(h.dtype)
    return h


def select_features(hidden_states: torch.Tensor, select_type: str = "patch") -> torch.Tensor:
    """llava visual feature selection: drop CLS ('patch') or keep it
    ('cls_patch'); hidden_states (B, 1+N, C) with CLS first."""
    if select_type == "patch":
        return hidden_states[:, 1:]
    if select_type == "cls_patch":
        return hidden_states
    raise ValueError(select_type)


def prepare_inputs_labels_for_multimodal(
    llm_params: Params,
    cfg,
    input_ids: torch.Tensor,  # (B, S) with one IMAGE_TOKEN_INDEX per row
    image_feats: torch.Tensor,  # (B, n_patch, llm_hidden) projected features
    labels: Optional[torch.Tensor] = None,  # (B, S)
    *,
    ignore_index: int = -100,
    compute_dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    """Expand each row's image placeholder into its n_patch feature rows ->
    (inputs_embeds (B, S', E), labels' (B, S') or None, mask (B, S') int32).
    Image rows get ``ignore_index`` labels (llava semantics). Text row j
    lands at j before the placeholder and at j + n_patch - 1 from it on: the
    placeholder's own row lands on the last image row, which overwrites it,
    as the JAX scatters do."""
    B, S = input_ids.shape
    n_patch = image_feats.shape[1]
    S2 = S - 1 + n_patch
    dev = input_ids.device

    is_img = input_ids == IMAGE_TOKEN_INDEX
    img_pos = is_img.int().argmax(dim=1)  # the first placeholder (0 where none)
    safe_ids = torch.where(is_img, torch.zeros_like(input_ids), input_ids)
    text_embeds = internlm2.embed_tokens(llm_params, safe_ids, compute_dtype)
    image_feats = image_feats.to(compute_dtype)

    j = torch.arange(S, device=dev)[None, :]
    tgt_text = torch.where(j < img_pos[:, None], j, j + n_patch - 1)  # (B, S)
    bidx = torch.arange(B, device=dev)[:, None].expand(B, S)
    tgt_img = img_pos[:, None] + torch.arange(n_patch, device=dev)[None, :]  # (B, n_patch)
    bidx2 = torch.arange(B, device=dev)[:, None].expand(B, n_patch)
    # out of place, so that autograd carries the grads to both sources
    out = text_embeds.new_zeros((B, S2, text_embeds.shape[-1]))
    out = out.index_put((bidx, tgt_text), text_embeds)
    out = out.index_put((bidx2, tgt_img), image_feats)

    new_labels = None
    if labels is not None:
        lab = torch.full((B, S2), ignore_index, dtype=labels.dtype, device=dev)
        lab[bidx, tgt_text] = labels
        lab[bidx2, tgt_img] = ignore_index
        new_labels = lab

    mask = torch.ones((B, S2), dtype=torch.int32, device=dev)
    return out, new_labels, mask


def init_llava_params(cfg, generator: torch.Generator, dtype=torch.bfloat16,
                      projector_depth: int = 2, device="cuda") -> Params:
    """Full LLaVA parameter tree: vision tower + projector + LLM (the JAX
    tree's names and shapes, seeded from ``generator``)."""
    r = weights._Init(generator, require_device(device), dtype)
    return {
        "vit": weights.init_vision(r, cfg.vision),
        "projector": init_projector(generator, cfg.vision.hidden_size, cfg.llm.hidden_size,
                                    projector_depth, dtype, device),
        "llm": weights.init_llm(r, cfg.llm),
    }


def llava_loss(
    params: Params,
    cfg,
    pixel_values: torch.Tensor,  # (B, H, W, 3)
    input_ids: torch.Tensor,  # (B, S)
    labels: torch.Tensor,  # (B, S)
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
    visual_select: str = "patch",
    freeze_vit: bool = True,
) -> torch.Tensor:
    """Training forward: ViT -> select -> project -> splice -> LLM CE loss
    (llava.py:280-350 semantics); the mean over labelled next tokens.
    ``freeze_vit`` detaches the tower's features (the JAX stop_gradient). The
    ViT attention kernel has no backward, so on the card the tower trains
    only where a caller runs it elsewhere: ``freeze_vit=False`` raises
    there."""
    if not freeze_vit and pixel_values.device.type == "cuda":
        raise NotImplementedError("freeze_vit=False on the card: the ViT attention kernel "
                                  "(kernels/vit_attention.py) has no backward")
    feats = internvit.forward(params["vit"], cfg.vision, pixel_values, policy=policy)
    if freeze_vit:
        feats = feats.detach()
    feats = project(params["projector"], select_features(feats, visual_select))
    embeds, lab, _ = prepare_inputs_labels_for_multimodal(
        params["llm"], cfg.llm, input_ids, feats, labels, compute_dtype=policy.compute_dtype)
    logits = internlm2.forward(params["llm"], cfg.llm, inputs_embeds=embeds, policy=policy)
    shift_logits = logits[:, :-1].float()
    shift_labels = lab[:, 1:]
    valid = shift_labels != -100
    logp = torch.log_softmax(shift_logits, dim=-1)
    tok = -logp.gather(-1, shift_labels.clamp(min=0)[..., None].long())[..., 0]
    return torch.where(valid, tok, torch.zeros_like(tok)).sum() / valid.sum().clamp(min=1)
