"""Causal / non-causal GQA attention with segment ids: the LLM prefill.

Port of callireader_tpu/kernels/attention.py ``flash_attention`` (Pallas,
online softmax over KV blocks, GQA through the BlockSpec index maps, causal
block skipping, segment ids with padding -1/-2 that never match, a static
``q_offset``). On the H100 it is the hand-written CUDA kernel
csrc/flash_attention.cu: a block serves all G query heads of one KV head, so
each KV head is read once per group and never repeated; key tiles above the
causal diagonal are never loaded; rows that attend to nothing are zeros.

What bounds it: operations. At the prefill shape (B pages, Hq = 32,
Hkv = 8, S = 3584, D = 128) the causal work is ~2*B*Hq*S^2*D flops against a
few hundred MB. The first version runs the products as fp32 FMAs on the
CUDA cores; tensor cores come later.

Layout: q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D); Hq % Hkv == 0.
``attention_reference`` is the plain PyTorch version; the wrapper uses it for
CPU tensors only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from callireader_tpu_torch.kernels._build import CudaKernel, check_cuda, ptr

KERNEL = CudaKernel(
    "flash_attention", "flash_attention_launch",
    [ctypes.c_void_p] * 6
    + [ctypes.c_int] * 8
    + [ctypes.c_float],
)
SUPPORTED_SHAPES = ((128, 4), (64, 1))  # (D, Hq // Hkv) pairs that csrc/flash_attention.cu instantiates


def attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Plain version, fp32 softmax. q (B,Hq,Sq,D), k/v (B,Hkv,Sk,D) ->
    (B,Hq,Sq,D). A row with no attendable key is zeros (the kernel's rule;
    the JAX reference would average V there, a case no caller reaches)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    if scale is None:
        scale = D**-0.5
    qr = q.reshape(B, Hkv, G, Sq, D).float()
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qr, k.float()) * scale
    mask = torch.ones((1, 1, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        q_pos = torch.arange(Sq, device=q.device) + q_offset
        k_pos = torch.arange(Sk, device=q.device)
        mask = mask & (q_pos[:, None] >= k_pos[None, :])
    if q_segment_ids is not None:
        seg = q_segment_ids[:, :, None] == kv_segment_ids[:, None, :]  # (B,Sq,Sk)
        mask = mask & seg[:, None, None]
    logits = logits.masked_fill(~mask, float("-inf"))
    any_valid = mask.any(dim=-1, keepdim=True)
    probs = torch.softmax(logits.masked_fill(~any_valid, 0.0), dim=-1)
    probs = probs * any_valid
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def _launch(q, k, v, causal, q_segment_ids, kv_segment_ids, scale, q_offset):
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_cuda(t, name, torch.bfloat16)
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, Dk = k.shape
    if Dk != D or v.shape != k.shape or k.shape[0] != B:
        raise ValueError("q/k/v shapes disagree")
    if Hq % Hkv or (D, Hq // Hkv) not in SUPPORTED_SHAPES:
        raise ValueError(f"unsupported attention shape D={D} Hq={Hq} Hkv={Hkv}")
    qs = ks = None
    if q_segment_ids is not None:
        qs = q_segment_ids.to(torch.int32).contiguous()
        ks = kv_segment_ids.to(torch.int32).contiguous()
        if qs.shape != (B, Sq) or ks.shape != (B, Sk) or not (qs.is_cuda and ks.is_cuda):
            raise ValueError("segment ids must be CUDA (B, Sq) / (B, Sk)")
    out = torch.empty_like(q)
    KERNEL(
        ptr(q), ptr(k), ptr(v), ptr(out),
        None if qs is None else ptr(qs), None if ks is None else ptr(ks),
        B, Hq, Hkv, Sq, Sk, D, int(causal), int(q_offset), float(scale),
    )
    return out


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """Shapes as in ``attention_reference``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_reference(
            q, k, v, causal=causal, q_segment_ids=q_segment_ids,
            kv_segment_ids=kv_segment_ids, scale=scale, q_offset=q_offset,
        )
    return _launch(q, k, v, causal, q_segment_ids, kv_segment_ids, scale, q_offset)
