"""Causal attention of latent attention's prefill: query and key heads of
Dqk = qk_nope + qk_rope (192 at Moonlight-16B-A3B), value heads of Dv (128),
one query head a key head, segment ids (left padding -1 on both sides).

No JAX counterpart (the JAX package's LLM is InternLM2). On the H100 it is
the hand-written CUDA kernel csrc/mla_prefill.cu: flash_common.cuh's
tensor-core loop (wgmma, TMA, the softmax weights split into two bf16
parts) with a V tile narrower than Q and K. What bounds it: operations (the
causal pairs of a page batch's 3.5k-token prompts, 16 heads).

Layout: q, k (B, S, H, Dqk), v (B, S, H, Dv), strided views with a unit last
stride (the model passes its products' outputs as they are), segment ids
(B, S) int32 -> out (B, S, H, Dv). ``mla_prefill_reference`` is the plain
version; the wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from callireader_tpu_torch.kernels._build import CudaKernel, ptr, refuse_grad
from callireader_tpu_torch.kernels.attention import attention_reference

KERNEL = CudaKernel("mla_prefill", "mla_prefill_launch",
                    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 12
                    + [ctypes.c_float])
SUPPORTED_SHAPES = ((192, 128),)  # (Dqk, Dv) that csrc/mla_prefill.cu instantiates


def mla_prefill_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          segment_ids: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version, fp32 softmax; a row that attends nothing is zeros."""
    B, S, H, Dqk = q.shape
    Dv = v.shape[-1]
    # attention_reference takes one width: v padded with zero columns to Dqk
    vp = torch.cat([v, v.new_zeros(B, S, H, Dqk - Dv)], dim=-1) if Dv < Dqk else v
    out = attention_reference(q.transpose(1, 2), k.transpose(1, 2), vp.transpose(1, 2), causal=True,
                              q_segment_ids=segment_ids, kv_segment_ids=segment_ids, scale=scale)
    return out.transpose(1, 2)[..., :Dv].contiguous()


def _launch(q, k, v, segment_ids, scale):
    B, S, H, Dqk = q.shape
    Dv = v.shape[-1]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda or t.dtype != torch.bfloat16:
            raise ValueError(f"{name} must be a bf16 CUDA tensor")
        if t.shape[:3] != (B, S, H) or t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(f"{name}: (B, S, H, D) with a unit last stride, the others multiples of "
                             f"8 elements, 16-byte aligned; got {tuple(t.shape)} {t.stride()}")
    if k.shape[-1] != Dqk or (Dqk, Dv) not in SUPPORTED_SHAPES:
        raise ValueError(f"unsupported latent prefill shape Dqk={Dqk} Dv={Dv}")
    seg = segment_ids.to(torch.int32).contiguous()
    if seg.shape != (B, S) or not seg.is_cuda:
        raise ValueError("segment ids must be CUDA (B, S)")
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=q.device)

    def strides(t):
        return t.stride(1), t.stride(2), t.stride(0)  # sequence, head, batch

    KERNEL(ptr(q), ptr(k), ptr(v), ptr(out), ptr(seg), B, S, H,
           *strides(q), *strides(k), *strides(v), *strides(out), float(scale))
    return out


def mla_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          segment_ids: torch.Tensor, *, scale: float) -> torch.Tensor:
    """Shapes as in the module docstring."""
    if q.device.type == "cpu":
        return mla_prefill_reference(q, k, v, segment_ids, scale)
    refuse_grad("mla_prefill_attention", q, k, v)
    return _launch(q, k, v, segment_ids, scale)
