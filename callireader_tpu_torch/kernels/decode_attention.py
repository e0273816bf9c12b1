"""Single-token GQA decode attention over the whole stacked KV cache.

Port of callireader_tpu/kernels/decode_attention.py ``flash_decode``: q
(B, Hq, 1, D) against the stacked cache (L, B, Hkv, S, D) at one layer index,
with a per-row (B, S) validity mask. On the H100 it is the hand-written CUDA
kernel csrc/flash_decode.cu: split-K over key chunks (blocks over
(chunk, KV head, row), then a combine pass), reading the cache layer in
place — no per-layer slice is ever materialised.

What bounds it: the bytes of the cache layer (2*B*Hkv*S*D*2 per call, about
half a flop per byte). Split-K exists so that B <= 4 rows times 8 KV heads
still spread over all 132 SMs.

``flash_decode_reference`` is the plain PyTorch version; the wrapper uses it
for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from callireader_tpu_torch.kernels._build import CudaKernel, check_cuda, ptr

KERNEL = CudaKernel(
    "flash_decode", "flash_decode_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float],
)
CHUNK = 128  # keys per split-K block (csrc/flash_decode.cu CK)
SUPPORTED_SHAPES = ((128, 4),)  # (D, Hq // Hkv) pairs that csrc/flash_decode.cu instantiates


def flash_decode_reference(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    layer_idx: int,
    valid_mask: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version: fp32 masked softmax over the layer's cache rows."""
    B, Hq, _, D = q.shape
    Hkv, S = cache_k.shape[2], cache_k.shape[3]
    G = Hq // Hkv
    if scale is None:
        scale = D**-0.5
    k = cache_k[layer_idx].float()  # (B, Hkv, S, D)
    v = cache_v[layer_idx].float()
    qg = q[:, :, 0].reshape(B, Hkv, G, D).float()
    logits = torch.einsum("bhgd,bhsd->bhgs", qg, k) * scale
    valid = (valid_mask > 0)[:, None, None, :]
    logits = logits.masked_fill(~valid, float("-inf"))
    any_valid = valid.any(dim=-1, keepdim=True)
    probs = torch.softmax(logits.masked_fill(~any_valid, 0.0), dim=-1) * any_valid
    out = torch.einsum("bhgs,bhsd->bhgd", probs, v)
    return out.reshape(B, Hq, 1, D).to(q.dtype)


def _launch(q, cache_k, cache_v, layer_idx, valid_mask, scale):
    check_cuda(q, "q", torch.bfloat16)
    check_cuda(cache_k, "cache_k", torch.bfloat16)
    check_cuda(cache_v, "cache_v", torch.bfloat16)
    B, Hq, one, D = q.shape
    L, Bc, Hkv, S, Dc = cache_k.shape
    if one != 1 or Bc != B or Dc != D or cache_v.shape != cache_k.shape:
        raise ValueError("q/cache shapes disagree")
    if Hq % Hkv or (D, Hq // Hkv) not in SUPPORTED_SHAPES:
        raise ValueError(f"unsupported decode shape D={D} Hq={Hq} Hkv={Hkv}")
    if not 0 <= layer_idx < L:
        raise ValueError(f"layer {layer_idx} out of range {L}")
    valid = valid_mask.to(torch.int32).contiguous()
    if valid.shape != (B, S) or not valid.is_cuda:
        raise ValueError("valid_mask must be a CUDA (B, S) tensor")
    nc = -(-S // CHUNK)
    part_acc = torch.empty((B, Hq, nc, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, Hq, nc, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    KERNEL(
        ptr(q), ptr(cache_k), ptr(cache_v), ptr(valid), ptr(part_acc), ptr(part_ml),
        ptr(out), B, Hq, Hkv, S, D, int(layer_idx), nc, float(scale),
    )
    return out


def flash_decode(
    q: torch.Tensor,
    cache_k: torch.Tensor,
    cache_v: torch.Tensor,
    layer_idx: int,
    valid_mask: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """-> (B, Hq, 1, D) in q.dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_decode_reference(q, cache_k, cache_v, layer_idx, valid_mask, scale=scale)
    return _launch(q, cache_k, cache_v, layer_idx, valid_mask, scale)
