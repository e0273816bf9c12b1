"""Single-token GQA decode attention over the whole stacked KV cache.

Port of callireader_tpu/kernels/decode_attention.py ``flash_decode``: q
(B, Hq, 1, D) against the stacked cache (L, B, Hkv, S, D) at one layer index,
with a per-row (B, S) validity mask. On the H100 it is the hand-written CUDA
kernel csrc/flash_decode.cu, reading the cache layer in place (no per-layer
slice is ever materialised): blocks over (run, KV head, row), a run being
``run_chunks(B, Hkv, S)`` chunks of ``CHUNK`` keys whose valid ones a
producer warp copies into a shared-memory ring by bulk copies; four warps
keep their own online softmaxes over 16 keys of each chunk, merged in warp
order into a partial per run, and a second pass merges the runs in order.

What bounds it: the bytes of the valid keys and values (2*valid*Hkv*D*2 per
call, about four flops a byte). Runs exist so that B <= 4 rows times 8 KV
heads still spread over all 132 SMs; chunks with no valid key are not read.

``flash_decode_reference`` is the plain PyTorch version; the wrapper uses it
for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from callireader_tpu_torch.kernels._build import CudaKernel, refuse_grad

KERNEL = CudaKernel(
    "flash_decode", "flash_decode_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_float],
)
CHUNK = 64  # keys of a ring stage (csrc/flash_decode.cu FD_CHUNK)
MAX_RUN = 8  # chunks a block walks at most (FD_MAX_RUN)
# blocks the run length keeps at least: 7/8 of the 264 the H100 holds at
# once (two on each of its 132 SMs, the kernel's 96 KB ring each). A block's
# fixed cost (its flags, its first copy, the warps' merge, its partial)
# outweighs a second wave: at the 8b batch, runs of 8 chunks (256 blocks)
# take 28.8 us, runs of 4 (480) 32.3, of 2 35.0, of 1 46.2; but a grid that
# leaves SMs idle loses more: at the CLI's batch 1, runs of 2 (288 blocks)
# 13.0 us, of 4 (144) 14.5 (tools/decode_stream_probe.py, H100 80GB HBM3)
TARGET_BLOCKS = 2 * 132 * 7 // 8
SUPPORTED_SHAPES = ((128, 4),)  # (D, Hq // Hkv) pairs that csrc/flash_decode.cu instantiates


def run_chunks(B: int, Hkv: int, S: int) -> int:
    """Chunks a block walks: the longest run, a power of two up to
    ``MAX_RUN``, that still gives ``TARGET_BLOCKS`` blocks. A function of the
    shape alone, so a shape always sums in the same order (the 8b batch,
    B=4 S=3840: 8 chunks, 256 blocks; the CLI, B=1 S=4608: 2, 288)."""
    R = 1
    while R < MAX_RUN and B * Hkv * -(-n_chunks(S) // (2 * R)) >= TARGET_BLOCKS:
        R *= 2
    return R


def n_chunks(S: int) -> int:
    """Chunks of ``CHUNK`` keys in a row of S keys, the last one ragged."""
    return -(-S // CHUNK)


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
    if not (q.is_cuda and cache_k.is_cuda and cache_v.is_cuda and valid_mask.is_cuda):
        raise ValueError("flash_decode takes CUDA tensors")
    if not (q.dtype == cache_k.dtype == cache_v.dtype == torch.bfloat16):
        raise ValueError("flash_decode takes bf16 q and caches")
    if not (q.is_contiguous() and cache_k.is_contiguous() and cache_v.is_contiguous()):
        raise ValueError("flash_decode takes contiguous q and caches")
    if valid_mask.dtype != torch.int32 or not valid_mask.is_contiguous():
        valid_mask = valid_mask.to(torch.int32).contiguous()
    B, Hq, one, D = q.shape
    L, Bc, Hkv, S, Dc = cache_k.shape
    if one != 1 or Bc != B or Dc != D or cache_v.shape != cache_k.shape:
        raise ValueError("q/cache shapes disagree")
    if Hq % Hkv or (D, Hq // Hkv) not in SUPPORTED_SHAPES:
        raise ValueError(f"unsupported decode shape D={D} Hq={Hq} Hkv={Hkv}")
    if not 0 <= layer_idx < L:
        raise ValueError(f"layer {layer_idx} out of range {L}")
    if valid_mask.shape != (B, S):
        raise ValueError("valid_mask must be (B, S)")
    pk, pv = cache_k.data_ptr(), cache_v.data_ptr()
    if pk % 16 or pv % 16:
        raise ValueError("the caches must be 16-byte aligned")
    R = run_chunks(B, Hkv, S)
    runs = -(-n_chunks(S) // R)
    part = torch.empty((B * Hq * runs * (D + 2),), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    KERNEL(q.data_ptr(), pk, pv, valid_mask.data_ptr(), part.data_ptr(), out.data_ptr(),
           B, Hq, Hkv, S, D, layer_idx, R, scale)
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
    if q.is_cpu:
        return flash_decode_reference(q, cache_k, cache_v, layer_idx, valid_mask, scale=scale)
    refuse_grad("flash_decode", q, cache_k, cache_v)
    return _launch(q, cache_k, cache_v, layer_idx, valid_mask, scale)
