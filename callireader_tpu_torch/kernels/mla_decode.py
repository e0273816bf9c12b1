"""Latent attention's decode (the absorbed form) over a latent cache.

No JAX counterpart (the JAX package's LLM is InternLM2). For each batch row
b and query head h, with q (B, H, R + Dr) the absorbed query [q_nope W_kb^T
| rope(q_pe)] and the layer's cache kv (B, T, R + Dr) of latent rows
[RMSNorm(c_kv) | rope(k_pe)]:

    out[b, h] = softmax_j(q[b, h] . kv[b, j] * scale) kv[b, j, :R]

over the keys j <= slot with kv_valid[b, j] != 0 (``slot`` (1,) int64 on the
device: a CUDA graph of the decode step reads it anew at each replay).

On the H100 it is the hand-written CUDA kernel csrc/mla_decode.cu: the 16
heads are the M of mma.sync m16n8k16, so one pass over a row's latent rows
serves all of them; keys split over blocks (``splits``), merged by a
combine launch. What bounds it: bytes (each valid latent row, 1152 B, read
once a step). Shapes it takes: H = 16, R = 512, Dr = 64 (Moonlight's).

``latent_decode_reference`` is the plain version; the wrapper takes it for
CPU tensors only.
"""

from __future__ import annotations

import ctypes

import torch

from callireader_tpu_torch.kernels._build import CudaKernel, check_layout, ptr, refuse_grad

KERNEL = CudaKernel("mla_decode", "latent_decode_launch",
                    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                                                   ctypes.c_float])
SUPPORTED_SHAPES = ((16, 512, 64),)  # (H, R, Dr) that csrc/mla_decode.cu computes
SMS = 132  # the H100's streaming multiprocessors


def splits_for(B: int, T: int) -> int:
    """Blocks a row: about one block an SM over the batch, at most one a
    chunk of 32 keys."""
    return max(1, min(64, -(-SMS // B), -(-T // 32)))


def latent_decode_reference(q: torch.Tensor, kv: torch.Tensor, kv_valid: torch.Tensor,
                            slot: torch.Tensor, R: int, scale: float) -> torch.Tensor:
    """Plain version: fp32 scores and softmax; a row with no valid key is
    zeros. -> (B, H, R) in q's dtype."""
    T = kv.shape[1]
    s = torch.einsum("bhd,btd->bht", q.float(), kv.float()) * scale
    ok = (kv_valid != 0) & (torch.arange(T, device=kv.device)[None] <= slot.view(1, 1))
    s = s.masked_fill(~ok[:, None], float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1))
    return torch.einsum("bht,btr->bhr", p, kv[..., :R].float()).to(q.dtype)


def _launch(q, kv, kv_valid, slot, R, scale):
    B, H, Dl = q.shape
    T = kv.shape[1]
    check_layout(q, "q", torch.bfloat16)
    if not (q.is_cuda and kv.is_cuda and kv_valid.is_cuda and slot.is_cuda):
        raise ValueError("latent_decode takes CUDA tensors")
    if (H, R, Dl - R) not in SUPPORTED_SHAPES or kv.dtype != torch.bfloat16:
        raise ValueError(f"unsupported latent decode shape H={H} R={R} Dr={Dl - R} ({kv.dtype})")
    if kv.shape != (B, T, Dl) or kv.stride(2) != 1 or kv.stride(1) != Dl or kv.data_ptr() % 16:
        raise ValueError("kv must be (B, T, R + Dr) with contiguous rows, 16-byte aligned")
    if kv_valid.shape != (B, T) or kv_valid.dtype != torch.int32 or not kv_valid.is_contiguous():
        raise ValueError("kv_valid must be contiguous (B, T) int32")
    if slot.dtype != torch.int64 or slot.numel() != 1:
        raise ValueError("slot must be one int64")
    S = splits_for(B, T)
    o_part = torch.empty((B, S, H, R), dtype=torch.float32, device=q.device)
    ml = torch.empty((2, B, S, H), dtype=torch.float32, device=q.device)
    out = torch.empty((B, H, R), dtype=q.dtype, device=q.device)
    KERNEL(ptr(q), ptr(kv), ptr(kv_valid), ptr(slot), ptr(o_part), ptr(ml[0]), ptr(ml[1]), ptr(out),
           B, T, kv.stride(0), S, float(scale))
    return out


def latent_decode(q: torch.Tensor, kv: torch.Tensor, kv_valid: torch.Tensor, slot: torch.Tensor,
                  R: int, scale: float) -> torch.Tensor:
    """Shapes as in the module docstring -> (B, H, R)."""
    if q.device.type == "cpu":
        return latent_decode_reference(q, kv, kv_valid, slot, R, scale)
    refuse_grad("latent_decode", q, kv)
    return _launch(q, kv, kv_valid, slot, R, scale)
