"""Single-token GQA decode attention over a paged KV pool.

Port of callireader_tpu/kernels/paged_decode.py ``paged_flash_decode``: q
(B, Hq, 1, D) of every serving slot against its own pages of the global pool
(L, NPAGES, Hkv, page, D) at one layer index, with the slot's page ids in
``page_table`` (B, P) and a per-token validity mask (B, P, page). On the H100
it is the hand-written CUDA kernel csrc/paged_decode.cu: a block owns a run
of RUN table entries of one (slot, KV head); its producer warp lists the
run's live chunks of up to 64 keys (page id in the pool, a valid key) and
streams their K, V and flags by bulk copies into a ring of shared-memory
stages, four consumer warps keep an online softmax over them for the G
query heads at once, and a combine pass (shared with csrc/flash_decode.cu)
merges a slot's runs in table order. A dead entry or chunk is never read
for K or V.

What bounds it: the bytes of the live keys and values (2 * live * Hkv * D * 2
per call, about 4 flops a byte); a dead run costs one short block and no
K or V traffic.

``paged_flash_decode_reference`` is the plain PyTorch version (gather the
slot's pages, masked fp32 softmax); the wrapper uses it for CPU tensors only.
A CUDA tensor always takes the kernel; a shape the kernel lacks raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from callireader_tpu_torch.kernels._build import CudaKernel, check_cuda, ptr, refuse_grad
from callireader_tpu_torch.kernels.decode_attention import SUPPORTED_SHAPES, flash_decode_reference

KERNEL = CudaKernel(
    "paged_decode", "paged_decode_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 + [ctypes.c_float],
)
MAX_PAGE = 128  # two 64-key ring stages a page (csrc/paged_decode.cu PD_MAX_PAGE)
PAGE_MULTIPLE = 16
RUN = 4  # table entries a block, one partial each (csrc/paged_decode.cu PD_RUN)


def paged_flash_decode_reference(
    q: torch.Tensor,
    kpool: torch.Tensor,
    vpool: torch.Tensor,
    layer_idx: int,
    page_table: torch.Tensor,
    valid: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain version: gather each slot's pages into a (B, Hkv, P * page, D)
    cache, then the masked fp32 softmax of ``flash_decode_reference``. Table
    entries outside the pool are clamped; their keys must be masked."""
    B = q.shape[0]
    _, NP, Hkv, page, D = kpool.shape
    P = page_table.shape[1]
    table = page_table.long().clamp(0, NP - 1)
    k = kpool[layer_idx][table].permute(0, 2, 1, 3, 4).reshape(1, B, Hkv, P * page, D)
    v = vpool[layer_idx][table].permute(0, 2, 1, 3, 4).reshape(1, B, Hkv, P * page, D)
    return flash_decode_reference(q, k, v, 0, valid.reshape(B, P * page), scale=scale)


def _launch(q, kpool, vpool, layer_idx, page_table, valid, scale):
    check_cuda(q, "q", torch.bfloat16)
    check_cuda(kpool, "kpool", torch.bfloat16)
    check_cuda(vpool, "vpool", torch.bfloat16)
    B, Hq, one, D = q.shape
    L, NP, Hkv, page, Dc = kpool.shape
    if one != 1 or Dc != D or vpool.shape != kpool.shape:
        raise ValueError("q/pool shapes disagree")
    if Hq % Hkv or (D, Hq // Hkv) not in SUPPORTED_SHAPES:
        raise ValueError(f"unsupported decode shape D={D} Hq={Hq} Hkv={Hkv}")
    if page % PAGE_MULTIPLE or not 0 < page <= MAX_PAGE:
        raise ValueError(
            f"page size {page}: the kernel takes multiples of {PAGE_MULTIPLE} up to {MAX_PAGE}")
    if not 0 <= layer_idx < L:
        raise ValueError(f"layer {layer_idx} out of range {L}")
    if page_table.dim() != 2 or page_table.shape[0] != B or not page_table.is_cuda:
        raise ValueError("page_table must be a CUDA (B, P) tensor")
    P = page_table.shape[1]
    if valid.shape != (B, P, page) or not valid.is_cuda:
        raise ValueError("valid must be a CUDA (B, P, page) tensor")
    table = page_table.to(torch.int32).contiguous()
    valid = valid.to(torch.int32).contiguous()
    if valid.data_ptr() % 16:  # the flags go by 16-byte bulk copies
        valid = valid.clone()
    runs = -(-P // RUN)
    part_acc = torch.empty((B, Hq, runs, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B, Hq, runs, 2), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    KERNEL(
        ptr(q), ptr(kpool), ptr(vpool), ptr(table), ptr(valid), ptr(part_acc), ptr(part_ml),
        ptr(out), B, Hq, Hkv, P, page, NP, D, int(layer_idx), float(scale),
    )
    return out


def paged_flash_decode(
    q: torch.Tensor,  # (B, Hq, 1, D)
    kpool: torch.Tensor,  # (L, NPAGES, Hkv, page, D)
    vpool: torch.Tensor,
    layer_idx: int,
    page_table: torch.Tensor,  # (B, P) int32 pool page ids; unused entries are masked by valid
    valid: torch.Tensor,  # (B, P, page) int32 token validity
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """-> (B, Hq, 1, D) in q.dtype; a slot with no valid key gives zeros."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return paged_flash_decode_reference(q, kpool, vpool, layer_idx, page_table, valid,
                                            scale=scale)
    refuse_grad("paged_flash_decode", q, kpool, vpool)
    return _launch(q, kpool, vpool, layer_idx, page_table, valid, scale)
