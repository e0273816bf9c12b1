"""Tensor-parallel wrappers of the attention kernels (PyTorch port of
callireader_tpu/parallel/tp_attention.py).

Attention is independent over heads. Under a mesh with "tensor" = t, the
column-parallel wq / wk / wv of models/internlm2.py leave each rank its
Hq/t query heads and Hkv/t KV heads, and its KV cache or page pool holds
only those KV heads; each wrapper runs the port's own CUDA kernel on that
block, and no collective runs inside (the JAX ``shard_map`` splits global
arrays; here the arrays are already the rank's block). The group size
G = Hq / Hkv stays that of the whole model (4 at the 8b's 32:8), which the
prefill, decode and paged kernels take. Since a rank's tensors already
hold its heads, models/internlm2.py and the batchers call the kernel
wrappers themselves; these keep the JAX names, with a check of the heads'
grouping.
"""

from __future__ import annotations

from typing import Optional

import torch

from callireader_tpu_torch.core.partition import Mesh
from callireader_tpu_torch.kernels.attention import flash_attention
from callireader_tpu_torch.kernels.decode_attention import flash_decode
from callireader_tpu_torch.kernels.paged_decode import paged_flash_decode


def tp_active(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and int(mesh.shape.get("tensor", 1)) > 1


def _check(q: torch.Tensor, kv_heads: int, mesh: Mesh, what: str) -> None:
    if q.shape[1] % kv_heads:
        raise ValueError(f"{what}: {q.shape[1]} query heads over {kv_heads} KV heads on rank "
                         f"{mesh.rank('tensor')} of tensor={mesh.axis_size('tensor')}")


def flash_attention_tp(
    q: torch.Tensor,  # (B, Hq/t, S, D): this rank's heads
    k: torch.Tensor,  # (B, Hkv/t, S, D)
    v: torch.Tensor,
    mesh: Mesh,
    *,
    causal: bool = False,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    """flash_attention on this rank's heads -> (B, Hq/t, S, D)."""
    _check(q, k.shape[1], mesh, "flash_attention_tp")
    return flash_attention(q, k, v, causal=causal, q_segment_ids=q_segment_ids,
                           kv_segment_ids=kv_segment_ids, q_offset=q_offset)


def flash_decode_tp(
    q: torch.Tensor,  # (B, Hq/t, 1, D)
    cache_k: torch.Tensor,  # (L, B, Hkv/t, S, D): this rank's KV heads
    cache_v: torch.Tensor,
    layer_idx: int,
    valid_mask: torch.Tensor,  # (B, S)
    mesh: Mesh,
) -> torch.Tensor:
    """flash_decode on this rank's heads of the cache -> (B, Hq/t, 1, D)."""
    _check(q, cache_k.shape[2], mesh, "flash_decode_tp")
    return flash_decode(q, cache_k, cache_v, layer_idx, valid_mask)


def paged_flash_decode_tp(
    q: torch.Tensor,  # (B, Hq/t, 1, D)
    kpool: torch.Tensor,  # (L, NP, Hkv/t, page, D): this rank's KV heads of the pool
    vpool: torch.Tensor,
    layer_idx: int,
    page_table: torch.Tensor,  # (B, P), the same on every rank
    valid: torch.Tensor,  # (B, P, page)
    mesh: Mesh,
) -> torch.Tensor:
    """paged_flash_decode on this rank's heads of the pools (the page
    bookkeeping is head-oblivious: the tables are the same on every rank)."""
    _check(q, kpool.shape[2], mesh, "paged_flash_decode_tp")
    return paged_flash_decode(q, kpool, vpool, layer_idx, page_table, valid)
