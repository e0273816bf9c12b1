"""The routed experts of a sparse (MoE) layer: for tokens h (T, E) each
routed to ``topk`` experts ``sel`` (T, topk) with weights ``w`` (T, topk)
fp32,

    y[t] = sum_j w[t, j] SwiGLU_{sel[t, j]}(h[t]),  SwiGLU_e(x) = (silu(x W1_e) * (x W3_e)) W2_e

with each expert's output rounded to h's dtype and the weighted sum taken in
fp32 (the published DeepSeek-V3 ``moe_infer``). The experts' gate and up are
fused, ``w13`` (n, E, 2 Me): eight gate columns, then the eight up columns of
the same outputs (models/mla_moe.fuse_w13); ``w2`` (n, Me, E).

No JAX counterpart (the JAX package's models/moe.py runs every expert on
every token). On the H100 it is the hand-written CUDA kernel
csrc/moe_experts.cu, two grouped products on the tensor cores (mma.sync):
the routed (token, expert) pairs are sorted by expert on the device (a
stable sort, a count and a prefix sum: no host read, so a CUDA graph
captures a decode step's), the gate-up product gathers each pair's token
row and finishes SwiGLU in its epilogue, the down product writes each
pair's row to the pair's own slot, and the weighted sum over a token's
experts is one fp32 reduction. What bounds it: at decode (<= 16 tokens) the
bytes of the touched experts, each read once and an untouched one never; at
prefill, operations. ``tally``: a (1,) int64 device counter to which the
launch adds its experts with at least one row.

``moe_experts_reference`` is the plain version (a loop over the experts);
the wrapper takes it for CPU tensors only.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from callireader_tpu_torch.kernels._build import CudaKernel, check_layout, ptr, refuse_grad

KERNEL_GATE_UP = CudaKernel("moe_experts", "moe_gate_up_launch",
                            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6)
KERNEL_DOWN = CudaKernel("moe_experts", "moe_down_launch", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5)
SMALL_TOKENS = 16  # at most this many tokens: the decode tiles (16 rows an expert at most)
BK, BN = 64, 128  # csrc/moe_experts.cu's depth of a stage and columns of a tile


def split_w13(w13: torch.Tensor):
    """(n, E, 2 Me) fused -> gate, up (n, E, Me)."""
    n, E, M2 = w13.shape
    x = w13.reshape(n, E, M2 // 16, 2, 8)
    return x[..., 0, :].reshape(n, E, M2 // 2), x[..., 1, :].reshape(n, E, M2 // 2)


def _weighted_sum(y: torch.Tensor, w: torch.Tensor, dtype) -> torch.Tensor:
    """y (T, topk, E) -> sum_j w[:, j] y[:, j] in fp32, rounded to ``dtype``."""
    return (y.float() * w[..., None].float()).sum(1).to(dtype)


def _grouping(sel: torch.Tensor, n: int):
    """-> (order (P,) int32: the pairs' slots sorted by expert, counts (n,)
    int32, offsets (n + 1,) int32), all on sel's device, no host read."""
    flat = sel.reshape(-1).to(torch.int32)
    order = torch.argsort(flat, stable=True).to(torch.int32)
    counts = torch.zeros(n, dtype=torch.int32, device=sel.device).scatter_add_(
        0, flat.long(), torch.ones_like(flat))
    offsets = torch.zeros(n + 1, dtype=torch.int32, device=sel.device)
    offsets[1:] = torch.cumsum(counts, 0, dtype=torch.int32)
    return order, counts, offsets


def moe_experts_reference(h: torch.Tensor, sel: torch.Tensor, w: torch.Tensor, w13: torch.Tensor,
                          w2: torch.Tensor, tally: Optional[torch.Tensor] = None) -> torch.Tensor:
    T, k = sel.shape
    gate, up = split_w13(w13)
    y = h.new_zeros((T, k, w2.shape[-1]))
    touched = 0
    for e in range(w13.shape[0]):
        t, j = (sel == e).nonzero(as_tuple=True)
        if t.numel() == 0:
            continue
        touched += 1
        x = h[t]
        y[t, j] = (F.silu(x @ gate[e].to(x.dtype)) * (x @ up[e].to(x.dtype))) @ w2[e].to(x.dtype)
    if tally is not None:
        tally.add_(touched)
    return _weighted_sum(y, w, h.dtype)


def _launch(h, sel, w, w13, w2, tally):
    T, k = sel.shape
    n, K, N2 = w13.shape
    E = w2.shape[-1]
    for name, t in (("h", h), ("w13", w13), ("w2", w2)):
        check_layout(t, name, torch.bfloat16)
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
    if h.shape != (T, K) or w2.shape != (n, N2 // 2, E):
        raise ValueError(f"shapes disagree: h {tuple(h.shape)}, sel {tuple(sel.shape)}, "
                         f"w13 {tuple(w13.shape)}, w2 {tuple(w2.shape)}")
    if K % BK or N2 % BN or (N2 // 2) % BK or E % BN:
        raise ValueError(f"the grouped kernel takes E % {BN}, Me % {BK} == 0 (E={K}, Me={N2 // 2})")
    P = T * k
    order, counts, offsets = _grouping(sel, n)
    if tally is not None:
        tally.add_((counts > 0).sum())
    small = int(T <= SMALL_TOKENS)
    act = torch.empty((P, N2 // 2), dtype=h.dtype, device=h.device)
    y = torch.empty((P, E), dtype=h.dtype, device=h.device)
    KERNEL_GATE_UP(ptr(h), ptr(order), ptr(offsets), ptr(w13), ptr(act), P, n, K, N2, k, small)
    KERNEL_DOWN(ptr(act), ptr(order), ptr(offsets), ptr(w2), ptr(y), P, n, N2 // 2, E, small)
    return _weighted_sum(y.view(T, k, E), w, h.dtype)


def moe_experts(h: torch.Tensor, sel: torch.Tensor, w: torch.Tensor, w13: torch.Tensor,
                w2: torch.Tensor, tally: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shapes as in the module docstring -> (T, E) in h's dtype."""
    if h.device.type == "cpu":
        return moe_experts_reference(h, sel, w, w13, w2, tally)
    refuse_grad("moe_experts", h, w13, w2)
    return _launch(h.contiguous(), sel, w, w13, w2, tally)
