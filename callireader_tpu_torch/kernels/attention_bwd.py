"""Trainable flash attention: causal GQA with segment ids, forward and backward.

Port of callireader_tpu/kernels/attention_bwd.py ``flash_attention_trainable``
(a ``jax.custom_vjp`` over three Pallas kernels: the forward that saves each
row's log-sum-exp, the dq kernel and the dk/dv kernel). Here it is one
``torch.autograd.Function``, ``FlashAttentionTrainable``; on the H100 its
forward and backward launch the hand-written CUDA kernels of
csrc/flash_attention_bwd.cu:

- forward: the tensor-core loop of csrc/flash_common.cuh that the ViT and
  prefill kernels run (wgmma, TMA; sm_90a; a block serves the G query heads
  of one KV head, key tiles above the diagonal or whose segment ids share no
  value with the query tile's are never loaded), built with its lse
  epilogue: o (bf16) and lse = m + log(l) (fp32, (B, Hq, S)); a row with no
  attendable key gets o = 0 and lse = -1e30;
- dq: a tensor-core loop (wgmma, TMA; sm_90a): a block's warpgroup owns 16
  query positions of each of the G heads of a KV head, K/V tiles of 64 keys
  stream in by TMA, S = Q K^T and dP = dO V^T on the tensor cores, P =
  exp(S - lse) recomputed in fp32, dQ += dS K on the tensor cores;
- dk/dv: a tensor-core loop in which a block owns 64 keys of a KV head and
  streams the Q and dO tiles of the G heads at or below the diagonal:
  S^T = K Q^T, dP^T = V dO^T, dV += P^T dO, dK += dS^T Q, dK and dV kept in
  the block (no atomics: the same result on every run).

dS = P * (dP - D) * scale with D = rowsum(dO * O), a plain torch reduction
computed once per backward, as in the JAX rule. What bounds the kernels on
the card: operations (2, 3 and 4 products of 2 * D flops per attended pair).
The products take bf16 operands: P (and, in the backward, dS) goes in
split into two bf16 parts (hi = bf16(x), lo = bf16(x - hi)), as one bf16 rounding
misses the fp32 check by 21-46x (kernels/tolerance.py), and the dk/dv loop
moves dK and dV into fp32 sums in shared memory every 8 query tiles, since
the tensor cores' accumulation drifts over long sums. All three loops skip
tiles that hold no attended pair (above the diagonal, or tiles whose segment
ids share no value).

Masks: segment ids compare for equality only (the collator pads both q and kv
with -1, so pad queries attend to pad keys, as in JAX; the loss ignores those
rows). The kernels mask ragged edges themselves: the wrapper adds no padding.

``attention_fwd_lse_reference`` and ``attention_bwd_reference`` are the plain
versions (fp32 math on the same inputs); the Function takes them for CPU
tensors only. On CUDA it launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from callireader_tpu_torch.kernels._build import CudaKernel, check_cuda, ptr

NEG_INF = -1e30  # lse of a row with no attendable key
SOURCE = "flash_attention_bwd"
_SHAPE_ARGS = [ctypes.c_int] * 7 + [ctypes.c_float]  # B, Hq, Hkv, Sq, Sk, D, causal, scale
KERNEL_FWD = CudaKernel(SOURCE, "attn_train_fwd_launch", [ctypes.c_void_p] * 7 + _SHAPE_ARGS)
KERNEL_DQ = CudaKernel(SOURCE, "attn_train_dq_launch", [ctypes.c_void_p] * 9 + _SHAPE_ARGS)
KERNEL_DKV = CudaKernel(SOURCE, "attn_train_dkv_launch", [ctypes.c_void_p] * 10 + _SHAPE_ARGS)
SUPPORTED_SHAPES = ((128, 4),)  # (D, Hq // Hkv) pairs that csrc/flash_attention_bwd.cu instantiates


# ---------------------------------------------------------------- plain versions


def _allowed(q, k, causal, q_segment_ids, kv_segment_ids) -> torch.Tensor:
    """(B or 1, 1, 1, Sq, Sk) bool: the pairs a query may attend."""
    Sq, Sk = q.shape[2], k.shape[2]
    mask = torch.ones((1, 1, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril()
    if q_segment_ids is not None:
        mask = mask & (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])[:, None, None]
    return mask


def _grouped(x: torch.Tensor, Hkv: int) -> torch.Tensor:
    """(B, Hq, S, D) -> (B, Hkv, G, S, D) in fp32."""
    B, Hq, S, D = x.shape
    return x.float().reshape(B, Hkv, Hq // Hkv, S, D)


def attention_fwd_lse_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward in fp32: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) ->
    (o (B, Hq, Sq, D), lse (B, Hq, Sq)), both fp32."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if scale is None:
        scale = D**-0.5
    s = torch.einsum("bhgqd,bhkd->bhgqk", _grouped(q, Hkv), k.float()) * scale
    s = s.masked_fill(~_allowed(q, k, causal, q_segment_ids, kv_segment_ids), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)  # -inf where a row attends to nothing
    has_key = torch.isfinite(lse)
    p = torch.exp(s - torch.where(has_key, lse, 0.0)[..., None])
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    lse = torch.where(has_key, lse, NEG_INF)
    return o.reshape(B, Hq, Sq, D), lse.reshape(B, Hq, Sq)


def attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor],
    kv_segment_ids: Optional[torch.Tensor],
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    causal: bool = True,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain backward in fp32 by the FlashAttention-2 formulas, P recomputed
    from ``lse`` -> (dq, dk, dv), fp32."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    if scale is None:
        scale = D**-0.5
    qg, dog = _grouped(q, Hkv), _grouped(do, Hkv)
    kf, vf = k.float(), v.float()
    lse = lse.float().reshape(B, Hkv, Hq // Hkv, Sq)
    has_key = lse > NEG_INF / 2
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, kf) * scale
    keep = _allowed(q, k, causal, q_segment_ids, kv_segment_ids) & has_key[..., None]
    p = torch.where(keep, torch.exp(s - torch.where(has_key, lse, 0.0)[..., None]), 0.0)
    dsum = (dog * _grouped(o, Hkv)).sum(-1)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, vf)
    ds = p * (dp - dsum[..., None]) * scale
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf).reshape(B, Hq, Sq, D)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p, dog)
    return dq, dk, dv


# ---------------------------------------------------------------- kernels


def _segments(seg: Optional[torch.Tensor], B: int, S: int) -> Optional[torch.Tensor]:
    if seg is None:
        return None
    seg = seg.to(torch.int32).contiguous()
    if seg.shape != (B, S) or not seg.is_cuda:
        raise ValueError(f"segment ids must be CUDA ({B}, {S}), got {tuple(seg.shape)}")
    return seg


def _check(q, k, v, *extra):
    for name, t in (("q", q), ("k", k), ("v", v)) + extra:
        check_cuda(t, name, torch.bfloat16)
    B, Hq, Sq, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or k.shape[3] != D or v.shape != k.shape:
        raise ValueError("q/k/v shapes disagree")
    Hkv = k.shape[1]
    if Hq % Hkv or (D, Hq // Hkv) not in SUPPORTED_SHAPES:
        raise ValueError(f"unsupported attention shape D={D} Hq={Hq} Hkv={Hkv}")
    return B, Hq, Hkv, Sq, k.shape[2], D


def _check_bwd(q, k, v, do, lse, dsum):
    dims = _check(q, k, v, ("do", do))
    B, Hq, _, Sq, _, _ = dims
    if do.shape != q.shape:
        raise ValueError("do must have q's shape")
    for name, t in (("lse", lse), ("dsum", dsum)):
        check_cuda(t, name, torch.float32)
        if t.shape != (B, Hq, Sq):
            raise ValueError(f"{name} must be (B, Hq, Sq)")
    return dims


def _seg_ptrs(q_segment_ids, kv_segment_ids, B, Sq, Sk):
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("give both segment id tensors or neither")
    qs, ks = _segments(q_segment_ids, B, Sq), _segments(kv_segment_ids, B, Sk)
    return qs, ks, (None if qs is None else ptr(qs)), (None if ks is None else ptr(ks))


def _launch_fwd(q, k, v, q_segment_ids, kv_segment_ids, causal, scale):
    """-> (o bf16 (B, Hq, Sq, D), lse fp32 (B, Hq, Sq))."""
    B, Hq, Hkv, Sq, Sk, D = _check(q, k, v)
    qs, ks, qs_p, ks_p = _seg_ptrs(q_segment_ids, kv_segment_ids, B, Sq, Sk)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    KERNEL_FWD(ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse), qs_p, ks_p,
               B, Hq, Hkv, Sq, Sk, D, int(causal), float(scale))
    return o, lse


def _launch_dq(q, k, v, do, lse, dsum, q_segment_ids, kv_segment_ids, causal, scale):
    B, Hq, Hkv, Sq, Sk, D = _check_bwd(q, k, v, do, lse, dsum)
    qs, ks, qs_p, ks_p = _seg_ptrs(q_segment_ids, kv_segment_ids, B, Sq, Sk)
    dq = torch.empty_like(q)
    KERNEL_DQ(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(dsum), qs_p, ks_p, ptr(dq),
              B, Hq, Hkv, Sq, Sk, D, int(causal), float(scale))
    return dq


def _launch_dkv(q, k, v, do, lse, dsum, q_segment_ids, kv_segment_ids, causal, scale):
    B, Hq, Hkv, Sq, Sk, D = _check_bwd(q, k, v, do, lse, dsum)
    qs, ks, qs_p, ks_p = _seg_ptrs(q_segment_ids, kv_segment_ids, B, Sq, Sk)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    KERNEL_DKV(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(dsum), qs_p, ks_p, ptr(dk), ptr(dv),
               B, Hq, Hkv, Sq, Sk, D, int(causal), float(scale))
    return dk, dv


def _fwd(q, k, v, q_segment_ids, kv_segment_ids, causal, scale):
    """-> (o in q's dtype, lse fp32)."""
    if q.device.type == "cpu":
        o, lse = attention_fwd_lse_reference(q, k, v, q_segment_ids, kv_segment_ids, causal, scale)
        return o.to(q.dtype), lse
    return _launch_fwd(q, k, v, q_segment_ids, kv_segment_ids, causal, scale)


def _bwd(q, k, v, q_segment_ids, kv_segment_ids, o, lse, do, causal, scale):
    """-> (dq, dk, dv) in the dtypes of q, k, v."""
    if q.device.type == "cpu":
        dq, dk, dv = attention_bwd_reference(q, k, v, q_segment_ids, kv_segment_ids, o, lse, do,
                                             causal, scale)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    do = do.contiguous()
    dsum = (do.float() * o.float()).sum(-1)  # D = rowsum(dO * O), once for both kernels
    dq = _launch_dq(q, k, v, do, lse, dsum, q_segment_ids, kv_segment_ids, causal, scale)
    dk, dv = _launch_dkv(q, k, v, do, lse, dsum, q_segment_ids, kv_segment_ids, causal, scale)
    return dq, dk, dv


class FlashAttentionTrainable(torch.autograd.Function):
    """o = attention(q, k, v); the backward recomputes P from the saved lse."""

    @staticmethod
    def forward(ctx, q, k, v, q_segment_ids, kv_segment_ids, causal, scale):
        o, lse = _fwd(q, k, v, q_segment_ids, kv_segment_ids, causal, scale)
        ctx.save_for_backward(q, k, v, q_segment_ids, kv_segment_ids, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, q_seg, kv_seg, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, q_seg, kv_seg, o, lse, do, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention_trainable(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable attention, q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) ->
    (B, Hq, Sq, D); segment ids (B, Sq) / (B, Sk) or both None."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return FlashAttentionTrainable.apply(q, k, v, q_segment_ids, kv_segment_ids, causal, scale)
