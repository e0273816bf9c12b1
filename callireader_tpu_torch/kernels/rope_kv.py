"""The decode token's RoPE and its KV-cache write in one launch.

The JAX package has no kernel for this: its decode step is one XLA program,
which fuses the rotate-half RoPE of q and k and the cache's dynamic update
into the step. The port runs the step eagerly (or as a CUDA graph of eager
launches), where the plain form is sixteen launches a layer; on the H100 it
is the hand-written CUDA kernel csrc/rope_kv.cu, one launch a layer, one
thread a (row, head, d < D/2) pair. What bounds it: launch latency (a layer
moves ~0.2 MB at the 8b decode shape).

For one new token per row b, with q (B, Hq, 1, D), k and v (B, Hkv, 1, D)
(strided views, e.g. the split of the fused wqkv product), the step's RoPE
tables cos / sin (B, 1, D) fp32, a pair of layer views cache_k / cache_v
(N, Hkv, T, D) and int64 ``rows`` / ``pos`` (B,):

    q_out                      = apply_rope(q)                  (B, Hq, 1, D) contiguous
    cache_k[rows[b], :, pos[b]] = apply_rope(k)[b] in the cache's dtype
    cache_v[rows[b], :, pos[b]] = v[b] in the cache's dtype

``apply_rope`` rounds as the model always has: each product and the sum in
fp32, then the activations' dtype; the kernel gives its bits. Rows that
share a destination (the paged route's inactive slots all write the trash
page) leave whichever write lands last.

``rope_kv_reference`` is the plain form (``apply_rope`` and two indexed
writes); the wrapper takes it for CPU tensors only. On CUDA the kernel takes
bf16 or fp32 activations and caches and raises on anything else.
"""

from __future__ import annotations

import ctypes

import torch

from callireader_tpu_torch.kernels._build import CudaKernel, refuse_grad

KERNEL = CudaKernel("rope_kv", "rope_kv_launch",
                    [ctypes.c_void_p] * 10 + [ctypes.c_longlong] * 11 + [ctypes.c_int] * 8)
DTYPES = {torch.bfloat16: 0, torch.float32: 1}


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, H, S, D); cos/sin (B, S, D); rotate-half, in fp32."""
    cos = cos[:, None].float()
    sin = sin[:, None].float()
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)


def rope_kv_reference(q, k, v, cos, sin, cache_k, cache_v, rows, pos) -> torch.Tensor:
    """Plain form -> the rotated q (B, Hq, 1, D), contiguous; writes the
    rotated k and v at (rows[b], :, pos[b]) of the caches."""
    q = apply_rope(q, cos, sin).contiguous()
    k = apply_rope(k, cos, sin)
    # the two index tensors are split by a slice, so the indexed dim comes
    # first: the target is (B, Hkv, D), which k and v already are
    cache_k[rows, :, pos] = k[:, :, 0].to(cache_k.dtype)
    cache_v[rows, :, pos] = v[:, :, 0].to(cache_v.dtype)
    return q


def _code(t: torch.Tensor, name: str) -> int:
    code = DTYPES.get(t.dtype)
    if code is None:
        raise ValueError(f"rope_kv takes bf16 or fp32 {name}, got {t.dtype}")
    return code


def _check(q, k, v, cos, sin, cache_k, cache_v, rows, pos):
    """What the kernel takes, wherever the tensors lie -> (activation,
    cache) dtype codes; raises ValueError on anything else."""
    B, Hq, one, D = q.shape
    Hkv = k.shape[1]
    N, Hc, T, Dc = cache_k.shape
    if one != 1 or k.shape != (B, Hkv, 1, D) or v.shape != k.shape or D % 2:
        raise ValueError(f"rope_kv: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}: "
                         f"one token a row, an even head width, k and v alike")
    if Hc != Hkv or Dc != D or cache_v.shape != cache_k.shape \
            or cache_v.stride() != cache_k.stride() or cache_k.stride(3) != 1:
        raise ValueError(f"rope_kv: caches {tuple(cache_k.shape)} / {tuple(cache_v.shape)} for "
                         f"{Hkv} KV heads of width {D}, alike and with unit stride along D")
    if k.dtype != q.dtype or v.dtype != q.dtype or cache_v.dtype != cache_k.dtype:
        raise ValueError("rope_kv: q, k and v share a dtype, and the two caches one")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("rope_kv: q, k and v need unit stride along D")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.dtype != torch.float32 or t.shape != (B, 1, D) or not t.is_contiguous():
            raise ValueError(f"rope_kv: {name} must be contiguous fp32 (B, 1, D), got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in (("rows", rows), ("pos", pos)):
        if t.dtype != torch.int64 or t.shape != (B,):
            raise ValueError(f"rope_kv: {name} must be int64 (B,), got {t.dtype} {tuple(t.shape)}")
    return _code(q, "activations"), _code(cache_k, "caches")


def _launch(q, k, v, cos, sin, cache_k, cache_v, rows, pos) -> torch.Tensor:
    tensors = (q, k, v, cos, sin, cache_k, cache_v, rows, pos)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError("rope_kv: every tensor must lie on q's CUDA device")
    x_code, c_code = _check(*tensors)
    B, Hq, _, D = q.shape
    N, Hkv, T, _ = cache_k.shape
    q_out = torch.empty((B, Hq, 1, D), dtype=q.dtype, device=q.device)
    KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), cos.data_ptr(), sin.data_ptr(),
           rows.data_ptr(), pos.data_ptr(), q_out.data_ptr(), cache_k.data_ptr(),
           cache_v.data_ptr(), q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
           v.stride(1), rows.stride(0), pos.stride(0), cache_k.stride(0), cache_k.stride(1),
           cache_k.stride(2), B, Hq, Hkv, D, N, T, x_code, c_code)
    return q_out


def rope_kv(
    q: torch.Tensor,  # (B, Hq, 1, D)
    k: torch.Tensor,  # (B, Hkv, 1, D)
    v: torch.Tensor,  # (B, Hkv, 1, D)
    cos: torch.Tensor,  # (B, 1, D) fp32
    sin: torch.Tensor,
    cache_k: torch.Tensor,  # (N, Hkv, T, D), written in place
    cache_v: torch.Tensor,
    rows: torch.Tensor,  # (B,) int64: the cache row each token goes to
    pos: torch.Tensor,  # (B,) int64: its position in that row
) -> torch.Tensor:
    """-> the rotated q (B, Hq, 1, D), contiguous; the rotated k and v are
    written into the caches at (rows[b], :, pos[b])."""
    if q.is_cpu:
        return rope_kv_reference(q, k, v, cos, sin, cache_k, cache_v, rows, pos)
    refuse_grad("rope_kv", q, k, v)
    return _launch(q, k, v, cos, sin, cache_k, cache_v, rows, pos)
