"""Weight-only int8 matrix products of the decode step (PyTorch port of
callireader_tpu/kernels/int8_matmul.py).

    int8_matmul(h, q, scale)      h (M, K) @ dequant(q (K, N), scale (N,))
    int8_matmul_nt(h, q, scale)   h (M, K) @ dequant(q (N, K), scale (N,)).T

fp32 accumulation over K, the fp32 scale applied once, one rounding to
h.dtype: the TPU kernel's arithmetic. On the H100 they are the hand-written
CUDA kernels of csrc/int8_matmul.cu. ``int8_matmul`` also stands for the
JAX ``int8_matmul_stacked``: the TPU needed a separate scalar-prefetch
kernel to read one layer of the (L, K, N) stack in place, while in PyTorch
``q[layer]`` is a view, so the decode step passes the layer's view to this
one kernel.

What bounds them: the int8 weight bytes, about 2*M flops a byte at M <= 32
rows (the decode batch). Per decode step of callireader-8b at batch 4 that
is 32 x 218 MB of projections plus the 380 MB LM head.

The ``*_reference`` functions are the plain PyTorch versions; the wrappers
take them for CPU tensors only. On CUDA the wrappers take bf16 rows, M <= 32,
K and N multiples of 128, contiguous tensors, and raise on anything else.
"""

from __future__ import annotations

import ctypes

import torch

from callireader_tpu_torch.kernels._build import CudaKernel, check_cuda, ptr

KERNEL = CudaKernel("int8_matmul", "int8_matmul_kn_launch", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3)
KERNEL_NT = CudaKernel("int8_matmul", "int8_matmul_nt_launch", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3)
MAX_ROWS = 32
BLOCK = 128  # K and N must be multiples of this
CHUNK = 256  # K rows per block of the (K, N) kernel (csrc/int8_matmul.cu KC)


def int8_matmul_reference(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version, weight (K, N): fp32 product and scale, one rounding."""
    return ((h.float() @ q.float()) * scale.reshape(-1).float()).to(h.dtype)


def int8_matmul_nt_reference(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain version, weight (N, K)."""
    return ((h.float() @ q.float().T) * scale.reshape(-1).float()).to(h.dtype)


def _check(h, q, scale, M, K, N):
    check_cuda(h, "h", torch.bfloat16)
    check_cuda(q, "q", torch.int8)
    check_cuda(scale, "scale", torch.float32)
    if h.dim() != 2 or h.shape[1] != K:
        raise ValueError(f"h {tuple(h.shape)} does not match the weight's K={K}")
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"{M} rows: the int8 kernels take 1..{MAX_ROWS}")
    if K % BLOCK or N % BLOCK:
        raise ValueError(f"K={K} and N={N} must be multiples of {BLOCK}")
    if scale.numel() != N:
        raise ValueError(f"scale has {scale.numel()} values for N={N}")


def _launch(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    M = h.shape[0]
    K, N = q.shape
    _check(h, q, scale, M, K, N)
    part = torch.empty((-(-K // CHUNK), M, N), dtype=torch.float32, device=h.device)
    out = torch.empty((M, N), dtype=h.dtype, device=h.device)
    KERNEL(ptr(h), ptr(q), ptr(scale), ptr(part), ptr(out), M, K, N)
    return out


def _launch_nt(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    M = h.shape[0]
    N, K = q.shape
    _check(h, q, scale, M, K, N)
    out = torch.empty((M, N), dtype=h.dtype, device=h.device)
    KERNEL_NT(ptr(h), ptr(q), ptr(scale), ptr(out), M, K, N)
    return out


def int8_matmul(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """h (M, K) @ dequant(q (K, N) int8, scale (N,) fp32) -> (M, N) in h.dtype."""
    if h.device.type == "cpu":
        return int8_matmul_reference(h, q, scale)
    return _launch(h, q, scale)


def int8_matmul_nt(h: torch.Tensor, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """h (M, K) @ dequant(q (N, K) int8, per-row scale (N,)).T -> (M, N)."""
    if h.device.type == "cpu":
        return int8_matmul_nt_reference(h, q, scale)
    return _launch_nt(h, q, scale)
