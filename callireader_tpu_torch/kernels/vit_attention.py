"""ViT attention from packed QKV: (B, S, 3E) -> (B, S, E), non-causal.

Port of three JAX kernels that compute one function:
  - callireader_tpu/kernels/vit_attention.py ``attention_from_packed_qkv_nomax``
    (``vit_attention_nomax``, the tile tower's default on the TPU);
  - the same file's ``attention_from_packed_qkv`` (``vit_attention_single_pass``,
    the rowmax-shifted "precise" variant);
  - callireader_tpu/kernels/packed_qkv_attention.py
    ``flash_attention_packed_qkv`` (the D % 64 != 0 route, taken by the compact
    char tower at D = 32).

On the H100 all three are one hand-written CUDA kernel (csrc/vit_attention.cu,
templated on D in {32, 64}), exposed under the three JAX names. It reads q, k
and v of each head from the packed rows through strides and writes (B, S, E)
directly: no transposes. It uses a plain online softmax in fp32; the TPU's
max-free exp2 trick is a workaround for the TPU vector unit and is not
carried over (the port matches its outputs, not its overflow bound).

What bounds it: operations (4*B*H*S^2*D flops against 8*B*S*E bytes; at the
tile tower's S = 1025 that is ~250 flops per byte). The first version runs
the products as fp32 FMAs on the CUDA cores; tensor cores come later.

``vit_attention_reference`` is the plain PyTorch version: the wrapper uses it
for CPU tensors only; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from callireader_tpu_torch.kernels._build import CudaKernel, check_cuda, ptr

KERNEL = CudaKernel(
    "vit_attention", "vit_attention_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
     ctypes.c_int, ctypes.c_float],
)
SUPPORTED_HEAD_DIMS = (32, 64)


def vit_attention_reference(
    qkv: torch.Tensor, num_heads: int, *, scale: Optional[float] = None
) -> torch.Tensor:
    """Plain version: fp32 softmax(q k^T * scale) v per head, cast back."""
    B, S, threeE = qkv.shape
    E = threeE // 3
    D = E // num_heads
    if scale is None:
        scale = D**-0.5
    x = qkv.reshape(B, S, 3, num_heads, D).float()
    q = x[:, :, 0].transpose(1, 2)  # (B, H, S, D)
    k = x[:, :, 1].transpose(1, 2)
    v = x[:, :, 2].transpose(1, 2)
    probs = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    out = probs @ v
    return out.transpose(1, 2).reshape(B, S, E).to(qkv.dtype)


def _launch(qkv: torch.Tensor, num_heads: int, scale: float) -> torch.Tensor:
    check_cuda(qkv, "qkv", torch.bfloat16)
    B, S, threeE = qkv.shape
    if threeE % (3 * num_heads):
        raise ValueError(f"packed width {threeE} is not 3 * heads * D")
    D = threeE // 3 // num_heads
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {SUPPORTED_HEAD_DIMS}")
    out = torch.empty((B, S, threeE // 3), dtype=qkv.dtype, device=qkv.device)
    KERNEL(ptr(qkv), ptr(out), B, S, num_heads, D, float(scale))
    return out


def attention_from_packed_qkv_nomax(
    qkv: torch.Tensor, num_heads: int, *, scale: Optional[float] = None
) -> torch.Tensor:
    """(B, S, 3E) packed qkv -> (B, S, E)."""
    D = qkv.shape[-1] // 3 // num_heads
    if scale is None:
        scale = D**-0.5
    if qkv.device.type == "cpu":
        return vit_attention_reference(qkv, num_heads, scale=scale)
    return _launch(qkv, num_heads, scale)


# one kernel serves the three JAX entry points (same function, same layout)
attention_from_packed_qkv = attention_from_packed_qkv_nomax
flash_attention_packed_qkv = attention_from_packed_qkv_nomax
