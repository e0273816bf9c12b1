"""Dtype policy and float32 precision control.

Counterpart of callireader_tpu/core/dtypes.py with torch dtypes: bf16
operands on the tensor cores; norms, softmax and logits in fp32.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    compute_dtype: torch.dtype = torch.bfloat16
    norm_dtype: torch.dtype = torch.float32
    logits_dtype: torch.dtype = torch.float32


DEFAULT_POLICY = DTypePolicy()
FP32_POLICY = DTypePolicy(torch.float32, torch.float32, torch.float32)


@contextlib.contextmanager
def exact_fp32():
    """Full-precision float32 for the fp32 modules (detector, OrderFormer).

    cuDNN runs float32 convolutions in TF32 by default (about three decimal
    digits); the detector's NMS at IoU 0.3 / conf 0.5 is sensitive to the
    third digit, so TF32 is switched off for convolutions and the matmul
    precision is held at "highest" inside this block."""
    prev_mm = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled, allow_tf32=False
        ):
            yield
    finally:
        torch.set_float32_matmul_precision(prev_mm)


def require_device(device) -> torch.device:
    """Entry points run on the card unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device
