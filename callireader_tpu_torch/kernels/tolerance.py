"""How far a CUDA kernel's bf16 output may stand from its plain version.

Every kernel of the port accumulates in fp32 and writes
``round_bf16(result)``. The plain version computes the same function in fp32
on the same bf16 inputs, so the two differ by

- the output's own bf16 rounding, at most ``BF16_ROUNDING * |value|``
  (round to nearest, 8 significant bits), and
- fp32 summation order (online softmax, exp2 instead of exp, split-K merge;
  for the int8 products, whose terms are exact in fp32, the order alone).

The check is elementwise, ``|kernel - plain| <= ATOL[name] + BF16_ROUNDING *
|plain|``, so a large value's rounding (prefill row 0 attends to one key and
outputs v itself, |v| up to ~4) does not set the bar for the typical output,
which is ~0.03-0.05 for random inputs over thousands of keys. ``ATOL`` holds
what is left, the summation-order error. ``chip_smoke.py`` measured it on an
H100 80GB HBM3 (700 W) at the main path's shapes: at most 1.8e-7 (ViT),
2.5e-7 (prefill), 0 (decode), 4.7e-8 (int8, K x N weights) and 1.2e-7
(int8 LM head). ATOL sits 40-200x above that and far below what a lost
64-key tile or 128-deep K block costs (tests/test_torch_kernels.py,
tests/test_torch_int8.py).
"""

from __future__ import annotations

import torch

BF16_ROUNDING = 2.0**-8
ATOL = {"vit_attention": 1e-5, "flash_attention": 1e-5, "flash_decode": 1e-5,
        "int8_matmul": 1e-5, "int8_matmul_nt": 1e-5}


def excess_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest error beyond the output's bf16 rounding: <= ATOL to pass."""
    want = want.float()
    excess = (got.float() - want).abs() - BF16_ROUNDING * want.abs()
    return max(excess.max().item(), 0.0)


def max_abs_error(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()
