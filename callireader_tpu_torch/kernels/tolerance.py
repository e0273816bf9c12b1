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
H100 80GB HBM3 (700 W) at the main path's shapes: at most 6.5e-7 (ViT tile
tower), 1.03e-6 (char tower), 3.0e-6 (prefill), 3.2e-8 (decode, whose
runs of 64-key chunks by bulk copies replaced a CUDA-core kernel that read
1.3e-8). The int8
LM head on the tensor cores (64-deep groups, fixed chunked order) reads
1.5e-8 to 3.7e-7 at the paths' M = 1-8 rows (K = 4096, N = 92,672; the
CUDA-core kernel it replaced, 1.2e-7). The (K, N) int8 kernel on the
tensor cores (the same groups, K split over a cluster) reads at most
2.6e-7 at the paths' M = 2-8 rows (the CUDA-core kernel it replaced,
4.7e-8), and up to 1.1e-6 at M = 16, K = 14336
(``tools/decode_stream_probe.py``); the paged decode, fed by runs of
pages, at most 4.7e-9 (the kernel it replaced, 3.0e-9). ATOL sits 3x
(prefill) to hundreds of times above that, and far
below what a lost 64-key tile, page, 64-query tile or 128-deep K block
costs (tests/test_torch_kernels.py, tests/test_torch_paged.py,
tests/test_torch_int8.py, tests/test_torch_attention_bwd.py).

The ViT, prefill and training forward kernels multiply P V on the tensor
cores, whose operands are bf16. A softmax weight rounded to bf16 once misses
this check by 30-180x; split into bf16(P) + bf16(P - bf16(P)) it passes
(tests/test_torch_kernels.py::test_tensor_core_loop_needs_split_p holds a
CPU emulation of the loop to both). On an H100 80GB HBM3 (700 W), at the
main path's shapes and on the same random inputs, the kernels' excess
(5.1e-7 ViT, 9.7e-7 char tower, 2.4e-6 prefill, 2.5e-6 training forward
at B=2 S=2048) is the emulation's own (5.4e-7, 8.5e-7, 2.4e-6, 2.5e-6), and
the kernels built with exp2f in place of ex2.approx give the same bits
(callireader_tpu_torch/tools/attention_arith.py): the excess is the split
P's arithmetic at that size, not the exponential or the tensor cores'
accumulation. At the training ceiling, B=1 S=8192, whose O sums run over
8,192 keys in the wgmma accumulator, the forward reads 3.2e-6 against the
emulation's 1.3e-6, within ATOL without moving O into fp32 sums; its lse
(fp32, held to 1e-4) stands 2.0e-5 off, the emulation's 1.9e-6 (not
probed further; the exponential is not the cause, the exp2f build reads
the same).

The training backward (dq, dk/dv) runs its products on the tensor cores
too, and there dS = P (dP - dsum) feeds dQ = dS K and dK = dS^T Q as well as
P feeding dV = P^T dO. Rounding P and dS to bf16 once misses this check in
every output, so dS is split as P is, bf16(dS) + bf16(dS - bf16(dS)), each part its own
product into the fp32 accumulator
(tests/test_torch_attention_bwd.py::test_tensor_core_backward_needs_split_p_and_ds
holds a CPU emulation to both: 1.1-1.3e-6 split, 28-46x over ATOL single).
Over the longest sums (dV and dK of the first keys gather G x S query
terms) the wgmma accumulator drifts: at B=1 S=8192 dV kept in the
accumulator stood 2.7e-4 beyond its rounding, over ATOL; moved into fp32
sums in shared memory every 8 query tiles it stands at 4.9e-6
(callireader_tpu_torch/tools/backward_arith.py). With both, chip_smoke.py
reads 2.8e-6 / 2.2e-6 (dq) and 6.7e-6 / 6.2e-6 (dk/dv) at B=2 S=2048 and
B=1 S=8192 on an H100 80GB HBM3 (700 W), against 1e-4 and 2e-4.

The RMSNorm kernels' one-rounding form (rms_norm_pallas's) takes 1e-5 too:
its fp32 row sums differ from the plain version's in order only. Its
two-rounding form (the model's) is held elementwise to one bf16 ulp instead
(chip_smoke.py, tests/test_torch_rmsnorm.py): rounding x * r to bf16 before
the weight product turns an fp32 last-bit difference into a whole bf16 ulp.
"""

from __future__ import annotations

import torch

BF16_ROUNDING = 2.0**-8
ATOL = {"vit_attention": 1e-5, "flash_attention": 1e-5, "flash_decode": 1e-5,
        "mla_prefill": 1e-5, "latent_decode": 1e-5,
        "int8_matmul": 1e-5, "int8_matmul_nt": 1e-5, "paged_flash_decode": 1e-5,
        "attn_train_fwd": 1e-5, "attn_train_dq": 1e-4, "attn_train_dkv": 2e-4,
        "rms_norm": 1e-5}


def excess_error(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest error beyond the output's bf16 rounding: <= ATOL to pass."""
    want = want.float()
    excess = (got.float() - want).abs() - BF16_ROUNDING * want.abs()
    return max(excess.max().item(), 0.0)


def max_abs_error(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()
