"""Where the forward attention loop's error comes from, at the main path's shapes.

The tensor-core loop of ``csrc/flash_common.cuh`` (the ViT and prefill
kernels) stands further from the fp32 plain version than a plain-torch
emulation of the same arithmetic. Two of its steps differ from the
emulation: the exponential (``ex2.approx.ftz`` in the kernel, an exact
``exp2`` in the emulation) and the products' fp32 accumulation inside the
tensor cores. This script builds the two kernels twice, as they stand and
with ``exp2f`` in place of ``ex2.approx``, and on the same seeded inputs
prints for each build and for the emulation the error beyond the output's
bf16 rounding (``kernels/tolerance.py``) and the device time (CUDA events).
If the ``exp2f`` build comes down to the emulation, the exponential is the
cause; if it stays with the kernel as built, the accumulation is.

Run on a machine with an NVIDIA H100 and the CUDA toolkit::

    python -m callireader_tpu_torch.tools.attention_arith

The builds go under ``callireader_tpu_torch/_build/arith/``. ``tensor_core_loop``
is also the CPU record of why the loop splits P
(tests/test_torch_kernels.py::test_tensor_core_loop_needs_split_p).
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from typing import Dict, Optional

import numpy as np
import torch

from callireader_tpu_torch.kernels import _build, tolerance
from callireader_tpu_torch.kernels import attention as tattn
from callireader_tpu_torch.kernels import vit_attention as tvit

LOG2E = 1.4426950408889634
FAST_EXP2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
EXACT_EXP2 = "y = exp2f(x);"
SOURCES = ("vit_attention", "flash_attention")


def tensor_core_loop(q, k, v, scale, mask, split):
    """Plain-torch emulation of the forward loop of csrc/flash_common.cuh:
    64-key tiles, fp32 scores scaled by scale * log2(e), online softmax in
    the log2 domain, O += bf16(P) V (+ bf16(P - bf16(P)) V when ``split``)
    in fp32, the row sum from the fp32 P, the output rounded to bf16.
    q (B, H, Sq, D), k/v (B, H, Sk, D) fp32 holding bf16 values; mask
    (B, 1, Sq, Sk) bool or None."""
    B, H, Sq, D = q.shape
    m = torch.full((B, H, Sq), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    o = torch.zeros((B, H, Sq, D), device=q.device)
    for k0 in range(0, k.shape[2], 64):
        s = (q @ k[:, :, k0:k0 + 64].transpose(-1, -2)) * (scale * LOG2E)
        if mask is not None:
            s = s.masked_fill(~mask[..., k0:k0 + 64], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s - mu[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        vt = v[:, :, k0:k0 + 64]
        o = o * alpha[..., None] + hi @ vt
        if split:
            o = o + (p - hi).bfloat16().float() @ vt
        m = m_new
    return torch.where(l[..., None] > 0, o / l[..., None], torch.zeros_like(o)).bfloat16()


def _build_variants() -> Dict[str, Dict[str, str]]:
    """{"ex2.approx" | "exp2f": {source: .so path}}, all four nvcc at once."""
    builds = _build.build_variants(
        _build.BUILD_DIR / "arith",
        {"ex2.approx": None, "exp2f": ("wgmma_common.cuh", FAST_EXP2, EXACT_EXP2)}, SOURCES)
    return {tag: {name: so for name, (so, _) in libs.items()} for tag, libs in builds.items()}


def _cases(dev, rng):
    """(name, kernel wrapper's entry, run(), fp32 plain output, emulation)."""

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev).bfloat16()

    for label, (B, S, H, D) in (("vit D=64 B=52 S=1025 H=16", (52, 1025, 16, 64)),
                                ("char D=32 B=192 S=257 H=8", (192, 257, 8, 32))):
        qkv = bf16((B, S, 3 * H * D))
        want = tvit.vit_attention_reference(qkv.float(), H)
        x = qkv.float().reshape(B, S, 3, H, D).transpose(1, 3)  # (B, H, 3, S, D)
        emul = tensor_core_loop(x[:, :, 0], x[:, :, 1], x[:, :, 2], D**-0.5, None, True)
        emul = emul.transpose(1, 2).reshape(B, S, H * D)
        yield label, tvit.KERNEL, (lambda qkv=qkv, H=H: tvit.attention_from_packed_qkv_nomax(qkv, H)), \
            want, emul
        del x, want, emul
    B, Hq, Hkv, S, D = 4, 32, 8, 3584, 128
    q, k, v = bf16((B, Hq, S, D)), bf16((B, Hkv, S, D)), bf16((B, Hkv, S, D))
    seg = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for b, pad in enumerate((0, 77, 420, 1000)):  # left padding, segment -1
        seg[b, :pad] = -1
    kw = dict(causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    want = tattn.attention_reference(q.float(), k.float(), v.float(), **kw)
    mask = (seg[:, :, None] == seg[:, None, :]) & torch.ones((S, S), dtype=torch.bool, device=dev).tril()
    G = Hq // Hkv
    emul = tensor_core_loop(q.float(), k.float().repeat_interleave(G, 1),
                            v.float().repeat_interleave(G, 1), D**-0.5, mask[:, None], True)
    yield "prefill D=128 B=4 Hq=32 Hkv=8 S=3584 causal, left padding", tattn.KERNEL, \
        (lambda: tattn.flash_attention(q, k, v, **kw)), want, emul


def _device_ms(run, iters: int = 20) -> float:
    run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(seed: int = 0) -> Dict[str, Dict[str, Optional[float]]]:
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # the emulation's products exact in fp32
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: not read")
    libs = _build_variants()
    result = {}
    for label, kernel, run, want, emul in _cases(dev, np.random.default_rng(seed)):
        fns = {tag: kernel.entry_in(ctypes.CDLL(libs[tag][kernel.source])) for tag in libs}
        outs, times = {}, {tag: [] for tag in fns}
        try:
            for tag, fn in fns.items():
                kernel._fn = fn
                outs[tag] = run()
            for tag in [*fns, *reversed(list(fns))]:  # A B B A
                kernel._fn = fns[tag]
                times[tag].append(_device_ms(run))
        finally:
            kernel._fn = None
        row = {f"excess {tag}": tolerance.excess_error(outs[tag], want) for tag in fns}
        row["excess emulation"] = tolerance.excess_error(emul, want)
        row.update({f"ms {tag}": min(times[tag]) for tag in fns})
        row["differing elements ex2.approx vs exp2f"] = int((outs["ex2.approx"] != outs["exp2f"]).sum())
        row["elements"] = want.numel()
        print(label + ": " + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                                       for k, v in row.items()))
        result[label] = row
        del outs, want, emul
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
