"""Where the forward attention loop's error comes from, at the main path's shapes.

The tensor-core loop of ``csrc/flash_common.cuh`` (the ViT, prefill and
e-IT training forward kernels) stands further from the fp32 plain version
than a plain-torch emulation of the same arithmetic. Two of its steps differ
from the emulation: the exponential (``ex2.approx.ftz`` in the kernel, an
exact ``exp2`` in the emulation) and the products' fp32 accumulation inside
the tensor cores. This script builds the three kernels twice, as they stand
and with ``exp2f`` in place of ``ex2.approx``, and on the same seeded inputs
prints for each build and for the emulation the error beyond the output's
bf16 rounding (``kernels/tolerance.py``) and the device time (CUDA events);
for the training forward (B=2 S=2048 with the e-IT rows' right padding, and
the recipe's ceiling B=1 S=8192, whose O sums are the longest) also the lse
error. If the ``exp2f`` build comes down to the emulation, the exponential
is the cause; if it stays with the kernel as built, the accumulation is.

Run on a machine with an NVIDIA H100 and the CUDA toolkit::

    python -m callireader_tpu_torch.tools.attention_arith

The builds go under ``callireader_tpu_torch/_build/arith/``. ``tensor_core_loop``
is also the CPU record of why the loop splits P
(tests/test_torch_kernels.py::test_tensor_core_loop_needs_split_p) and that
the training forward's tile skip is exact
(tests/test_torch_attention_bwd.py::test_training_forward_loop_skip_is_exact).
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
from callireader_tpu_torch.kernels import attention_bwd as tbwd
from callireader_tpu_torch.kernels import vit_attention as tvit

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
FAST_EXP2 = 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));'
EXACT_EXP2 = "y = exp2f(x);"
SOURCES = ("vit_attention", "flash_attention", "flash_attention_bwd")


def disjoint_ids(qmin, qmax, kmin, kmax):
    """The kernels' skip rule on id ranges (tensors of equal shape): a key
    tile whose id range is disjoint from the query tile's holds no attended
    pair."""
    return (kmax < qmin) | (kmin > qmax)


def _tile_ranges(ids, n):
    """(min, max) of the ids of each run of ``n`` positions: (B, ceil(S / n)) each."""
    B, S = ids.shape
    x = torch.nn.functional.pad(ids, (0, -S % n), value=0).reshape(B, -1, n)
    last = x.shape[1] - 1
    if S % n:  # positions past S take the tile's first id, as in the kernels
        x[:, last, S % n:] = x[:, last, :1]
    return x.amin(-1), x.amax(-1)


def tensor_core_loop(q, k, v, scale, mask, split, ids=None, q_tile=16, skip=disjoint_ids,
                     with_lse=False):
    """Plain-torch emulation of the forward loop of csrc/flash_common.cuh:
    64-key tiles, fp32 scores scaled by scale * log2(e), online softmax in
    the log2 domain, O += bf16(P) V (+ bf16(P - bf16(P)) V when ``split``)
    in fp32, the row sum from the fp32 P, the output rounded to bf16.
    q (B, H, Sq, D), k/v (B, H, Sk, D) fp32 holding bf16 values; mask
    (B, 1, Sq, Sk) bool or None. With ``ids`` = (q ids (B, Sq), k ids
    (B, Sk)), a block of ``q_tile`` query positions runs no key tile for
    which ``skip(query ids' min, max, the tile's key ids' min, max)`` holds,
    as the producer pushes none. ``with_lse``: -> (o, lse (B, H, Sq) fp32, the
    natural-log log-sum-exp, -1e30 where a row attends to nothing)."""
    B, H, Sq, D = q.shape
    m = torch.full((B, H, Sq), float("-inf"), device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    o = torch.zeros((B, H, Sq, D), device=q.device)
    if ids is not None:
        qr, kr = _tile_ranges(ids[0], q_tile), _tile_ranges(ids[1], 64)
    for k0 in range(0, k.shape[2], 64):
        s = (q @ k[:, :, k0:k0 + 64].transpose(-1, -2)) * (scale * LOG2E)
        if mask is not None:
            s = s.masked_fill(~mask[..., k0:k0 + 64], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        mu = torch.where(m_new == float("-inf"), torch.zeros_like(m_new), m_new)
        alpha = torch.exp2(m - mu)
        p = torch.exp2(s - mu[..., None])
        l_new = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        vt = v[:, :, k0:k0 + 64]
        o_new = o * alpha[..., None] + hi @ vt
        if split:
            o_new = o_new + (p - hi).bfloat16().float() @ vt
        if ids is None:
            m, l, o = m_new, l_new, o_new
            continue
        kmin, kmax = kr[0][:, k0 // 64, None], kr[1][:, k0 // 64, None]
        run = ~skip(qr[0], qr[1], kmin, kmax)  # (B, query tiles)
        run = run.repeat_interleave(q_tile, 1)[:, None, :Sq]
        m, l = torch.where(run, m_new, m), torch.where(run, l_new, l)
        o = torch.where(run[..., None], o_new, o)
    out = torch.where(l[..., None] > 0, o / l[..., None], torch.zeros_like(o)).bfloat16()
    if not with_lse:
        return out
    lse = torch.where(l > 0, m * LN2 + torch.log(l), torch.full_like(l, -1e30))  # m in log2 units
    return out, lse


def _build_variants() -> Dict[str, Dict[str, str]]:
    """{"ex2.approx" | "exp2f": {source: .so path}}, all six nvcc at once."""
    builds = _build.build_variants(
        _build.BUILD_DIR / "arith",
        {"ex2.approx": None, "exp2f": ("wgmma_common.cuh", FAST_EXP2, EXACT_EXP2)}, SOURCES)
    return {tag: {name: so for name, (so, _) in libs.items()} for tag, libs in builds.items()}


def _cases(dev, rng):
    """(name, kernel wrapper's entry, run(), fp32 plain output, emulation);
    for the training forward run() gives (o, lse), and the plain output and
    the emulation are (o, lse) pairs too."""

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
    del q, k, v, want, emul, mask
    for label, (B, S, real) in (("train fwd B=2 S=2048, rows of 1470 and 1477 tokens",
                                 (2, 2048, (1470, 1477))),
                                ("train fwd ceiling B=1 S=8192, one segment", (1, 8192, (8192,)))):
        q, k, v = bf16((B, Hq, S, D)), bf16((B, Hkv, S, D)), bf16((B, Hkv, S, D))
        seg = torch.zeros((B, S), dtype=torch.int32, device=dev)
        for b, n in enumerate(real):  # right padding, segment -1 (the collator's)
            seg[b, n:] = -1
        tril = torch.ones((S, S), dtype=torch.bool, device=dev).tril()
        want = (torch.empty(q.shape, device=dev), torch.empty(q.shape[:3], device=dev))
        emul = (torch.empty(q.shape, device=dev, dtype=torch.bfloat16),
                torch.empty(q.shape[:3], device=dev))
        for b in range(B):  # one (batch row, KV head) at a time: the fp32 scores fit
            sb = slice(b, b + 1)
            mask = ((seg[sb, :, None] == seg[sb, None, :]) & tril)[:, None]
            for j in range(Hkv):
                sq, sk = slice(j * G, (j + 1) * G), slice(j, j + 1)
                qf, kf, vf = q[sb, sq].float(), k[sb, sk].float(), v[sb, sk].float()
                want[0][sb, sq], want[1][sb, sq] = tbwd.attention_fwd_lse_reference(
                    qf, kf, vf, seg[sb], seg[sb], True, D**-0.5)
                emul[0][sb, sq], emul[1][sb, sq] = tensor_core_loop(
                    qf, kf.expand(1, G, S, D), vf.expand(1, G, S, D), D**-0.5, mask, True,
                    ids=(seg[sb], seg[sb]), with_lse=True)
            del mask
        yield label, tbwd.KERNEL_FWD, \
            (lambda q=q, k=k, v=v, seg=seg: tbwd._launch_fwd(q, k, v, seg, seg, True, D**-0.5)), \
            want, emul
        del q, k, v, want, emul, tril


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
        lse = {}
        if isinstance(want, tuple):  # the training forward: (o, lse)
            lse = {tag: out[1] for tag, out in outs.items()}
            lse["emulation"], lse_want = emul[1], want[1]
            outs, emul, want = {tag: out[0] for tag, out in outs.items()}, emul[0], want[0]
        row = {f"excess {tag}": tolerance.excess_error(outs[tag], want) for tag in fns}
        row["excess emulation"] = tolerance.excess_error(emul, want)
        row.update({f"lse max abs err {tag}": tolerance.max_abs_error(x, lse_want)
                    for tag, x in lse.items()})
        row.update({f"ms {tag}": min(times[tag]) for tag in fns})
        row["differing elements ex2.approx vs exp2f"] = int((outs["ex2.approx"] != outs["exp2f"]).sum())
        row["elements"] = want.numel()
        print(label + ": " + ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                                       for k, v in row.items()))
        result[label] = row
        del outs, want, emul, lse
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
