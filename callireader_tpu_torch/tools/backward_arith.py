"""What the training backward's tensor-core loops trade, at the path's shapes.

The dq and dk/dv kernels of ``csrc/flash_attention_bwd.cu`` make two
choices that this script measures against their alternatives, on one set
of seeded inputs (bf16 N(0, 1), D = 128, G = 4, causal) at the e-IT shape
(B = 2, S = 2048, rows of 1470 and 1477 tokens and a -1 padded tail) and
at the recipe's ceiling (B = 1, S = 8192):

- ``no flush``: dk/dv built with ``DKV_FLUSH`` so large that dK and dV never
  leave the wgmma accumulators. The excess of dV beyond its bf16 rounding
  (``kernels/tolerance.py``) is printed for the first key tile, whose sums
  are the longest, and over all keys;
- ``dq two blocks an SM``: dq built with ``DQ_MINB = 2`` (a 168-register
  cap, which spills), against one block an SM.

Each build is checked against the fp32 plain backward and timed with CUDA
events (turns A B B A). Run on a machine with an NVIDIA H100 and the CUDA
toolkit::

    python -m callireader_tpu_torch.tools.backward_arith

The builds go under ``callireader_tpu_torch/_build/backward_arith/``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from typing import Dict

import torch

from callireader_tpu_torch.kernels import _build, tolerance
from callireader_tpu_torch.kernels import attention_bwd as tbwd

SOURCE = "flash_attention_bwd"
EDITS = {  # build: (file, line of it, its replacement)
    "as built": None,
    "no flush": (f"{SOURCE}.cu", "constexpr int DKV_FLUSH = 8;", "constexpr int DKV_FLUSH = 1 << 30;"),
    "dq two blocks an SM": (f"{SOURCE}.cu", "DQ_MINB = 1;", "DQ_MINB = 2;"),
}


def _builds() -> Dict[str, Dict[str, object]]:
    """{build: {"lib": the loaded library, "ptxas": the backward kernels'
    register and spill lines}}."""
    builds = _build.build_variants(_build.BUILD_DIR / "backward_arith", EDITS, [SOURCE])
    out = {}
    for tag, libs in builds.items():
        so, log = libs[SOURCE]
        lines = log.splitlines()
        ptxas = [f"{name}: {lines[i + 1].strip()}; {lines[i + 2].strip()}"
                 for i, line in enumerate(lines) if "Compiling entry" in line
                 for name in ("dq_kernel", "dkdv_kernel") if name in line]
        out[tag] = {"lib": ctypes.CDLL(so), "ptxas": ptxas}
    return out


def _case(dev, gen, B, S, real):
    Hq, Hkv, D = 32, 8, 128

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev).bfloat16()

    q, do, k, v = rnd((B, Hq, S, D)), rnd((B, Hq, S, D)), rnd((B, Hkv, S, D)), rnd((B, Hkv, S, D))
    seg = torch.zeros((B, S), dtype=torch.int32, device=dev)
    for b, n in enumerate(real):
        seg[b, n:] = -1
    scale = D ** -0.5
    o, lse = tbwd._launch_fwd(q, k, v, seg, seg, True, scale)
    dsum = (do.float() * o.float()).sum(-1)
    G = Hq // Hkv
    want = [torch.empty(t.shape, device=dev) for t in (q, k, v)]
    for b in range(B):  # the plain backward one (batch row, KV head) at a time
        for j in range(Hkv):
            sb, sq, sk = slice(b, b + 1), slice(j * G, (j + 1) * G), slice(j, j + 1)
            got = tbwd.attention_bwd_reference(q[sb, sq], k[sb, sk], v[sb, sk], seg[sb], seg[sb],
                                               o[sb, sq], lse[sb, sq], do[sb, sq], True, scale)
            want[0][sb, sq], want[1][sb, sk], want[2][sb, sk] = got
    args = (q, k, v, do, lse, dsum, seg, seg, True, scale)
    return args, want


def _ms(fn, iters: int = 10) -> float:
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(seed: int = 0):
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: not read")
    builds = _builds()
    for tag, b in builds.items():
        print(f"{tag}: " + " | ".join(b["ptxas"]))
    gen = torch.Generator(device=dev).manual_seed(seed)
    result = {}
    shapes = {"train B=2 S=2048": (2, 2048, (1470, 1477)), "ceiling B=1 S=8192": (1, 8192, (8192,))}
    for label, (B, S, real) in shapes.items():
        args, want = _case(dev, gen, B, S, real)
        fns = {tag: (tbwd.KERNEL_DQ.entry_in(b["lib"]), tbwd.KERNEL_DKV.entry_in(b["lib"]))
               for tag, b in builds.items()}
        times = {tag: [] for tag in fns}
        rows = {}
        try:
            for tag, (dq_fn, dkv_fn) in fns.items():
                tbwd.KERNEL_DQ._fn, tbwd.KERNEL_DKV._fn = dq_fn, dkv_fn
                got = (tbwd._launch_dq(*args), *tbwd._launch_dkv(*args))
                torch.cuda.synchronize()
                dv_excess = (got[2].float() - want[2]).abs() - tolerance.BF16_ROUNDING * want[2].abs()
                rows[tag] = {f"excess {n}": tolerance.excess_error(g, w)
                             for n, g, w in zip(("dq", "dk", "dv"), got, want)}
                rows[tag]["excess dv, first key tile"] = max(dv_excess[:, :, :64].max().item(), 0.0)
            for tag in [*fns, *reversed(list(fns))]:
                tbwd.KERNEL_DQ._fn, tbwd.KERNEL_DKV._fn = fns[tag]
                times[tag].append((_ms(lambda: tbwd._launch_dq(*args)),
                                   _ms(lambda: tbwd._launch_dkv(*args))))
        finally:
            tbwd.KERNEL_DQ._fn = tbwd.KERNEL_DKV._fn = None
        for tag, row in rows.items():
            row["ms dq"] = min(t[0] for t in times[tag])
            row["ms dk/dv"] = min(t[1] for t in times[tag])
            print(f"{label}, {tag}: " + ", ".join(f"{k} {v:.4g}" for k, v in row.items()))
        result[label] = rows
        del args, want
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
