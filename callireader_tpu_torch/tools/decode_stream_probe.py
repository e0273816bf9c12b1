"""What the decode step's streaming kernels trade, at the paths' shapes.

The (K, N) int8 kernel (``kn_kernel`` of ``csrc/int8_matmul.cu``), the
paged decode kernel (``paged_kernel`` of ``csrc/paged_decode.cu``) and the
contiguous decode kernel (``decode_kernel`` of ``csrc/flash_decode.cu``)
make choices that this script measures against their alternatives, each
build compiled from a copy of ``csrc/`` with one line changed:

- ``no stage fence``: a consumer hands a ring stage back to the producer
  without ``fence.proxy.async`` (``mbar_release_stage`` reduced to the
  arrive). Counted: launches, of 20 on the same inputs, whose output is not
  bit-equal to the first one's or stands beyond the card's tolerance of the
  plain version (``kernels/tolerance.py``);
- ``8 splits at K = 14336``: the (K, N) split rule without its longer
  splits past K = 8192;
- ``two blocks an SM``: the (K, N) ring at 110 KB, not 54;
- ``no products``: the (K, N) consumers skip their products, so the kernel
  only streams its weight and h through the ring and runs its epilogue
  (its outputs are not checked): the kernel's own streaming floor;
- ``runs of 2 entries``: the paged kernel with PD_RUN = 2, not 4;
- ``two-stage ring``: the contiguous decode kernel's ring at 2 stages, not
  3, so three blocks share an SM, not two.

The contiguous decode kernel takes its run length as an argument, so each
build of it is also timed at runs of 1, 2, 4 and 8 chunks beside the
wrapper's rule (``run_chunks``).

At callireader-8b's four (K, N) projections (wqkv, wo, w13, w2) with M = 4,
8, 16 and 32 rows of seeded bf16 N(0, 1), int8 weights and scales, and at
the paged serve and HTTP shapes of ``chip_smoke.py`` (8 slots x 32 pages of
128 keys; 27,450 live keys over the 8 slots, or 3,182 in one), and at the
contiguous decode's 8b batch (B=4 S=3840, 13,690 valid keys) and CLI (B=1
S=4608, 3,682 valid keys) shapes, each build's
device microseconds a call (torch.profiler, every kernel of the call,
weights walked over 8 layers so that they come from device memory), its
failure count and its largest excess beyond the output's bf16 rounding
are printed, then one JSON line. Run on a machine with an NVIDIA H100 and the
CUDA toolkit::

    python -m callireader_tpu_torch.tools.decode_stream_probe

The builds go under ``callireader_tpu_torch/_build/decode_stream_probe/``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from callireader_tpu_torch.core.dtypes import exact_fp32
from callireader_tpu_torch.kernels import _build, tolerance
from callireader_tpu_torch.kernels import decode_attention as tdec
from callireader_tpu_torch.kernels import int8_matmul as ti8
from callireader_tpu_torch.kernels import paged_decode as tpaged

SOURCES = ("int8_matmul", "paged_decode", "flash_decode")
EDITS = {  # build: (file, text of one line, its replacement)
    "as built": None,
    "no stage fence": ("wgmma_common.cuh",
                       'asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");', ""),
    "8 splits at K = 14336": ("int8_matmul.cu", "KN_LONG_K = 8192;", "KN_LONG_K = 1 << 30;"),
    "two blocks an SM": ("int8_matmul.cu", "KN_SMEM = 54 * 1024;", "KN_SMEM = 110 * 1024;"),
    "no products": ("int8_matmul.cu", "for (int kk = 0; kk < KN_GROUP; kk += 16) {",
                    "for (int kk = 0; kk < 0; kk += 16) {"),
    "runs of 2 entries": ("paged_decode.cu", "PD_RUN = 4;", "PD_RUN = 2;"),
    "two-stage ring": ("flash_decode.cu", "FD_STAGES = 3;", "FD_STAGES = 2;"),
}
KN_BUILDS = ("as built", "no stage fence", "8 splits at K = 14336", "two blocks an SM",
             "no products")
PAGED_BUILDS = ("as built", "no stage fence", "runs of 2 entries")
DECODE_BUILDS = ("as built", "no stage fence", "two-stage ring")
PROJECTIONS = {"wqkv": (4096, 6144), "wo": (4096, 4096), "w13": (4096, 28672), "w2": (14336, 4096)}
LAUNCHES = 20
LAYERS = 8


def device_us(fn, calls: int = 16) -> float:
    """Device microseconds a call: every CUDA kernel's time in a profiler
    trace of ``calls`` calls, over the calls the trace holds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = per_kernel.get(e.name, (0.0, 0))
            per_kernel[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    if not per_kernel:
        return float("nan")
    held = min(n for _, n in per_kernel.values())  # calls the trace holds
    return sum(us / n * round(n / held) for us, n in per_kernel.values())


def _failures(run, want, tol):
    """-> (launches of ``run``, of LAUNCHES, not bit-equal to the first one
    or beyond ``tol`` of ``want``; the largest excess of any)."""
    outs = [run() for _ in range(LAUNCHES)]
    torch.cuda.synchronize()
    excess = [tolerance.excess_error(o, want) for o in outs]
    failed = sum(not torch.equal(o, outs[0]) or e > tol for o, e in zip(outs, excess))
    return failed, max(excess)


def _kn_rows(fns, dev, gen):
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rows = {}
    for name, (K, N) in PROJECTIONS.items():
        q = torch.randint(-127, 128, (LAYERS, K, N), dtype=torch.int8, device=dev, generator=gen)
        s = torch.rand((LAYERS, N), device=dev, generator=gen) * 1e-3 + 1e-4
        for M in (4, 8, 16, 32):
            h = torch.randn((M, K), device=dev, generator=gen).bfloat16()
            with exact_fp32():
                want = ti8.int8_matmul_reference(h.float(), q[1], s[1])
            row = {"bound us": K * N / 3.35e6}
            for tag in KN_BUILDS:
                fn = fns[tag]["int8_matmul"]
                walk = [0]

                def launch(layer=None, fn=fn):
                    i = walk[0] = (walk[0] + 1) % LAYERS if layer is None else layer
                    out = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
                    rc = fn(h.data_ptr(), q[i].data_ptr(), s[i].data_ptr(), out.data_ptr(), M, K, N,
                            stream())
                    if rc:
                        raise RuntimeError(f"{tag}: cudaError {rc}")
                    return out

                if tag != "no products":
                    row[f"{tag}: failures"], row[f"{tag}: excess"] = _failures(
                        lambda: launch(1), want, tolerance.ATOL["int8_matmul"])
                row[f"{tag}: us"] = device_us(launch)
            rows[f"{name} M={M}"] = row
            print(f"{name} {M}x{K}x{N}: " + ", ".join(f"{k} {v:.4g}" for k, v in row.items()),
                  flush=True)
        del q, s
        torch.cuda.empty_cache()
    return rows


def _paged_rows(fns, dev, gen):
    B, Hq, Hkv, D, page, P, NP = 8, 32, 8, 128, 128, 32, 257
    kpool = torch.randn((4, NP, Hkv, page, D), device=dev, generator=gen).bfloat16()
    vpool = torch.randn((4, NP, Hkv, page, D), device=dev, generator=gen).bfloat16()
    q = torch.randn((B, Hq, 1, D), device=dev, generator=gen).bfloat16()
    table = (torch.randperm(NP - 1, device=dev, generator=gen)[:B * P] + 1).reshape(B, P).int()
    # partials for one run an entry: room for any run length
    part_acc = torch.empty((B, Hq, P, D), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B, Hq, P, 2), dtype=torch.float32, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rows = {}
    for label, lengths in (("serve", (3585, 3300, 3700, 3200, 3600, 3400, 3500, 3165)),
                           ("http", (3182,) + (0,) * 7)):
        flat = torch.arange(P * page, device=dev)[None, :]
        valid = (flat < torch.tensor(lengths, device=dev)[:, None]).int().reshape(B, P, page)
        want = tpaged.paged_flash_decode_reference(q.float(), kpool, vpool, 2, table, valid)
        row = {"bound us": 4 * int(valid.sum()) * Hkv * D / 3.35e6}
        for tag in PAGED_BUILDS:
            fn = fns[tag]["paged_decode"]

            def launch(fn=fn):
                out = torch.empty_like(q)
                rc = fn(q.data_ptr(), kpool.data_ptr(), vpool.data_ptr(), table.data_ptr(),
                        valid.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                        B, Hq, Hkv, P, page, NP, D, 2, D ** -0.5, stream())
                if rc:
                    raise RuntimeError(f"{tag}: cudaError {rc}")
                return out

            row[f"{tag}: failures"], row[f"{tag}: excess"] = _failures(
                launch, want, tolerance.ATOL["paged_flash_decode"])
            row[f"{tag}: us"] = device_us(launch)
        rows[f"paged {label}"] = row
        print(f"paged {label}: " + ", ".join(f"{k} {v:.4g}" for k, v in row.items()), flush=True)
    return rows


def _decode_rows(fns, dev, gen):
    Hq, Hkv, D, L = 32, 8, 128, 4
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    rows = {}
    for label, B, S, spans in (("8b", 4, 3840, ((414, 3840), (420, 3840), (426, 3840), (410, 3840))),
                               ("cli", 1, 4608, ((414, 4096),))):
        q = torch.randn((B, Hq, 1, D), device=dev, generator=gen).bfloat16()
        ck = torch.randn((L, B, Hkv, S, D), device=dev, generator=gen).bfloat16()
        cv = torch.randn((L, B, Hkv, S, D), device=dev, generator=gen).bfloat16()
        valid = torch.zeros((B, S), dtype=torch.int32, device=dev)
        for b, (lo, hi) in enumerate(spans):
            valid[b, lo:hi] = 1
        want = tdec.flash_decode_reference(q.float(), ck, cv, 2, valid)
        rule = tdec.run_chunks(B, Hkv, S)
        row = {"bound us": 4 * int(valid.sum()) * Hkv * D / 3.35e6, "rule's run": rule}
        for tag in DECODE_BUILDS:
            fn = fns[tag]["flash_decode"]

            def launch(R=rule, fn=fn):
                part = torch.empty((B * Hq * -(-tdec.n_chunks(S) // R) * (D + 2),),
                                   dtype=torch.float32, device=dev)
                out = torch.empty_like(q)
                rc = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), valid.data_ptr(),
                        part.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D, 2, R, D ** -0.5,
                        stream())
                if rc:
                    raise RuntimeError(f"{tag}: cudaError {rc}")
                return out

            row[f"{tag}: failures"], row[f"{tag}: excess"] = _failures(
                launch, want, tolerance.ATOL["flash_decode"])
            for R in (1, 2, 4, 8):
                row[f"{tag}: us, runs of {R}"] = device_us(lambda R=R: launch(R))
        rows[f"decode {label}"] = row
        print(f"decode {label}: " + ", ".join(f"{k} {v:.4g}" for k, v in row.items()), flush=True)
        del q, ck, cv
    return rows


def main(seed: int = 0):
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi: not read")
    built = _build.build_variants(_build.BUILD_DIR / "decode_stream_probe", EDITS, SOURCES)
    fns = {tag: {"int8_matmul": ti8.KERNEL.entry_in(ctypes.CDLL(libs["int8_matmul"][0])),
                 "paged_decode": tpaged.KERNEL.entry_in(ctypes.CDLL(libs["paged_decode"][0])),
                 "flash_decode": tdec.KERNEL.entry_in(ctypes.CDLL(libs["flash_decode"][0]))}
           for tag, libs in built.items()}
    gen = torch.Generator(device=dev).manual_seed(seed)
    result = {**_decode_rows(fns, dev, gen), **_kn_rows(fns, dev, gen),
              **_paged_rows(fns, dev, gen)}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
