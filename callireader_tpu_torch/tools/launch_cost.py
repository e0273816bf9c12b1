"""Where the host time of a small kernel launch goes, and what it costs the
decode step's small-shape rows.

A decode step launches a few hundred small kernels from Python (the RMSNorm
forward 2L + 1 times, ``flash_decode`` L times, four (K, N) int8 products a
layer, the LM head); at one to eight rows their device time is a few
microseconds, so the host's path to each launch sets their pace. This
script measures, on one card:

1. ``host``: microseconds a call on the host clock (``time.perf_counter``
   over 10,000 back-to-back calls, then one device sync; the card runs each
   call's kernel in about 2 us, so the host sets the pace) of the RMSNorm
   forward at 1, 4 and 8 rows of E = 4096 bf16: through the model's
   ``internlm2.rms_norm``, the wrapper ``rms_norm``, its launch function, the
   ``CudaKernel`` call alone, and the bare ctypes call; beside the steps the
   old and the new launch path take one by one (a ``torch.cuda.Stream``
   object for the stream's handle against the raw handle, ``empty_like``,
   reshape, the weight cast, a no-op cast, ``data_ptr``, ``check_cuda``);
2. ``profile``: the profiler's CPU side of 1,000 ``internlm2.rms_norm``
   calls at 4 rows: each operation's host microseconds a call;
3. ``rows``: CUDA-event ms a call over back-to-back calls (host overhead
   included, as ``chip_smoke.py`` times them) and device ms a call
   (torch.profiler) of the small-shape rows the launch path moves: the
   RMSNorm forward at decode rows and its prefill and training rows, the
   backward at 2 x 2048; ``flash_decode`` at the 8b batch, the 2b batch,
   the CLI, the beams and the contiguous server, beside its bound and
   ``scaled_dot_product_attention`` (which the port never calls); the (K, N)
   int8 products at M = 1, 4, 8 (weights warm in L2 where they fit: the
   launch path is what the rows compare); the LM head at M = 1, 4, 8; the
   paged decode at the serve shape.

It imports the package it finds first on the path, so one call can measure
two trees: from a checkout's root, ``python -m
callireader_tpu_torch.tools.launch_cost --tag change``; for another tree,
run this file by path with that tree's root first on ``PYTHONPATH``
(``PYTHONPATH=OTHER python callireader_tpu_torch/tools/launch_cost.py --tag
parent``). Prints a line for each figure and, last, one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3 (data sheet)
N_HOST = 10_000


def host_us(fn, n=N_HOST):
    """Host microseconds a call over ``n`` back-to-back calls, one sync at
    the end (best of three runs)."""
    best = float("inf")
    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / n * 1e6)
    return best


def events_ms(fn, iters=200):
    """CUDA-event ms a call over ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, n=20):
    """Device ms a call: the kernels' time in a profiler trace of ``n``
    calls, over ``n``; None where the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events() if e.device_type == DeviceType.CUDA)
    return us / n / 1e3 if us else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="change", help="name of the tree measured, for the output")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_cost: needs a CUDA card", file=sys.stderr)
        return 2

    import callireader_tpu_torch
    import torch.nn.functional as F

    from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY
    from callireader_tpu_torch.kernels import _build
    from callireader_tpu_torch.kernels import decode_attention as k_dec
    from callireader_tpu_torch.kernels import int8_matmul as k_i8
    from callireader_tpu_torch.kernels import paged_decode as k_paged
    from callireader_tpu_torch.kernels import rmsnorm as k_rms
    from callireader_tpu_torch.models import internlm2

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[launch_cost] {args.tag}: package {os.path.dirname(callireader_tpu_torch.__file__)}; "
          f"card {smi}; torch {torch.__version__}", flush=True)
    _build.build_all(["rmsnorm", "flash_decode", "int8_matmul", "paged_decode"])
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).bfloat16()

    out = {"tag": args.tag, "card": smi, "host_us": {}, "profile_us": {}, "rows": []}
    eps, E = 1e-5, 4096

    # ------------------------------------------------------------ 1. host
    kern = k_rms.KERNELS_FWD["model"]
    fn = kern._bind()
    w = rnd((E,), 0.1, 1.0)
    for rows in (1, 4, 8):
        x = rnd((rows, 1, E), 2.0)
        x2 = x.reshape(rows, E)
        y = torch.empty_like(x2)
        args_k = (x2.data_ptr(), w.data_ptr(), y.data_ptr(), None, rows, E, eps, 0)
        stream = torch.cuda.current_stream().cuda_stream
        steps = {
            "internlm2.rms_norm": lambda: internlm2.rms_norm(x, w, eps, DEFAULT_POLICY),
            "rms_norm": lambda: k_rms.rms_norm(x, w, eps, "model"),
            "_launch_fwd": lambda: k_rms._launch_fwd(x2, w, eps, "model", False),
            "CudaKernel call": lambda: kern(*args_k),
            "ctypes call": lambda: fn(*args_k, stream),
            "current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
            "raw stream handle": lambda: torch._C._cuda_getCurrentRawStream(
                torch._C._cuda_getDevice()),
            "empty_like": lambda: torch.empty_like(x2),
            "reshape + contiguous": lambda: x.reshape(-1, E).contiguous(),
            "w.to(dtype).contiguous()": lambda: w.to(x.dtype).contiguous(),
            "y.to(same dtype)": lambda: y.to(torch.bfloat16),
            "data_ptr": lambda: x2.data_ptr(),
            "check_cuda": lambda: _build.check_cuda(x2, "x", torch.bfloat16),
        }
        res = {name: host_us(f) for name, f in steps.items()}
        out["host_us"][rows] = res
        print(f"[launch_cost] host us a call, RMSNorm forward {rows} x {E} bf16: "
              + "; ".join(f"{k} {v:.3f}" for k, v in res.items()), flush=True)

    # ------------------------------------------------------------ 2. profile
    from torch.profiler import ProfilerActivity, profile

    x = rnd((4, 1, E), 2.0)
    for _ in range(10):
        internlm2.rms_norm(x, w, eps, DEFAULT_POLICY)
    torch.cuda.synchronize()
    n_prof = 1000
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(n_prof):
            internlm2.rms_norm(x, w, eps, DEFAULT_POLICY)
        torch.cuda.synchronize()
    ops = sorted(((e.key, e.self_cpu_time_total / n_prof, e.count / n_prof)
                  for e in prof.key_averages()), key=lambda t: -t[1])
    out["profile_us"] = {k: [round(us, 3), c] for k, us, c in ops[:12]}
    print("[launch_cost] profiler CPU side of internlm2.rms_norm at 4 rows, self us a call "
          "(calls a call): " + "; ".join(f"{k} {us:.3f} ({c:g})" for k, us, c in ops[:12]),
          flush=True)

    # ------------------------------------------------------------ 3. rows
    def row(name, shape, run, lib=None, nbytes=None):
        ev, dv = events_ms(run), device_ms(run)
        entry = {"name": name, "shape": shape, "ms": ev, "device_ms": dv}
        if lib is not None:
            entry["library_ms"], entry["library_device_ms"] = events_ms(lib), device_ms(lib)
        if nbytes is not None:
            entry["bound_ms"] = nbytes / PEAK_BYTES_S * 1e3
        out["rows"].append(entry)
        print(f"[launch_cost] {name} [{shape}]: " + ", ".join(
            f"{k} {v:.4f}" for k, v in entry.items() if isinstance(v, float)), flush=True)

    for rows in (1, 4, 8, 4 * 3584, 2 * 2048):
        x = rnd((rows, E), 2.0)
        row("rms_norm_fwd", f"{rows}x{E}", lambda: k_rms._launch_fwd(x, w, eps, "model", False),
            lambda: F.rms_norm(x, (E,), w, eps), nbytes=2 * 2 * x.numel() + 2 * E)
    x, dy = rnd((2 * 2048, E), 2.0), rnd((2 * 2048, E))
    _, r = k_rms._launch_fwd(x, w, eps, "model", True)
    row("rms_norm_bwd", f"{2 * 2048}x{E}, dw off",
        lambda: k_rms._launch_bwd(x, w, r, dy, "model", False),
        nbytes=2 * 3 * x.numel() + 2 * E + 4 * x.shape[0])
    del x, dy, r

    # (label, B, S, L, valid spans per row): the paths' last decode steps
    decode_shapes = (
        ("8b", 4, 3840, 32, [(414, 3840), (420, 3840), (426, 3840), (410, 3840)]),
        ("2b", 4, 3648, 8, [(414, 3648), (420, 3648), (426, 3648), (410, 3648)]),
        ("cli", 1, 4608, 32, [(414, 4096)]),
        ("beams", 4, 3712, 32, [(414, 3700)] * 4),
        ("contiguous", 2, 512, 32, [(0, 104), (0, 132)]),
    )
    Hq, Hkv, D = 32, 8, 128
    for label, B, S, L, spans in decode_shapes:
        q, ck, cv = rnd((B, Hq, 1, D)), rnd((L, B, Hkv, S, D)), rnd((L, B, Hkv, S, D))
        valid = torch.zeros((B, S), dtype=torch.int32, device=dev)
        for b, (lo, hi) in enumerate(spans):
            valid[b, lo:hi] = 1
        n_valid = int(valid.sum())
        mask = (valid > 0)[:, None, None, :]
        row("flash_decode", f"{label} B={B} S={S} L={L} layer={L - 1}, {n_valid} valid keys",
            lambda: k_dec.flash_decode(q, ck, cv, L - 1, valid),
            lambda: F.scaled_dot_product_attention(q, ck[L - 1], cv[L - 1], attn_mask=mask,
                                                   enable_gqa=True),
            nbytes=2 * (2 * n_valid * Hkv * D + 2 * q.numel()) + 4 * valid.numel())
        del q, ck, cv
    torch.cuda.empty_cache()

    gi = torch.Generator(device=dev).manual_seed(1)
    for proj, K, N in (("wqkv", 4096, 6144), ("wo", 4096, 4096), ("w13", 4096, 28672),
                       ("w2", 14336, 4096)):
        wq = torch.randint(-127, 128, (K, N), generator=gi, device=dev, dtype=torch.int8)
        sc = torch.rand((N,), generator=gi, device=dev) * 1e-3 + 1e-4
        for M in (1, 4, 8):
            h = rnd((M, K))
            row("int8_matmul", f"{proj} M={M} K={K} N={N}", lambda: k_i8.int8_matmul(h, wq, sc),
                nbytes=K * N + 4 * N + 2 * M * K + 2 * M * N)
        del wq, sc
    wq = torch.randint(-127, 128, (92672, 4096), generator=gi, device=dev, dtype=torch.int8)
    sc = torch.rand((92672,), generator=gi, device=dev) * 1e-3 + 1e-4
    for M in (1, 4, 8):
        h = rnd((M, 4096))
        row("int8_matmul_nt", f"lm_head M={M}", lambda: k_i8.int8_matmul_nt(h, wq, sc),
            nbytes=92672 * 4096 + 4 * 92672 + 2 * M * 4096 + 2 * M * 92672)
    del wq, sc
    torch.cuda.empty_cache()

    # the paged serve shape: 8 slots x 32 pages of 128 keys, slot s holding
    # 3,158 + 256 keys behind 414 + s keys of left padding
    B, P, page, NP = 8, 32, 128, 257
    q = rnd((B, Hq, 1, D))
    kpool, vpool = rnd((2, NP, Hkv, page, D)), rnd((2, NP, Hkv, page, D))
    table = (torch.randperm(NP - 1, generator=torch.Generator().manual_seed(2))[:B * P] + 1)
    table = table.reshape(B, P).int().to(dev)
    valid = torch.zeros((B, P * page), dtype=torch.int32, device=dev)
    for b in range(B):
        valid[b, 414 + b:3584 + 256] = 1
    valid = valid.reshape(B, P, page)
    n_valid = int(valid.sum())
    row("paged_flash_decode", f"serve B={B} P={P} page={page}, {n_valid} valid keys",
        lambda: k_paged.paged_flash_decode(q, kpool, vpool, 1, table, valid),
        nbytes=2 * (2 * n_valid * Hkv * D + 2 * q.numel()) + 4 * (valid.numel() + table.numel()))

    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
