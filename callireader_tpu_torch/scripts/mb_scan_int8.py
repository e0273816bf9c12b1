"""Microbench: the (K, N) int8 kernel over L stacked layers, three ways (port of
scripts/mb_scan_int8.py).

  MB_WHICH=stacked,unrolled,graph MB_L=16 python -m callireader_tpu_torch.scripts.mb_scan_int8 \
      [--device cpu]

The JAX script asks whether ``lax.scan``'s per-layer slice of a stacked
(L, K, N) int8 weight makes XLA copy each layer's weights every step. The
port asks the same of its own decode: csrc/int8_matmul.cu's ``kn_kernel``
(through ``kernels.int8_matmul.int8_matmul``) at K=4096, N=14336 (the 8b's
w1 / w3), M=8 rows, over L layers, each product's (M, N) row brought back to
K by a bf16 (N, K) product as in the JAX script:

- ``stacked``: the wrapper on layer i's view of one resting (L, K, N)
  tensor, as the decode takes it (models/internlm2._layer);
- ``unrolled``: L separate (K, N) tensors;
- ``graph``: the stacked loop captured once as a CUDA graph and replayed,
  as the decode's chunks are (runtime/decode_graph.StepGraph), in place of
  ``scan``, which has no torch counterpart. Card only.

``MB_WHICH`` picks the variants and ``MB_L`` the layers, as in the JAX
script. Each variant prints its ms a pass and its effective int8-weight
GB/s (L*K*N bytes a pass) beside the share of the H100's 3.35 TB/s; then
ONE JSON line. The run fails unless the variants give the same output bits.
Inputs are drawn on the device (torch generator, seed 0). Runs on the card
unless ``--device cpu``; ``run(...)`` takes other shapes as keywords.
"""

from __future__ import annotations

import argparse
import json
import os
import time

VARIANTS = ("stacked", "unrolled", "graph")


def run(L: int = 16, K: int = 4096, N: int = 14336, M: int = 8, which=VARIANTS,
        device="cuda", n: int = 20):
    """The variants in ``which`` -> the JSON line's dict."""
    import torch

    from callireader_tpu_torch.core.dtypes import require_device
    from callireader_tpu_torch.kernels.int8_matmul import int8_matmul
    from callireader_tpu_torch.runtime.decode_graph import StepGraph
    from callireader_tpu_torch.scripts import bench_common as bc

    dev = require_device(device)
    unknown = [w for w in which if w not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; have {VARIANTS}")
    if "graph" in which and dev.type != "cuda":
        raise ValueError("the graph variant captures a CUDA graph: it runs on the card")
    T0 = time.perf_counter()

    def tick(msg):
        print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)

    g = torch.Generator(device=dev).manual_seed(0)
    wq = torch.randint(-127, 128, (L, K, N), generator=g, dtype=torch.int8, device=dev)
    ws = torch.rand((L, N), generator=g, dtype=torch.float32, device=dev) / 127.0
    h0 = torch.randn((M, K), generator=g, dtype=torch.float32, device=dev).to(torch.bfloat16)
    proj_back = (torch.randn((N, K), generator=g, dtype=torch.float32, device=dev)
                 * 0.01).to(torch.bfloat16)
    separate = [(wq[i].clone(), ws[i].clone()) for i in range(L)] if "unrolled" in which else []
    bc.sync(dev)
    tick("all inputs on the device")
    bytes_per_pass = L * K * N  # int8 weight bytes (the least traffic possible)

    @torch.inference_mode()
    def stacked(h):
        x = h
        for i in range(L):
            x = int8_matmul(x, wq[i], ws[i]) @ proj_back
        return x

    @torch.inference_mode()
    def unrolled(h):
        x = h
        for q, s in separate:
            x = int8_matmul(x, q, s) @ proj_back
        return x

    static_h = h0.clone()
    step_graph = StepGraph(dev)

    def graph(h):
        static_h.copy_(h)
        return step_graph(lambda: stacked(static_h))

    fns = {"stacked": stacked, "unrolled": unrolled, "graph": graph}
    variants, outs = {}, {}
    for name in which:
        f = fns[name]
        tick(f"running {name}")
        outs[name] = f(h0).clone()  # warm (the graph: its first run and capture)
        bc.sync(dev)
        t0 = time.perf_counter()
        for _ in range(n):
            f(h0)
        bc.sync(dev)
        t = (time.perf_counter() - t0) / n
        gbps = bytes_per_pass / t / 1e9
        share = gbps * 1e9 / bc.HBM_BYTES_S
        print(f"{name:9s}: {t * 1e3:7.2f} ms  -> {gbps:6.1f} GB/s effective int8-weight BW "
            f"({share:.1%} of 3.35 TB/s)", flush=True)
        variants[name] = {"ms": t * 1e3, "gbps": gbps, "share_of_3350gbps": share}
    first = outs[which[0]]
    same = all(torch.equal(o, first) for o in outs.values())
    out = {"metric": "int8_stacked_weight_gbps", "L": L, "K": K, "N": N, "M": M,
           "bytes_per_pass": bytes_per_pass, "variants": variants, "same_bits": same,
           "device": bc.device_line(dev), "platform": dev.type}
    if not same:
        raise RuntimeError(f"the variants {list(which)} gave different output bits")
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    which = tuple(w.strip() for w in os.environ.get("MB_WHICH", ",".join(VARIANTS)).split(","))
    out = run(L=int(os.environ.get("MB_L", "16")), which=which, device=args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
