"""ViT encode throughput evidence: tiles/sec through the vision tower (port of
scripts/bench_vit.py).

  python -m callireader_tpu_torch.scripts.bench_vit --preset callireader-2b --tiles 64 --iters 5
  python -m callireader_tpu_torch.scripts.bench_vit --attn-impl both   # kernel against plain

Times the ViT + projector encode (models/internvit.forward, then
projector.extract_feature) on a resident uint8 tile batch (device compute
alone) and with fresh host tiles each iteration (the upload included), and
prints ONE JSON line per implementation. ``--attn-impl``: the JAX choices.
``single_pass``, ``packed`` and ``nomax`` (and the default, ``auto``) all
name the one kernel, csrc/vit_attention.cu, which serves the three JAX
functions; ``reference`` is its plain version; ``both`` runs the kernel and
the plain version in one process on the same batch and fails unless the
kernel's encode lies within ``ENCODE_REL_TOL`` relative L2 of the plain
one's. Each line's ``attn_impl`` says which ran (``<choice>=kernel``, or
``<choice>=plain`` for ``reference`` and on the CPU). Seeded random weights
(the engine's seed-0 draws), tiles from numpy ``RandomState(0)``. Runs on
the card unless ``--device cpu`` (where both names run the plain version).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

KERNEL_CHOICES = ("single_pass", "packed", "nomax")
ENCODE_REL_TOL = 5e-2  # the model bound: a tower through the kernel against plain


def main(argv=None, *, checks=None):
    """``checks``: a dict that receives a ``both`` run's ``encode_rel_err``."""
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="callireader-2b")
    p.add_argument("--tiles", type=int, default=64)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument(
        "--attn-impl",
        default=None,
        choices=[*KERNEL_CHOICES, "reference", "both"],
        help="the ViT attention (default: the kernel; single_pass / packed / nomax name "
        "the same kernel); 'both' runs the kernel against the plain version in one process",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from callireader_tpu_torch.core.config import get_config
    from callireader_tpu_torch.core.dtypes import require_device
    from callireader_tpu_torch.models import internvit, projector
    from callireader_tpu_torch.runtime import weights
    from callireader_tpu_torch.scripts import bench_common as bc

    dev = require_device(args.device)
    cfg = get_config(args.preset)
    params = {
        "vision": weights.draw_vision(cfg.vision, 0, device=dev),
        "projector": weights.draw_projector(cfg, 0, device=dev),
    }

    @torch.inference_mode()
    def encode(pixels, impl):
        h = internvit.forward(params["vision"], cfg.vision, pixels,
                              attn_impl="reference" if impl == "reference" else None)
        return projector.extract_feature(params["projector"], h, cfg)

    rng = np.random.RandomState(0)
    S = cfg.force_image_size
    # uint8 tiles like the engine's: the ViT normalizes on the device
    tiles = rng.randint(0, 255, (args.tiles, S, S, 3)).astype(np.uint8)
    dev_tiles = torch.from_numpy(tiles).to(dev)

    impls = ["auto", "reference"] if args.attn_impl == "both" else [args.attn_impl or "auto"]
    ref_out, lines = None, []
    for impl in impls:
        out = encode(dev_tiles, impl)
        bc.sync(dev)
        if args.attn_impl == "both":
            if ref_out is None:
                ref_out = out.float()
            else:  # the plain encode, against the kernel's
                rel = float((ref_out - out.float()).norm() / out.float().norm())
                if checks is not None:
                    checks["encode_rel_err"] = rel
                print(f"[bench_vit] the kernel's encode against the plain one's: rel L2 "
                      f"{rel:.3e} (bound {ENCODE_REL_TOL})", file=sys.stderr)
                if not rel <= ENCODE_REL_TOL:
                    raise RuntimeError(f"the kernel's encode is {rel:.3e} rel off the plain "
                                       f"one's (bound {ENCODE_REL_TOL})")
                ref_out = None
        del out
        print(f"[bench_vit] warmup done ({impl})", file=sys.stderr)

        t0 = time.perf_counter()
        for _ in range(args.iters):
            encode(dev_tiles, impl)
        bc.sync(dev)
        dev_dt = (time.perf_counter() - t0) / args.iters

        t0 = time.perf_counter()
        for _ in range(args.iters):
            encode(torch.from_numpy(tiles).to(dev), impl)
        bc.sync(dev)
        h2d_dt = (time.perf_counter() - t0) / args.iters

        line = {
            "metric": "vit_tiles_per_sec",
            "value": args.tiles / dev_dt,
            "unit": "tiles/s",
            "with_h2d_tiles_per_sec": args.tiles / h2d_dt,
            "tiles": args.tiles,
            "ms_per_batch_device": dev_dt * 1e3,
            "ms_per_batch_with_h2d": h2d_dt * 1e3,
            "attn_impl": f"{impl}=" + ("kernel" if dev.type == "cuda" and impl != "reference"
                                       else "plain"),
            "device": bc.device_line(dev),
            "platform": dev.type,
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
