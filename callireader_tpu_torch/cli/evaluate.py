"""CalliBench evaluation CLI (PyTorch port of callireader_tpu/cli/evaluate.py),
flag-compatible with it and with the reference ``evaluate.py``.

  python -m callireader_tpu_torch.cli.evaluate --type full_page --data ./CalliBench \
      --save_name exp --checkpoint InternVL/

Reads the CalliBench parquet layout under ``--data`` (needs pandas and PIL)
and writes the JAX package's result files under ``outputs/<save_name>/``:
``full_page_<split>.json``, ``region_wise.json``, ``<split>.json`` (choice),
``bilingual.json``, ``intent.json``, ``mmbench.xlsx`` (JSON, under that
name) and ``refcoco.json``.

This is the parity harness, so its engine defaults are the reference's
preprocessing: full-RGB char crops resized on the host and pages tiled on
the host. ``--gray-chars``, ``--device-resize-chars`` and
``--device-tile-pages`` opt into the routes serve and the bench take by
default. ``--batch_size`` defaults to 8 (the pipelined batch route) on the
GPU and to 1 (``chat_ocr`` a page) with ``--device cpu``. Without
``--checkpoint`` (default ``$CALLIREADER_CKPT``), ``--random-init`` draws
seeded random weights. ``--mesh data=8`` splits the batch rows over a mesh
(one process per rank under ``torchrun``, a world of 1 without it); rank 0
alone prints and writes the result files. ``--verbose`` prints the engine's
spans (host s, of them blocked s, device s, calls) and counters (each
kernel's launches and the decode steps among them) at the end;
``--spans-out PATH`` writes the span log as Chrome-trace JSON, on the clock
of torch.profiler's events, to load beside a profiler export.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() not in ("false", "0", "no", "")


def main(argv=None):
    parser = argparse.ArgumentParser(description="args for evaluation task")
    parser.add_argument("--type", type=str,
                        choices=["full_page", "region_wise", "choice", "bilingual", "intent",
                                 "mmbench", "refcoco"])
    parser.add_argument("--save_name", type=str, default="exp")
    parser.add_argument("--data", type=str, default="./CalliBench")
    parser.add_argument("--use_p", type=_str2bool, default=True)
    parser.add_argument("--hard_vq", type=_str2bool, default=False)
    parser.add_argument("--drop_zero", type=_str2bool, default=False)
    parser.add_argument("--verbose", type=_str2bool, default=False)
    parser.add_argument("--repetition_penalty", type=float, default=1.0)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="pages a batch for full_page / region_wise and the two-turn tasks "
                        "(default: 8 on the GPU, 1 with --device cpu: chat_ocr a page)")
    parser.add_argument("--choice_limit", type=int, default=3,
                        help="the reference harness evaluates a 3-sample slice; 0 = whole split")
    parser.add_argument("--preset", type=str, default="callireader-8b")
    parser.add_argument("--checkpoint", type=str, default=os.environ.get("CALLIREADER_CKPT"))
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--quant", type=str, default=None, choices=[None, "int8", "int8-all"])
    parser.add_argument("--adapter", type=str, default=None,
                        help="e-IT checkpoint directory of cli.train, merged before evaluating")
    parser.add_argument("--splits", type=str, nargs="*", default=None,
                        help="splits of full_page (easy/medium/hard) or choice "
                        "(author/style/layout); default: all")
    parser.add_argument("--data-path", type=str, default=None,
                        help="mmbench TSV / refcoco JSON path (overrides --data)")
    parser.add_argument("--mesh", type=str, default=None,
                        help='SPMD eval mesh, e.g. "data=8" (rank-sharded batch rows; one '
                        'process per rank under torchrun)')
    chars = parser.add_mutually_exclusive_group()
    chars.add_argument("--rgb-chars", action="store_true",
                       help="(default) full-RGB char canvases, the reference's crops")
    chars.add_argument("--gray-chars", action="store_true",
                       help="luma char canvases (3x fewer bytes; not bit-identical to RGB)")
    parser.add_argument("--device-resize-chars", action="store_true",
                        help="resize raw char crops on the device (near- but not "
                        "bit-identical to the host resize)")
    parser.add_argument("--device-tile-pages", action="store_true",
                        help="tile pages on the device (the default host tiling is "
                        "bit-identical to the reference's)")
    parser.add_argument("--char-canvas", type=int, default=None,
                        help="char-ViT canvas of the shared tower (default: the model's 448)")
    parser.add_argument("--no-trained-assets", action="store_true",
                        help="skip the in-repo trained detector/orderformer/CalliAlign overlays")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--spans-out", type=str, default=None,
                        help="write the engine's span log (the last spans) to this path as "
                        "Chrome-trace JSON")
    args = parser.parse_args(argv)

    from callireader_tpu_torch.cli import common
    from callireader_tpu_torch.evalx import callibench
    from callireader_tpu_torch.utils import profiling

    engine = common.build_engine(
        preset=args.preset, checkpoint_dir=args.checkpoint, random_init_ok=args.random_init,
        quant=args.quant, adapter_path=args.adapter, gray_chars=args.gray_chars,
        device_resize_chars=args.device_resize_chars, device_tile_pages=args.device_tile_pages,
        char_canvas=args.char_canvas, mesh_spec=args.mesh,
        trained_assets=not args.no_trained_assets, device=args.device,
    )
    save_dir = os.path.join("outputs", args.save_name)
    os.makedirs(save_dir, exist_ok=True)
    if args.batch_size is None:
        args.batch_size = 1 if args.device == "cpu" else 8
    kw = dict(use_p=args.use_p, hard_vq=args.hard_vq, drop_zero=args.drop_zero,
              repetition_penalty=args.repetition_penalty, batch_size=args.batch_size)

    if args.type == "full_page":
        for split in args.splits or ("easy", "medium", "hard"):
            callibench.test_full_page(
                engine, os.path.join(args.data, f"full_page_ocr/{split}/{split}.parquet"),
                os.path.join(save_dir, f"full_page_{split}.json"), **kw)
    elif args.type == "region_wise":
        callibench.test_region_wise(
            engine, os.path.join(args.data, "region-wise/region.parquet"),
            os.path.join(save_dir, "region_wise.json"), **kw)
    elif args.type == "choice":
        for split in args.splits or ("author", "style", "layout"):
            callibench.test_choice(
                engine, os.path.join(args.data, f"choice/{split}/{split}.parquet"),
                os.path.join(save_dir, f"{split}.json"), limit=args.choice_limit or None, **kw)
    elif args.type == "bilingual":
        callibench.test_bilingual(
            engine, os.path.join(args.data, "reasoning/bilingual/medium/bilingual_medium.parquet"),
            os.path.join(save_dir, "bilingual.json"), **kw)
    elif args.type == "intent":
        callibench.test_intent(
            engine, os.path.join(args.data, "reasoning/intent/intent.parquet"),
            os.path.join(save_dir, "intent.json"), **kw)
    elif args.type == "mmbench":
        from callireader_tpu_torch.evalx import mmbench

        print(mmbench.evaluate_mmbench(engine, args.data_path or args.data,
                                       os.path.join(save_dir, "mmbench.xlsx")))
    elif args.type == "refcoco":
        from callireader_tpu_torch.evalx import refcoco
        from callireader_tpu_torch.vision import preprocess

        with open(args.data_path or args.data, encoding="utf-8") as f:
            samples = json.load(f)
        for s in samples:
            s["image"] = preprocess.open_image(s["image"])
        out = refcoco.evaluate_refcoco(engine, samples)
        from callireader_tpu_torch.parallel.spmd import is_main

        if is_main():
            with open(os.path.join(save_dir, "refcoco.json"), "w") as f:
                json.dump({"accuracy": out["accuracy"]}, f)
        print(f"refcoco IoU@0.5 accuracy: {out['accuracy']:.4f}")

    if args.verbose:
        print("[spans] per span (host s, blocked s, device s, calls):\n" + profiling.SPANS.report()
              + "\n[counters]\n" + profiling.counters_report(), file=sys.stderr)
    if args.spans_out:
        profiling.SPANS.chrome_trace(args.spans_out)


if __name__ == "__main__":
    main()
