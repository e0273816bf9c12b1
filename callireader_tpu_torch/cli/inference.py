"""Inference CLI (PyTorch port of callireader_tpu/cli/inference.py, with its
flags, plus ``--device``).

  python -m callireader_tpu_torch.cli.inference --tgt page.npy \
      --prompt '这幅书法作品内容是什么？' --preset callireader-8b \
      --checkpoint InternVL/ --quant int8 --adapter work_dir/final

A target is a page (a uint8 (H, W, 3) ``.npy`` array, or an image file that
PIL decodes where PIL is installed) or a folder of them. One page: prints
``User: ...`` / ``Assistant: ...``. A folder: the same per page, and
``results/<save_name>`` with one record per page, ``"ERROR!"`` for a page
that raised. Runs on the GPU unless ``--device cpu`` is given.
``--checkpoint`` (default ``$CALLIREADER_CKPT``) is a reference-layout InternVL
directory, its side files under ``params/``; without one, ``--random-init``
draws seeded random weights. ``--no-trained-assets`` keeps the committed
detector, OrderFormer and CalliAlign tower off the components drawn at
random. ``--quant int8-all`` adds the W8A8 tile tower to the int8 LLM,
``--char-canvas`` sets the shared tower's char canvas. ``--mesh
tensor=4,fsdp=2`` runs the LLM over a mesh, one process per rank
(``torchrun --nproc-per-node N -m callireader_tpu_torch.cli.inference --mesh
tensor=N ...``; a world of 1 without torchrun); rank 0 alone prints and
writes.
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


def is_image(path: str) -> bool:
    """A page the port can read: a uint8 (H, W, 3) ``.npy`` array, or a file
    that PIL opens (where PIL is installed)."""
    if not os.path.isfile(path):
        return False
    if path.endswith(".npy"):
        import numpy as np

        try:
            arr = np.load(path, mmap_mode="r")
        except (OSError, ValueError):
            return False
        return arr.dtype == "uint8" and arr.ndim == 3 and arr.shape[2] == 3
    try:
        from PIL import Image
    except ImportError:
        return False
    try:
        with Image.open(path):
            return True
    except Exception:  # noqa: BLE001 - PIL raises several types for a non-image
        return False


def get_image_paths(folder: str):
    out = []
    for root, _, files in os.walk(folder):
        for f in files:
            p = os.path.join(root, f)
            if is_image(p):
                out.append(p)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="args for inference task")
    parser.add_argument("--tgt", type=str, help="Recognition target")
    parser.add_argument("--prompt", type=str, default="这幅书法作品内容是什么？")
    parser.add_argument("--save_name", type=str, default="recognition.json")
    parser.add_argument("--use_p", type=_str2bool, default=True)
    parser.add_argument("--hard_vq", type=_str2bool, default=False)
    parser.add_argument("--drop_zero", type=_str2bool, default=False)
    parser.add_argument("--verbose", type=_str2bool, default=False)
    parser.add_argument("--repetition_penalty", type=float, default=1.0)
    parser.add_argument("--num_beams", type=int, default=1,
                        help="HF generate parity (reference always 1)")
    parser.add_argument("--preset", type=str, default="callireader-8b")
    parser.add_argument("--checkpoint", type=str, default=os.environ.get("CALLIREADER_CKPT"),
                        help="InternVL checkpoint directory (reference layout)")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--quant", type=str, default=None, choices=[None, "int8", "int8-all"])
    parser.add_argument("--adapter", type=str, default=None,
                        help="e-IT checkpoint dir of cli.train (LoRA + projector) to merge")
    parser.add_argument("--mesh", type=str, default=None,
                        help='SPMD inference mesh, e.g. "tensor=4,fsdp=2" (one process per rank '
                        'under torchrun; "data" takes the rest of the world)')
    parser.add_argument("--char-canvas", type=int, default=None,
                        help="char-ViT canvas of the shared tower (default: the model's 448); "
                        "a preset with the compact char tower keeps its own")
    parser.add_argument("--no-trained-assets", action="store_true",
                        help="skip the in-repo trained detector/orderformer/CalliAlign overlays")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    if not isinstance(args.tgt, str):
        raise ValueError(f"The target should be a string, not {type(args.tgt)}!")

    from callireader_tpu_torch.cli import common

    try:
        engine = common.build_engine(
            preset=args.preset, checkpoint_dir=args.checkpoint, random_init_ok=args.random_init,
            quant=args.quant, adapter_path=args.adapter, char_canvas=args.char_canvas,
            mesh_spec=args.mesh, trained_assets=not args.no_trained_assets, device=args.device,
        )
    except (FileNotFoundError, ValueError) as e:
        parser.error(str(e))

    def rec(image_path):
        response, _ = engine.chat_ocr(
            image_path, args.prompt,
            use_p=args.use_p, hard_vq=args.hard_vq, drop_zero=args.drop_zero,
            repetition_penalty=args.repetition_penalty, num_beams=args.num_beams,
            return_history=True, verbose=args.verbose,
        )
        return response

    if is_image(args.tgt):
        print("Single image recognition mode.")
        response = rec(args.tgt)
        print(f"User: {args.prompt}\nAssistant: {response}")
    elif os.path.isdir(args.tgt):
        from callireader_tpu_torch.parallel.spmd import is_main

        print("Multiple images recognition mode")
        if is_main():
            os.makedirs("results", exist_ok=True)
        results = []
        for pic in get_image_paths(args.tgt):
            try:
                response = rec(pic)
            except Exception as e:  # noqa: BLE001 - a failed page is recorded, the rest go on
                print(f"An error has occured:\n{e}", file=sys.stderr)
                response = "ERROR!"
            print(f"User: {args.prompt}\nAssistant: {response}")
            results.append({"imagePath": pic, "prompt": args.prompt, "response": response})
        save_name = args.save_name
        if not save_name.endswith("json"):
            save_name += "_result.json"
        if not is_main():
            return
        with open(os.path.join("results", save_name), "w", encoding="utf-8") as f:
            json.dump(results, f, ensure_ascii=False, indent=4)
    else:
        raise ValueError("The target should be either an image path or a folder of images!")


if __name__ == "__main__":
    main()
