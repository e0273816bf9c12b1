"""Pseudo-embedding extraction, the e-IT data generator (PyTorch port of
callireader_tpu/cli/get_embeddings.py).

  python -m callireader_tpu_torch.cli.get_embeddings --data DIR --out OUT \
      --preset callireader-8b --random-init

For each page ``<name>.npy`` (uint8 (H, W, 3)) or ``<name>.jpg`` (decoded by
PIL where it is installed) beside a labelme ``<name>.json`` whose boxes are
normalized to [0, 1]: crop every character box, scale it under the [200,
350] rule onto a white content canvas (host, PIL-compatible bicubic), run
the char tower, the resampler and the cosine VQ with its denorm, drop the
rows whose VQ index is 0 (``--drop_zero``, on by default) and save
``<name>.npy`` (or ``torch.save`` of a tensor with ``--format pt``). The
char-path canvas is the engine's (the compact char tower's 224 on the
presets that carry the trained CalliAlign asset, else the tile size).
Runs on the GPU unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, List

import numpy as np

PAGE_EXTS = (".npy", ".jpg")


def extract_embedding_for_image(engine, image, labelme: Dict, *, drop_zero: bool = True,
                                hard_vq: bool = False) -> np.ndarray:
    """labelme {"shapes": [{"points": [[x1, y1], [x2, y2]]}, ...]} with
    normalized coordinates -> pseudo embeddings (M, E) float32."""
    import torch

    from callireader_tpu_torch.runtime.engine import CHAR_BUCKETS
    from callireader_tpu_torch.vision import preprocess

    img = preprocess.open_image(image)
    h, w = img.shape[:2]
    crops = []
    for shape in labelme["shapes"]:
        (x1, y1), (x2, y2) = shape["points"]
        x1, y1, x2, y2 = int(x1 * w), int(y1 * h), int(x2 * w), int(y2 * h)
        if x2 <= x1 or y2 <= y1:
            continue
        crops.append(preprocess.load_char_content(img[y1:y2, x1:x2], engine.char_canvas))
    if not crops:
        return np.zeros((0, engine.cfg.llm.hidden_size), np.float32)
    padded, n = preprocess.pad_to_bucket(np.stack(crops), CHAR_BUCKETS)
    with torch.inference_mode():
        pseudo, indices = engine._char_pipeline(engine._to_dev(padded), hard_vq)
    k = engine.cfg.resampler.num_learns
    pseudo = pseudo[:n * k].float().cpu().numpy()
    if drop_zero:
        pseudo = pseudo[indices[:n].reshape(-1).cpu().numpy() != 0]
    return pseudo


def page_pairs(folder: str) -> List[str]:
    """Paths of the pages in ``folder`` that have a labelme ``.json`` beside them."""
    out = []
    for f in sorted(os.listdir(folder)):
        if not f.endswith(".json"):
            continue
        stem = os.path.join(folder, f[:-len(".json")])
        page = next((stem + ext for ext in PAGE_EXTS if os.path.exists(stem + ext)), None)
        if page is not None:
            out.append(page)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description="extract e-IT pseudo embeddings")
    parser.add_argument("--data", type=str, required=True,
                        help="folder of paired <name>.npy or <name>.jpg + <name>.json (labelme)")
    parser.add_argument("--out", type=str, required=True)
    parser.add_argument("--drop_zero", action="store_true", default=True)
    parser.add_argument("--hard_vq", action="store_true", default=False)
    parser.add_argument("--format", choices=["npy", "pt"], default="npy")
    parser.add_argument("--preset", type=str, default="callireader-8b")
    parser.add_argument("--checkpoint", type=str, default=os.environ.get("CALLIREADER_CKPT"),
                        help="InternVL checkpoint directory (reference layout)")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)

    from callireader_tpu_torch.cli import common

    try:
        engine = common.build_engine(preset=args.preset, checkpoint_dir=args.checkpoint,
                                     random_init_ok=args.random_init, device=args.device)
    except (NotImplementedError, FileNotFoundError) as e:
        parser.error(str(e))
    os.makedirs(args.out, exist_ok=True)
    for page in page_pairs(args.data):
        name = os.path.splitext(os.path.basename(page))[0]
        with open(os.path.join(args.data, name + ".json"), encoding="utf-8") as f:
            labelme = json.load(f)
        emb = extract_embedding_for_image(engine, page, labelme, drop_zero=args.drop_zero,
                                          hard_vq=args.hard_vq)
        if args.format == "npy":
            np.save(os.path.join(args.out, name + ".npy"), emb)
        else:
            import torch

            torch.save(torch.from_numpy(emb), os.path.join(args.out, name + ".pt"))
        print(f"{name}: {emb.shape[0]} pseudo tokens", file=sys.stderr)


if __name__ == "__main__":
    main()
