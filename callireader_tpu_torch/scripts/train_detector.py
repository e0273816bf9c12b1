"""Train the character detector on synthetic calligraphy pages (port of
scripts/train_detector.py).

  python -m callireader_tpu_torch.scripts.train_detector --steps 3000 --size 640 \
      --out detector_640.npz [--eval-fixture] [--device cpu]

Trains the YOLOv8-style detector of models/detector.py with the BCE + DFL
loss of train/detector_train.py on letterboxed fixture-statistics pages
(brush-stroke glyph columns + seal distractors, numpy ``RandomState``: the
JAX script's pages byte for byte), evaluates recall on held-out synthetic
pages and, with ``--eval-fixture``, on the reference fixture page
(examples/0.jpg at the root of the repository; absent, it raises), and
saves a .npz checkpoint that models.detector.load_npz reads (or a
train/checkpoint.save_params directory for another ``--out``).

The page bank is made once on the host (uint8) and uploaded once; each step
gathers its batch on the device. Runs on the card unless ``--device cpu``.
Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--size", type=int, default=640)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--max-boxes", type=int, default=128)
    p.add_argument("--bank", type=int, default=256, help="pre-generated page bank size")
    p.add_argument("--style", choices=["calligraphy", "boxes"], default="calligraphy")
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--eval-fixture", action="store_true",
                   help="recall@IoU0.5 against the reference fixture page's GT")
    p.add_argument("--conf", type=float, default=0.4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from callireader_tpu_torch.core.config import DetectorConfig
    from callireader_tpu_torch.core.dtypes import require_device
    from callireader_tpu_torch.models import detector as det
    from callireader_tpu_torch.train import detector_train as dt
    from callireader_tpu_torch.train import e_it

    if args.eval_fixture and not os.path.exists(dt.FIXTURE_IMG):
        raise FileNotFoundError(f"--eval-fixture reads {dt.FIXTURE_IMG}, which is not in the "
                                "repository")
    device = require_device(args.device)
    cfg = DetectorConfig(img_size=args.size, conf_threshold=args.conf)
    params = e_it.clone_tree(det.init_params(
        cfg, torch.Generator(device=device).manual_seed(args.seed), device=device), True)
    tc = dt.DetTrainConfig(total_steps=args.steps, learning_rate=args.lr)
    tx = dt.make_optimizer(tc)
    opt = tx.init(e_it.flatten(params))
    step = dt.make_train_step(cfg, tc, tx)

    rng = np.random.RandomState(args.seed)
    t0 = time.time()
    if args.style == "calligraphy":
        glyphs = dt.make_glyph_bank(rng, 300)
        imgs, gt, mask = dt.synth_calligraphy_pages(
            rng, args.bank, args.size, args.max_boxes, glyphs
        )
    else:
        imgs, gt, mask = dt.synth_pages(rng, args.bank, args.size, args.max_boxes)
        imgs = (imgs * 255).astype(np.uint8)
    print(f"[train_detector] bank: {args.bank} pages, "
          f"{int(mask.sum())} boxes, {time.time()-t0:.0f}s", file=sys.stderr)
    d_imgs = torch.from_numpy(imgs).to(device)  # uint8, one upload
    d_gt, d_mask = torch.from_numpy(gt).to(device), torch.from_numpy(mask).to(device)

    t0 = time.time()
    loss = None
    for i in range(args.steps):
        idx = torch.from_numpy(rng.randint(0, args.bank, args.batch)).to(device)
        params, opt, m = step(params, opt, d_imgs[idx], d_gt[idx], d_mask[idx])
        if i % 200 == 0 or i == args.steps - 1:
            loss = float(m["loss"])
            print(f"[train_detector] step {i}: loss {loss:.3f} "
                  f"({time.time()-t0:.0f}s)", file=sys.stderr)

    # held-out synthetic recall (fresh rng stream, full Detector pipeline)
    gen = (dt.synth_calligraphy_pages if args.style == "calligraphy"
           else lambda r, b, s, m: dt.synth_pages(r, b, s, m))
    recalls = []
    for s in range(8):
        hi, hgt, hmask = gen(np.random.RandomState(10_000 + s), 1, args.size, args.max_boxes)
        page = hi[0] if hi.dtype == np.uint8 else (hi[0] * 255).astype(np.uint8)
        recalls.append(dt.detection_recall(params, cfg, page.astype(np.float32) / 255.0,
                                           hgt[0][hmask[0]]))
    recall = float(np.mean(recalls))

    result = {
        "metric": "detector_synth_recall@iou0.5",
        "value": round(recall, 3),
        "unit": "recall",
        "per_page": [round(r, 3) for r in recalls],
        "style": args.style,
        "steps": args.steps,
        "final_loss": round(loss, 3),
        "seconds": round(time.time() - t0, 1),
    }

    if args.eval_fixture:
        fr, fp, npred = dt.fixture_recall(params, cfg)
        result["fixture_recall@iou0.5"] = round(fr, 3)
        result["fixture_precision"] = round(fp, 3)
        result["fixture_n_pred"] = npred
        print(f"[train_detector] FIXTURE recall {fr:.3f} precision {fp:.3f} "
              f"({npred} predictions vs 96 GT)", file=sys.stderr)

    if args.out:
        if args.out.endswith(".npz"):
            det.save_npz(args.out, params)
        else:
            from callireader_tpu_torch.train.checkpoint import save_params

            save_params(args.out, params)
        print(f"[train_detector] checkpoint saved to {args.out}", file=sys.stderr)
        result["checkpoint"] = args.out

    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
