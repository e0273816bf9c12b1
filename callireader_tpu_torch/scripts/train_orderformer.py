"""Train the OrderFormer reading-order regressor on synthetic layouts (port
of scripts/train_orderformer.py).

The reference ships a trained checkpoint (params/orderformer.pth,
config/configu.py:61) whose training data is not public; this script
synthesizes column-box layouts spanning the conventions of Chinese
calligraphy reading order and trains the port's OrderFormer
(models/orderformer.py) to regress the reading rank of each box.

Layout families (reading order = generation order):
  columns    k vertical columns, right-to-left
  signature  main columns + 1-3 short colophon columns at the far left
  broken     some columns split into stacked segments: segments read
             top-to-bottom before moving left
  row        a single horizontal line of blocks (plaque/couplet), right-to-left
  grid       m x n album grid, column-major right-to-left

Targets follow _prep_inputs' convention exactly: boxes are normalized,
shifted to the layout's min corner, sorted by distance-to-origin; the model
regresses each row's 1-based reading rank (decoded by double argsort). The
layouts come from numpy ``RandomState``: the JAX script's, byte for byte.

  python -m callireader_tpu_torch.scripts.train_orderformer --samples 6000 --epochs 60 \
      --out orderformer.npz [--cpu]

Runs on the card unless ``--cpu``. Prints ONE JSON line with held-out
metrics (exact-order accuracy + mean Kendall tau). ``--eval-fixture`` scores
the reference page (examples/0.json at the root of the repository) and
raises where that file is absent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from callireader_tpu_torch.train.detector_train import FIXTURE_JSON


# ---------------------------------------------------------------------------
# synthetic layout generator (normalized page coords, w = h = 1)
# ---------------------------------------------------------------------------


def _jitter(rng, v, s):
    return v + rng.uniform(-s, s)


def _gen_columns(rng, k, *, y0_lo=0.02, y0_hi=0.18, h_lo=0.35, h_hi=0.93):
    """k vertical columns right-to-left; returns boxes in reading order."""
    right = rng.uniform(0.86, 0.97)
    left = rng.uniform(0.03, 0.2)
    pitch = (right - left) / k
    width = pitch * rng.uniform(0.35, 0.8)
    boxes = []
    for i in range(k):
        x1 = right - (i + 1) * pitch + _jitter(rng, 0, pitch * 0.08)
        y0 = rng.uniform(y0_lo, y0_hi)
        h = rng.uniform(h_lo, min(h_hi, 0.98 - y0))
        boxes.append([x1, y0, x1 + width * rng.uniform(0.85, 1.15), y0 + h])
    return boxes


def gen_layout(rng) -> list:
    """-> boxes [[x1,y1,x2,y2], ...] in reading order (max 50)."""
    fam = rng.choice(["columns", "signature", "broken", "row", "grid"],
                     p=[0.3, 0.25, 0.2, 0.1, 0.15])
    if fam == "columns":
        boxes = _gen_columns(rng, rng.randint(1, 15))
    elif fam == "signature":
        k = rng.randint(2, 11)
        main = _gen_columns(rng, k, h_lo=0.55)
        sig_x = min(b[0] for b in main)
        sig = []
        for j in range(rng.randint(1, 4)):
            w = rng.uniform(0.02, 0.05)
            x1 = sig_x - (j + 1) * rng.uniform(0.05, 0.1)
            y0 = rng.uniform(0.1, 0.5)
            sig.append([x1, y0, x1 + w, y0 + rng.uniform(0.1, 0.4)])
        boxes = main + sig
    elif fam == "broken":
        cols = _gen_columns(rng, rng.randint(2, 12))
        boxes = []
        for b in cols:
            if rng.rand() < 0.35 and (b[3] - b[1]) > 0.3:
                ym = rng.uniform(b[1] + 0.1, b[3] - 0.1)
                gap = rng.uniform(0.01, 0.04)
                boxes.append([b[0], b[1], b[2], ym])
                boxes.append([
                    _jitter(rng, b[0], 0.01), ym + gap, _jitter(rng, b[2], 0.01), b[3],
                ])
            else:
                boxes.append(b)
    elif fam == "row":
        # single horizontal line (plaque), right-to-left
        k = rng.randint(2, 9)
        right = rng.uniform(0.85, 0.97)
        pitch = (right - rng.uniform(0.03, 0.15)) / k
        y0 = rng.uniform(0.2, 0.6)
        h = rng.uniform(0.1, 0.35)
        boxes = []
        for i in range(k):
            x1 = right - (i + 1) * pitch
            boxes.append([
                x1, _jitter(rng, y0, 0.01 * h),
                x1 + pitch * rng.uniform(0.5, 0.85), y0 + h,
            ])
    else:  # grid: column-major right-to-left, top-to-bottom within a column
        m, n = rng.randint(2, 8), rng.randint(2, 8)
        right, top = rng.uniform(0.85, 0.97), rng.uniform(0.03, 0.15)
        pw = (right - rng.uniform(0.03, 0.1)) / n
        ph = (rng.uniform(0.85, 0.97) - top) / m
        boxes = []
        for j in range(n):
            for i in range(m):
                x1 = right - (j + 1) * pw + _jitter(rng, 0, pw * 0.05)
                y1 = top + i * ph + _jitter(rng, 0, ph * 0.05)
                boxes.append([
                    x1, y1, x1 + pw * rng.uniform(0.6, 0.9), y1 + ph * rng.uniform(0.6, 0.9),
                ])
    return boxes[:50]




def build_dataset(cfg, n_samples: int, seed: int):
    """-> boxes (N, max_boxes, 4), ranks (N, max_boxes, 1), counts (N,)."""
    from callireader_tpu_torch.models.orderformer import _prep_inputs

    rng = np.random.RandomState(seed)
    boxes = np.zeros((n_samples, cfg.max_boxes, 4), np.float32)
    ranks = np.zeros((n_samples, cfg.max_boxes, 1), np.float32)
    counts = np.zeros(n_samples, np.int64)
    for i in range(n_samples):
        layout = gen_layout(rng)
        shapes = [{"points": [[b[0], b[1]], [b[2], b[3]]]} for b in layout]
        row, labels = _prep_inputs(cfg, shapes, 1.0, 1.0)
        rank_of = {tuple(b): r + 1 for r, b in enumerate(layout)}
        boxes[i] = row
        for j, flat in enumerate(labels):
            ranks[i, j, 0] = rank_of[tuple(flat)]
        counts[i] = len(labels)
    return boxes, ranks, counts


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def kendall_tau(a: np.ndarray, b: np.ndarray) -> float:
    """Plain O(n^2) Kendall rank correlation of two same-length rankings."""
    n = len(a)
    if n < 2:
        return 1.0
    conc = disc = 0
    for i in range(n):
        for j in range(i + 1, n):
            s = np.sign(a[i] - a[j]) * np.sign(b[i] - b[j])
            conc += s > 0
            disc += s < 0
    denom = n * (n - 1) / 2
    return float((conc - disc) / denom)


def eval_heldout(params, cfg, boxes, ranks, counts):
    import torch

    from callireader_tpu_torch.models import orderformer as of

    with torch.no_grad():
        pred = of.forward(params, cfg, torch.from_numpy(boxes).to(
            params["embed_kernel"].device)).cpu().numpy()
    exact, taus = 0, []
    for i in range(len(boxes)):
        n = int(counts[i])
        got = of._decode_ranks(pred[i], n)
        want = of._decode_ranks(ranks[i], n)
        exact += int(np.array_equal(got, want))
        taus.append(kendall_tau(got.astype(float), want.astype(float)))
    return {
        "exact_order_acc": round(exact / len(boxes), 4),
        "mean_kendall_tau": round(float(np.mean(taus)), 4),
    }


def eval_fixture(params, cfg) -> dict:
    """Reading order on the real page: GT char boxes -> char2col columns ->
    OrderFormer -> per-column y-sort -> compare to the annotation's `turn`
    sequence (examples/0.json)."""
    from callireader_tpu_torch.models import orderformer as of
    from callireader_tpu_torch.vision import boxes as boxes_mod

    with open(FIXTURE_JSON) as f:
        d = json.load(f)
    W, H = d["imageWidth"], d["imageHeight"]
    shapes = d["shapes"]
    gt = [
        [s["points"][0][0] * W, s["points"][0][1] * H,
         s["points"][1][0] * W, s["points"][1][1] * H]
        for s in shapes
    ]
    pair = [[[b[0], b[1]], [b[2], b[3]]] for b in gt]
    data = boxes_mod.char2col_with_kmeans(pair, W, H)
    col_order = of.predict(params, cfg, data["shapes"], W, H)

    # flat char order via the engine's rule (engine.sort_boxes)
    final = []
    for _, col in col_order.items():
        lst = [b for b in gt if boxes_mod.calculate_iou(col, b, mini=True) >= 0.8]
        lst.sort(key=lambda b: (b[1] + b[3]) / 2)
        final.extend(lst)

    # match each ordered box back to its GT index (boxes are exact copies)
    key_of = {tuple(np.round(b, 3)): i for i, b in enumerate(gt)}
    pred_seq = [key_of[tuple(np.round(b, 3))] for b in final]
    turn = np.array([s["turn"] for s in shapes], np.float64)
    got_rank = np.full(len(gt), np.nan)
    for pos, idx in enumerate(pred_seq):
        got_rank[idx] = pos + 1
    covered = ~np.isnan(got_rank)
    tau = kendall_tau(got_rank[covered], turn[covered])
    exact = int(np.array_equal(np.argsort(got_rank[covered]), np.argsort(turn[covered])))
    return {
        "fixture_chars": len(gt),
        "fixture_covered": int(covered.sum()),
        "fixture_n_columns": len(col_order),
        "fixture_kendall_tau": round(tau, 4),
        "fixture_exact_order": exact,
    }


# ---------------------------------------------------------------------------


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--samples", type=int, default=6000)
    p.add_argument("--heldout", type=int, default=400)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None, help="save trained params (.npz)")
    p.add_argument("--init-from", default=None,
                   help="resume/fine-tune from a saved .npz instead of fresh init")
    p.add_argument("--eval-fixture", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (default: the card)")
    p.add_argument("--eval-every", type=int, default=0,
                   help="evaluate held-out metrics every K epochs; with --out, "
                   "save the running params each time (crash-safe), and stop "
                   "early once exact>=0.9 and tau>=0.99. NOTE: each K-epoch "
                   "chunk restarts AdamW moments and the cosine schedule "
                   "(warm restarts) — NOT equivalent to one --epochs run")
    args = p.parse_args(argv)
    if args.eval_fixture and not os.path.exists(FIXTURE_JSON):
        raise FileNotFoundError(f"--eval-fixture reads {FIXTURE_JSON}, which is not in the "
                                "repository")

    import torch

    from callireader_tpu_torch.core.config import OrderFormerConfig
    from callireader_tpu_torch.core.dtypes import require_device
    from callireader_tpu_torch.models import orderformer as of
    from callireader_tpu_torch.models.detector import load_npz, save_npz

    device = require_device("cpu" if args.cpu else "cuda")
    cfg = OrderFormerConfig()
    print(f"[train_orderformer] generating {args.samples}+{args.heldout} layouts",
          file=sys.stderr)
    boxes, ranks, counts = build_dataset(cfg, args.samples + args.heldout, args.seed)
    tr = slice(0, args.samples)
    ho = slice(args.samples, None)

    if args.init_from:
        params = load_npz(args.init_from, device)
        print(f"[train_orderformer] resuming from {args.init_from}", file=sys.stderr)
    else:
        params = of.init_params(cfg, torch.Generator(device=device).manual_seed(args.seed),
                                device=device)
    if args.eval_every:
        # chunked training with periodic held-out eval, crash-safe saves, and
        # early stop at the quality bar
        best = float("inf")
        done = 0
        while done < args.epochs:
            k = min(args.eval_every, args.epochs - done)
            params, best = of.train_orderformer(
                params, cfg, boxes[tr], ranks[tr], batch_size=args.batch,
                lr=args.lr, epochs=k, seed=args.seed + done, verbose=True,
            )
            done += k
            m = eval_heldout(params, cfg, boxes[ho], ranks[ho], counts[ho])
            print(f"[train_orderformer] epoch {done}: {m}", file=sys.stderr)
            if args.out:
                save_npz(args.out, params)
            if m["exact_order_acc"] >= 0.9 and m["mean_kendall_tau"] >= 0.99:
                print("[train_orderformer] early stop: quality bar met", file=sys.stderr)
                break
    else:
        params, best = of.train_orderformer(
            params, cfg, boxes[tr], ranks[tr], batch_size=args.batch,
            lr=args.lr, epochs=args.epochs, seed=args.seed, verbose=True,
        )

    out = {"metric": "orderformer_heldout", "train_loss": round(best, 5)}
    out.update(eval_heldout(params, cfg, boxes[ho], ranks[ho], counts[ho]))
    if args.eval_fixture:
        out.update(eval_fixture(params, cfg))
    if args.out:
        save_npz(args.out, params)
        out["saved"] = args.out
        out["size_mb"] = round(os.path.getsize(args.out) / 1e6, 2)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
