"""Train the compact CalliAlign stack from scratch and write a v3 asset (port
of scripts/train_callialign.py).

  python -m callireader_tpu_torch.scripts.train_callialign --steps 6000 --batch 96 \
      --out callialign.npz [--device cpu]

The v3 recipe of train/callialign_train.py: a compact char tower (a 6-layer,
256-wide ViT at its own 224 canvas, the char projector and a 3-layer
resampler projecting to the 4096-wide token table) trained end to end in
float32 against the engine's seed-0 VQ table, whose hidden size and vocab
the 2b and 8b presets share. The asset loads through
runtime/weights.overlay_trained_assets.

The training data is a finite pool of pre-made augmented views (fixture
crops, the detector's matched crops of the fixture page, procedural glyphs),
sampled by a producer thread while the device steps. ``main`` reads the
reference fixture page (examples/0.jpg and 0.json at the root of the
repository) and raises while it is absent. ``build_data`` and ``train_loop``
are apart, so that the loop runs on glyph-only pools as well. Runs on the
card unless ``--device cpu``. Prints ``[data]``, ``[model]``, ``[step]``,
``[eval]``, ``[ckpt]`` and ``[done]`` lines.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import threading
import time
import types

import numpy as np


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--batch", type=int, default=96)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--warmup", type=int, default=300)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--aux-weight", type=float, default=0.5)
    p.add_argument("--fixed-views", type=int, default=48,
                   help="augmented views per fixture class in the finite training pool "
                   "(0 = an endless stream of fresh augmentations)")
    p.add_argument("--synth-views", type=int, default=8,
                   help="views per synthetic glyph class in the pool")
    p.add_argument("--no-white-center", dest="white_center", action="store_false", default=True)
    p.add_argument("--p-fixture", type=float, default=0.5,
                   help="fixture share of each streamed batch (stream mode)")
    p.add_argument("--strength", type=float, default=1.0)
    p.add_argument("--synth-chars", type=int, default=0,
                   help="cap on synthetic distractor classes (0 = all ~7k)")
    # held-out protocol: K fixture chars' real crops kept out of training
    # (the chars stay classes through their glyphs only), N synthetic
    # classes kept out entirely
    p.add_argument("--holdout-fixture", type=int, default=0,
                   help="fixture classes whose real crops are held out")
    p.add_argument("--holdout-synth", type=int, default=0,
                   help="synthetic classes excluded from training entirely")
    p.add_argument("--eval-every", type=int, default=500)
    p.add_argument("--out", type=str, default="callialign.npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def v3_config():
    """The 2b preset with the compact tower: the LLM's hidden size and vocab
    (the VQ space) are the 8b's too."""
    from callireader_tpu_torch.core.config import get_config
    from callireader_tpu_torch.train import callialign_train as ca

    return dataclasses.replace(get_config("callireader-2b"), char_vision=ca.CHAR_VISION_V3,
                               resampler=ca.CHAR_RESAMPLER_V3)


def _resize_to_bucket(c: np.ndarray) -> np.ndarray:
    """The eval crops' resize into the raw bucket: Pillow's default
    ``Image.resize`` (BICUBIC) in numpy."""
    from callireader_tpu_torch.train import callialign_train as ca
    from callireader_tpu_torch.vision.resample import pil_resize

    m = max(c.shape)
    if m <= ca.RAW_BUCKET:
        return c
    s = ca.RAW_BUCKET / m
    return pil_resize(c, (max(2, int(c.shape[1] * s)), max(2, int(c.shape[0] * s))), "bicubic")


def build_data(args, tok, canvas: int, fixture, det_fix) -> types.SimpleNamespace:
    """Class lists, the fixed eval sets, the samplers and the training pool
    from the fixture's crops (``fixture``, ``det_fix``: lists of (crop, box,
    char, token id), empty for a glyph-only run) and the single-char vocab.
    Eval sets with no crop are left out."""
    from callireader_tpu_torch.train import callialign_train as ca

    vocab = ca.single_char_vocab(tok)
    fix_tids = {tid for _, _, _, tid in fixture}
    synth = [(tid, ch) for tid, ch in vocab if tid not in fix_tids]
    if args.synth_chars:
        synth = synth[: args.synth_chars]

    held_fix, held_det, held_synth = [], [], []
    if args.holdout_synth:
        hr = np.random.RandomState(4243)
        hidx = set(hr.choice(len(synth), size=args.holdout_synth, replace=False).tolist())
        held_synth = [s for i, s in enumerate(synth) if i in hidx]
        synth = [s for i, s in enumerate(synth) if i not in hidx]
    if args.holdout_fixture:
        hr = np.random.RandomState(4242)
        uniq = sorted({tid for _, _, _, tid in fixture})
        held_ids = set(int(t) for t in hr.choice(uniq, size=args.holdout_fixture, replace=False))
        held_fix = [s for s in fixture if s[3] in held_ids]
        held_det = [s for s in det_fix if s[3] in held_ids]
        fixture = [s for s in fixture if s[3] not in held_ids]
        det_fix = [s for s in det_fix if s[3] not in held_ids]
        # the held-out chars stay classes through their procedural glyphs only
        id2ch = {tid: ch for _c, _b, ch, tid in held_fix}
        synth = synth + [(tid, id2ch[tid]) for tid in sorted(held_ids)]
        print(f"[data] held out {len(held_ids)} fixture classes ({len(held_fix)} crops, "
              f"{len(held_det)} det crops); {len(held_synth)} synth classes", flush=True)
    print(f"[data] fixture chars: {len(fixture)}, synthetic classes: {len(synth)}", flush=True)
    cls_map = np.full(tok.vocab_size, -1, np.int64)
    for i, (tid, _ch) in enumerate(vocab):
        cls_map[tid] = i

    def eval_pack(pairs):
        raw, src, tgt = ca.pack_raw_batch([_resize_to_bucket(c) for c, _ in pairs],
                                          input_size=canvas)
        return raw, src, tgt, np.asarray([t for _, t in pairs], np.int32)

    def clean(samples):
        return [(c[b[0]:b[2], b[1]:b[3]], t) for c, b, _ch, t in samples]

    # fixed eval sets: clean fixture crops, held-out augmented views, glyphs
    ev_rng = np.random.RandomState(12345)
    fix_aug = [(ca.augment_luma(c, ev_rng, box=b, strength=args.strength), t)
               for c, b, _ch, t in fixture for _ in range(2)]
    sampler_ev = ca.BatchSampler(None, synth, ev_rng, p_fixture=0.0, strength=args.strength)
    synth_eval = [(sampler_ev._glyph(ch), t)
                  for t, ch in synth[:: max(1, len(synth) // 128)][:128]]
    held_synth_eval = [(sampler_ev._glyph(ch), t)
                       for t, ch in held_synth[:: max(1, len(held_synth) // 128)][:128]]
    # fix_det: the detector's crops at the exact deployed box (no margin or
    # jitter); the holdout sets: real crops of classes trained on glyphs only
    sets = {"fix_clean": clean(fixture), "fix_aug": fix_aug, "synth": synth_eval,
            "fix_det": clean(det_fix), "fix_holdout": clean(held_fix),
            "fix_det_holdout": clean(held_det), "synth_holdout": held_synth_eval}
    eval_sets = {name: eval_pack(pairs) for name, pairs in sets.items() if pairs}

    sampler = ca.BatchSampler(fixture, synth, np.random.RandomState(args.seed),
                              p_fixture=args.p_fixture, strength=args.strength)
    pool = None
    if args.fixed_views:
        # a finite dataset iterated in epochs (a finite pool lets memorisation
        # seed the clustering; the v2 recipe found nothing stable to
        # bootstrap on in a stream of fresh augmentations)
        pr = np.random.RandomState(args.seed + 7)
        crops, labs = [], []
        for c, b, _ch, tid in list(fixture) + list(det_fix):
            for _ in range(args.fixed_views):
                crops.append(ca.augment_luma(c, pr, box=b, strength=args.strength))
                labs.append(tid)
        for tid, ch in synth:
            g = sampler._glyph(ch)
            for _ in range(args.synth_views):
                crops.append(ca.augment_luma(g, pr, strength=args.strength))
                labs.append(tid)
        pool = (crops, np.asarray(labs, np.int64))
        print(f"[data] fixed pool: {len(crops)} views ({args.fixed_views}/fixture class, "
              f"{args.synth_views}/synth class)", flush=True)
    return types.SimpleNamespace(vocab=vocab, synth=synth, fixture=fixture, det_fix=det_fix,
                                 cls_map=cls_map, eval_sets=eval_sets, sampler=sampler,
                                 pool=pool)


def train_loop(args, cfg, data, device) -> dict:
    """The v3 training loop on ``data`` (build_data): steps, evals every
    ``--eval-every`` steps and at the end, each eval followed by the asset
    written to ``--out``. -> {"losses": the steps' loss_vq, "ms_per_step":
    host clock over steps 2.., a sync at each end, "evals": the last eval,
    "trainable": the trained tree, "frozen": the targets}."""
    import torch

    from callireader_tpu_torch.core.dtypes import FP32_POLICY
    from callireader_tpu_torch.train import callialign_train as ca
    from callireader_tpu_torch.train import e_it

    canvas = cfg.char_vision.image_size
    # fp32 training (bf16 stalled below its resolution in the v2 analysis;
    # at 14M parameters the fp32 step is cheap)
    policy = FP32_POLICY
    frozen = ca.build_v3_frozen(cfg, class_token_ids=[tid for tid, _ch in data.vocab],
                                device=device)
    gen = lambda s: torch.Generator(device=device).manual_seed(s)  # noqa: E731
    trainable = {
        "stack": ca.init_v3_params(gen(args.seed + 1), cfg, white_center=args.white_center,
                                   device=device),
        "logit_scale": torch.tensor(np.log(1.0 / 0.07), dtype=torch.float32, device=device),
        "aux": ca.init_aux_head(gen(args.seed + 2), cfg, len(data.vocab), dim=cfg.resampler.dim,
                                device=device),
    }
    n_par = sum(x.numel() for x in e_it.flatten(trainable["stack"]).values())
    print(f"[model] compact stack: {n_par / 1e6:.1f}M params (canvas {canvas})", flush=True)

    warmup = min(args.warmup, max(1, args.steps // 10))
    optimizer = ca.v3_optimizer(args.lr, args.steps, warmup, args.weight_decay)
    opt_state = optimizer.init(e_it.flatten(trainable))
    step_fn = ca.make_v3_step_fn(cfg, policy, optimizer, aux_weight=args.aux_weight)
    eval_fn = ca.make_v3_eval_fn(cfg, policy)

    def to_dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # the batch producer: host packing overlaps the device step
    q: "queue.Queue" = queue.Queue(maxsize=4)
    stop = threading.Event()

    def produce():
        rng = np.random.RandomState(args.seed + 13)
        while not stop.is_set():
            if data.pool is not None:
                idx = rng.randint(len(data.pool[0]), size=args.batch)
                raw, src, tgt = ca.pack_raw_batch([data.pool[0][i] for i in idx],
                                                  input_size=canvas)
                item = (raw, src, tgt, data.pool[1][idx])
            else:
                item = data.sampler.sample(args.batch)
            while not stop.is_set():
                try:
                    q.put(item, timeout=1.0)
                    break
                except queue.Full:
                    continue

    def run_eval(tag):
        out = {}
        chunk = args.batch
        for name, (raw, src, tgt, labels) in data.eval_sets.items():
            toks, chars, n = 0.0, 0.0, len(labels)
            for i in range(0, n, chunk):
                sl = slice(i, i + chunk)
                pads = chunk - len(labels[sl])
                pt, pc, _ = eval_fn(
                    trainable["stack"], frozen["table_n"],
                    to_dev(np.pad(raw[sl], ((0, pads), (0, 0), (0, 0)))),
                    to_dev(np.pad(src[sl], ((0, pads), (0, 0)), constant_values=1)),
                    to_dev(np.pad(tgt[sl], ((0, pads), (0, 0)), constant_values=1)),
                    to_dev(np.pad(labels[sl], (0, pads), constant_values=-1)))
                # padded rows never match label -1: rescale the means
                toks += float(pt) * chunk
                chars += float(pc) * chunk
            out[name] = [(canvas, toks / n, chars / n)]
        msg = " | ".join(f"{name} " + " ".join(f"c{c}:tok{pt:.3f}/chr{pc:.3f}" for c, pt, pc in accs)
                         for name, accs in out.items())
        print(f"[eval {tag}] {msg}", flush=True)
        return out

    def save(tag, res):
        meta = {
            "char_vision": dataclasses.asdict(cfg.char_vision),
            "char_resampler": dataclasses.asdict(cfg.resampler),
            "steps": tag, "canvases": [canvas], "eval": res,
            "n_fixture": len(data.fixture), "n_synth": len(data.synth),
            "fixed_views": args.fixed_views, "lr": args.lr,
            "holdout_fixture": args.holdout_fixture, "holdout_synth": args.holdout_synth,
        }
        ca.save_v3_asset(args.out, trainable["stack"], meta)
        print(f"[ckpt] saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)", flush=True)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    th = threading.Thread(target=produce, daemon=True)
    th.start()
    t0 = time.time()
    losses, evals, t_first = [], None, None
    try:
        for it in range(args.steps):
            raw, src, tgt, labels = q.get()
            cls = data.cls_map[labels].astype(np.int32)
            trainable, opt_state, loss, acc, aux_acc = step_fn(
                trainable, opt_state, frozen, (to_dev(raw), to_dev(src), to_dev(tgt), to_dev(cls)))
            losses.append(loss)
            if it == 0:
                sync()
                t_first = time.time()
            if (it + 1) % 50 == 0:
                ls = [float(x) for x in losses[-50:]]
                print(f"[step {it + 1}/{args.steps}] loss {np.mean(ls):.4f} acc {float(acc):.3f} "
                      f"aux_acc {float(aux_acc):.3f} ({(time.time() - t0) / (it + 1):.2f}s/step)",
                      flush=True)
            if (it + 1) % args.eval_every == 0 or it + 1 == args.steps:
                sync()
                t_eval = time.time()
                evals = run_eval(it + 1)
                save(it + 1, evals)
                t_first += time.time() - t_eval  # evals and saves are not steps
    finally:
        stop.set()
        th.join()
    sync()
    elapsed = time.time() - t0
    ms = (time.time() - t_first) * 1e3 / (args.steps - 1) if args.steps > 1 else None
    print(f"[done] {args.steps} steps in {elapsed / 60:.1f} min", flush=True)
    return {"losses": [float(x) for x in losses], "ms_per_step": ms, "evals": evals,
            "trainable": trainable, "frozen": frozen}


def main(argv=None) -> dict:
    args = parse_args(argv)
    from callireader_tpu_torch.core.dtypes import require_device
    from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer
    from callireader_tpu_torch.train import callialign_train as ca

    device = require_device(args.device)
    cfg = v3_config()
    tok = InternLM2Tokenizer()
    print("[data] building fixture + synthetic class lists", flush=True)
    fixture = ca.fixture_samples(tok)
    # the trained detector's own crops of the page, matched to the GT (the
    # deployed box geometry)
    det_fix = ca.fixture_detector_samples(tok, device=device)
    print(f"[data] detector-matched fixture crops: {len(det_fix)}", flush=True)
    data = build_data(args, tok, cfg.char_vision.image_size, fixture, det_fix)
    return train_loop(args, cfg, data, device)


if __name__ == "__main__":
    main()
