"""Batch serving CLI: JSONL requests -> JSONL responses via continuous
batching, or an HTTP server (PyTorch port of callireader_tpu/cli/serve.py).

  python -m callireader_tpu_torch.cli.serve --input requests.jsonl \
      --output out.jsonl --slots 8 --paged --quant int8 --checkpoint InternVL/

Request lines: {"id": ..., "question": "...", "image": "path.jpg"?,
                "use_p": true?, "max_new_tokens": 1024?, "stop_tokens": [id..]?,
                "repetition_penalty": 1.0?}
`stop_tokens` are extra per-request stop ids on top of the template's eos.
The vision / CalliAlign front half runs per wave of requests (host tiling,
batched detector / OrderFormer / char pipeline, one fused tile encode); decode
rides the slot scheduler (runtime/serving.py, or runtime/paged_cache.py with
--paged) so every step advances all in-flight requests.

``--device-tile-pages`` (the default) / ``--host-tile-pages`` select the
engine's batch-API tiling route, as in the JAX CLI; the serve front half
tiles on the host either way, as the JAX server's does. ``--rgb-chars``
ships full-RGB char crops (the reference's; the luma default ships 3x fewer
bytes), ``--gray-chars`` names the default. ``--quant int8-all`` adds the
W8A8 tile tower, ``--char-canvas`` the shared tower's canvas lever.

Runs on the GPU unless ``--device cpu`` is given. ``--checkpoint`` (default
``$CALLIREADER_CKPT``) is a reference-layout InternVL directory, its side
files under ``params/``; without one, ``--random-init`` draws seeded random
ViT / LLM weights, as the JAX CLI does. The committed trained detector,
OrderFormer and CalliAlign tower overlay the components drawn at random
unless ``--no-trained-assets`` is given. Image files are decoded with PIL,
imported only when a request names one.

``--mesh tensor=4`` serves over a mesh, one process per rank
(``torchrun --nproc-per-node 4 -m callireader_tpu_torch.cli.serve --mesh
tensor=4 ...``; a world of 1 without torchrun): every rank reads the same
requests and runs the same scheduler on its block of the model (its KV
heads of the cache or page pool), and rank 0 alone writes the responses.
The HTTP server takes a world of 1 only (its requests reach one process).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _read_image(path: str):
    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def main(argv=None):
    parser = argparse.ArgumentParser(description="JSONL batch / HTTP server")
    parser.add_argument("--input", type=str, default=None, help="JSONL request file (batch mode)")
    parser.add_argument("--output", type=str, default=None, help="JSONL response file (batch mode)")
    parser.add_argument("--http", type=int, default=None, metavar="PORT",
                        help="serve HTTP instead of JSONL batch: OpenAI-compatible POST "
                        "/v1/chat/completions (stream + non-stream), native POST /ocr, "
                        "GET /health|/metrics (runtime/http_server.py)")
    parser.add_argument("--host", type=str, default="127.0.0.1",
                        help="HTTP bind address (with --http)")
    parser.add_argument("--slots", type=int, default=8)
    parser.add_argument("--max-len", type=int, default=4096)
    parser.add_argument("--paged", action="store_true",
                        help="paged KV cache (runtime/paged_cache.py): device memory scales "
                        "with live tokens instead of slots*max_len")
    parser.add_argument("--page-size", type=int, default=128)
    parser.add_argument("--num-pages", type=int, default=None,
                        help="pool size; default sized to slots*max_len")
    parser.add_argument("--preset", type=str, default="callireader-8b")
    parser.add_argument("--checkpoint", type=str, default=os.environ.get("CALLIREADER_CKPT"),
                        help="InternVL checkpoint directory (reference layout)")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--quant", type=str, default=None, choices=[None, "int8", "int8-all"])
    parser.add_argument("--repetition-penalty", type=float, default=1.0)
    parser.add_argument("--device-tile-pages", action="store_true", default=True,
                        help="(default) the engine's batch API tiles pages on the device")
    parser.add_argument("--host-tile-pages", dest="device_tile_pages", action="store_false",
                        help="the engine's batch API tiles pages on the host (bit-equal to the "
                        "reference's preprocessing)")
    chars = parser.add_mutually_exclusive_group()
    chars.add_argument("--rgb-chars", action="store_true",
                       help="full-RGB char canvases (the reference's crops; 3x the bytes of the "
                       "luma default)")
    chars.add_argument("--gray-chars", action="store_true",
                       help="(default) luma char canvases, broadcast to RGB on the device")
    parser.add_argument("--char-canvas", type=int, default=None,
                        help="char-ViT canvas of the shared tower (default: the model's 448)")
    parser.add_argument("--prefix-cache", action="store_true",
                        help="auto-register each text-only prompt's prefix KV so the next "
                        "turn of a conversation prefills only its suffix")
    parser.add_argument("--no-trained-assets", action="store_true",
                        help="skip the in-repo trained detector/orderformer/CalliAlign overlays")
    parser.add_argument("--steps-per-sync", type=int, default=1,
                        help="decode steps per host round trip: amortizes the sync, costs "
                        "up to k-1 throwaway steps per retiring request")
    parser.add_argument("--mesh", type=str, default=None,
                        help='SPMD inference mesh, e.g. "tensor=4,fsdp=2" (one process per rank '
                        'under torchrun; "data" takes the rest of the world)')
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    if args.http is None and (args.input is None or args.output is None):
        parser.error("--input/--output are required in JSONL batch mode (or pass --http PORT)")

    import numpy as np

    from callireader_tpu_torch.cli.common import build_engine
    from callireader_tpu_torch.runtime import generate as gen
    from callireader_tpu_torch.runtime.conversation import build_chat_prompt, get_conv_template
    from callireader_tpu_torch.runtime.engine import ALIGNED
    from callireader_tpu_torch.runtime.serving import ContinuousBatcher, Request
    from callireader_tpu_torch.vision import preprocess

    engine = build_engine(preset=args.preset, checkpoint_dir=args.checkpoint,
                          random_init_ok=args.random_init, quant=args.quant,
                          gray_chars=not args.rgb_chars,
                          device_tile_pages=args.device_tile_pages, char_canvas=args.char_canvas,
                          mesh_spec=args.mesh, trained_assets=not args.no_trained_assets,
                          device=args.device)
    if args.http is not None and engine.mesh is not None and engine.mesh.size > 1:
        parser.error("--http serves a world of 1: its requests reach one process")
    cfg = engine.cfg
    sep = get_conv_template(cfg.template).sep
    eos = (engine.tok.convert_tokens_to_ids(sep),)

    if args.paged:
        from callireader_tpu_torch.runtime.paged_cache import PagedBatcher

        pages_per_slot = -(-args.max_len // args.page_size)
        num_pages = args.num_pages or args.slots * pages_per_slot + 1
        batcher = PagedBatcher(
            engine.params["llm"], cfg.llm, num_slots=args.slots, num_pages=num_pages,
            page_size=args.page_size, max_pages_per_slot=pages_per_slot, policy=engine.policy,
            steps_per_sync=args.steps_per_sync, mesh=engine.mesh,
        )
    else:
        batcher = ContinuousBatcher(
            engine.params["llm"], cfg.llm, num_slots=args.slots, max_len=args.max_len,
            policy=engine.policy, steps_per_sync=args.steps_per_sync, mesh=engine.mesh,
        )

    if args.http is not None:
        from callireader_tpu_torch.runtime.http_server import serve_http

        server, loop = serve_http(
            engine, batcher, host=args.host, port=args.http, model_name=args.preset,
            default_rep_pen=args.repetition_penalty, prefix_cache=args.prefix_cache,
        )
        print(f"[serve] HTTP on http://{args.host}:{args.http} "
              f"(slots={args.slots}, paged={args.paged})", file=sys.stderr)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            loop.shutdown()
            server.server_close()
        return

    with open(args.input, encoding="utf-8") as f:
        requests = [json.loads(line) for line in f if line.strip()]
    t0 = time.time()

    # Wave-based admission: prepare + submit `wave` requests at a time, and
    # between waves drain the batcher until its queue fits the slot pool.
    # This bounds device memory at O(slots + wave) requests' embeds/features
    # (preparing everything first pins O(#requests) device memory), while
    # each wave still runs the batched detector/OrderFormer/char pipeline and
    # a fused tile encode.
    wave = max(args.slots, 4)
    prep_errors = {}
    done = []

    def prep_and_submit(uids):
        img_np = {u: _read_image(requests[u]["image"]) for u in uids if requests[u].get("image")}
        align_uids = [u for u in img_np if requests[u].get("use_p", True)]
        pseudo_by_uid = {}
        if align_uids:
            for u, (ps, _idx) in zip(
                align_uids, engine.batch_calli_align([img_np[u] for u in align_uids])
            ):
                pseudo_by_uid[u] = ps
        pixel_by_uid = {
            u: preprocess.load_image(im, cfg.force_image_size, cfg.max_dynamic_patch,
                                     cfg.use_thumbnail)
            for u, im in img_np.items()
        }
        feats_by_uid = {}
        if pixel_by_uid:
            order = list(pixel_by_uid)
            feats = engine.encode_image_tiles(
                engine._to_dev(np.concatenate([pixel_by_uid[u] for u in order], axis=0)))
            off = 0
            for u in order:
                n = pixel_by_uid[u].shape[0]
                feats_by_uid[u] = feats[off:off + n]
                off += n

        for uid in uids:
            rec = requests[uid]
            question = rec["question"]
            img_embeds = feats_by_uid.get(uid)
            pseudo = pseudo_by_uid.get(uid)
            n_tiles = pixel_by_uid[uid].shape[0] if uid in pixel_by_uid else 0
            if n_tiles:
                if "<image>" not in question:
                    question = "<image>\n" + question
                if pseudo is not None and ALIGNED not in question:
                    question = question + ALIGNED * pseudo.shape[0]
            conv = build_chat_prompt(question)
            query = engine._expand_image_tokens(conv.get_prompt(), [n_tiles] if n_tiles else [])
            ids = engine._tokenize_prompt(query)
            try:
                bucket = gen.bucket_length(len(ids))
            except ValueError as e:
                # fail the request, never the server (admission-guard policy)
                prep_errors[uid] = str(e)
                continue
            embeds, _mask = engine._build_row_embeds(ids, img_embeds, pseudo, bucket)
            row = embeds[0, bucket - len(ids):]  # strip the pad rows
            batcher.submit(
                Request(
                    uid, row.float().cpu().numpy(), dev_embeds=row,
                    max_new_tokens=int(rec.get("max_new_tokens", 1024)),
                    eos_token_ids=eos + tuple(int(t) for t in rec.get("stop_tokens", ())),
                    repetition_penalty=float(
                        rec.get("repetition_penalty", args.repetition_penalty)),
                )
            )

    for lo in range(0, len(requests), wave):
        prep_and_submit(list(range(lo, min(lo + wave, len(requests)))))
        while len(batcher.queue) > args.slots:
            batcher.step()
    done.extend(batcher.run())

    by_uid = {r.uid: r for r in done}
    from callireader_tpu_torch.parallel.spmd import is_main

    if not is_main():
        return
    with open(args.output, "w", encoding="utf-8") as f:
        for uid, rec in enumerate(requests):
            out = {"id": rec.get("id", uid)}
            if uid in prep_errors:
                out["error"] = prep_errors[uid]
            else:
                r = by_uid[uid]
                if r.error is not None:
                    out["error"] = r.error
                else:
                    text = engine.tok.decode(r.tokens, skip_special_tokens=True)
                    out["response"] = text.split(sep)[0].strip()
                    out["n_tokens"] = len(r.tokens)
            f.write(json.dumps(out, ensure_ascii=False) + "\n")
    dt = time.time() - t0
    total_toks = sum(len(r.tokens) for r in done)
    print(
        f"[serve] {len(requests)} requests, {total_toks} tokens in {dt:.1f}s "
        f"({total_toks / max(dt, 1e-9):.1f} tok/s aggregate)",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
