"""Serving throughput evidence: aggregate tok/s under mixed admit/decode load
(port of scripts/bench_serving.py).

  python -m callireader_tpu_torch.scripts.bench_serving --preset callireader-2b --slots 8 \
      --requests 24 --max-new 128 [--paged] [--steps-per-sync 8] [--quant int8] \
      [--shared-prefix 64 --prefix-cache] [--mesh tensor=1] [--device cpu]

Drives the continuous batcher (runtime/serving.ContinuousBatcher, or with
``--paged`` runtime/paged_cache.PagedBatcher) the way cli/serve.py does,
text-only prompts so the number isolates the scheduler + decode path: a
warm-up wave of ``--slots`` requests at 4 tokens, then ``--requests``
requests with staggered ``max_new_tokens`` (``--max-new`` / 2 up to
``--max-new``), their ids drawn from numpy ``RandomState(0)`` in the JAX
script's order (``Workload``). Seeded random bf16 weights (the engine's
seed-0 LLM draw); ``--quant int8`` takes the engine's int8 layout
(cli/common.quantize_params: the vocabulary padded to 128, wqkv / w13
fused).
``--mesh``: tensor parallel over ``torch.distributed`` (a world of 1 on one
card, ``torchrun`` for more; parallel/spmd.py). Runs on the card unless
``--device cpu``. Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


class Workload:
    """The JAX script's request recipe: ``shared_ids`` drawn first, then each
    call of ``requests()`` draws every request's ids anew from the same
    stream -> [(uid, ids, max_new_tokens)]."""

    def __init__(self, requests: int, prompt_len: int, shared_prefix: int, max_new: int):
        import numpy as np

        self.np, self.n, self.prompt_len = np, requests, prompt_len
        self.shared, self.max_new = shared_prefix, max_new
        self.rng = np.random.RandomState(0)
        self.shared_ids = self.rng.randint(10, 90000, shared_prefix).astype(np.int32)

    def lengths(self):
        """Each request's max_new_tokens: staggered, so retirements and
        admissions stay interleaved."""
        return [self.max_new // 2 + (uid * self.max_new // 2) // max(1, self.n - 1)
                for uid in range(self.n)]

    def requests(self):
        np, out = self.np, []
        for uid, n in enumerate(self.lengths()):
            tail = self.prompt_len - self.shared
            ids = np.concatenate(
                [self.shared_ids, self.rng.randint(10, 90000, tail).astype(np.int32)]
            ) if self.shared else self.rng.randint(10, 90000, self.prompt_len).astype(np.int32)
            out.append((uid, ids, n))
        return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="callireader-2b")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--max-new", type=int, default=128)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--paged", action="store_true")
    p.add_argument("--steps-per-sync", type=int, default=1)
    p.add_argument("--mesh", type=str, default=None)
    p.add_argument("--prompt-len", type=int, default=96)
    p.add_argument("--quant", choices=[None, "int8"], default=None)
    # shared-prefix workload: every prompt starts with the same N tokens (a
    # system prompt / chat history); --prefix-cache registers its KV once so
    # requests prefill only their suffix (runtime/serving.register_prefix)
    p.add_argument("--shared-prefix", type=int, default=0)
    p.add_argument("--prefix-cache", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if args.prefix_cache and not args.shared_prefix:
        p.error("--prefix-cache needs --shared-prefix")
    if args.shared_prefix >= args.prompt_len:
        # >=: the prefix-hit path needs at least one suffix token
        p.error("--shared-prefix must be < --prompt-len")

    import torch

    from callireader_tpu_torch.cli.common import quantize_params
    from callireader_tpu_torch.core.config import get_config
    from callireader_tpu_torch.core.dtypes import require_device
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import weights
    from callireader_tpu_torch.runtime.engine import CalliReaderEngine
    from callireader_tpu_torch.runtime.serving import ContinuousBatcher, Request
    from callireader_tpu_torch.scripts import bench_common as bc

    dev = require_device(args.device)
    vlm = get_config(args.preset)
    mesh = None
    if args.mesh:
        from callireader_tpu_torch.cli.common import make_mesh

        mesh = make_mesh(args.mesh, dev)
    tree = {"llm": weights.draw_llm(vlm.llm, 0, device=dev)}
    if args.quant == "int8":  # the engine's int8 layout (the LM head's kernel too)
        tree, vlm = quantize_params(tree, vlm, "int8")
    if mesh is not None:  # this rank's blocks, as the engine shards them
        vlm, tree = CalliReaderEngine.shard_llm(vlm, tree, mesh)
    params, cfg = tree["llm"], vlm.llm

    def make_batcher():
        if args.paged:
            from callireader_tpu_torch.runtime.paged_cache import PagedBatcher

            pages = -(-args.max_len // 128)
            return PagedBatcher(
                params, cfg, num_slots=args.slots, num_pages=args.slots * pages + 1,
                page_size=128, max_pages_per_slot=pages, steps_per_sync=args.steps_per_sync,
                mesh=mesh,
            )
        return ContinuousBatcher(params, cfg, num_slots=args.slots, max_len=args.max_len,
                                 steps_per_sync=args.steps_per_sync, mesh=mesh)

    def embed(ids):
        with torch.inference_mode():
            e = internlm2.embed_tokens(params, torch.from_numpy(ids[None]).to(dev),
                                       torch.bfloat16, mesh, cfg)
        return e[0].float().cpu().numpy()

    work = Workload(args.requests, args.prompt_len, args.shared_prefix, args.max_new)
    shared_embeds = embed(work.shared_ids) if args.shared_prefix else None

    def reqs():
        return [Request(uid=uid, embeds=embed(ids), max_new_tokens=n, eos_token_ids=(-1,))
                for uid, ids, n in work.requests()]

    # warmup (captures the tick graphs on the card)
    b = make_batcher()
    if args.prefix_cache:
        b.register_prefix(shared_embeds)
    for r in reqs()[: args.slots]:
        r.max_new_tokens = 4
        b.submit(r)
    b.run()
    print("[bench_serving] warmup done", file=sys.stderr)

    b = make_batcher()
    if args.prefix_cache:
        b.register_prefix(shared_embeds)
    todo = reqs()
    bc.sync(dev)
    t0 = time.perf_counter()
    for r in todo:
        b.submit(r)
    done = b.run()
    bc.sync(dev)
    dt = time.perf_counter() - t0
    got = {r.uid: len(r.tokens or ()) for r in done}
    want = dict(enumerate(work.lengths()))
    if got != want:
        raise RuntimeError(f"requests finished at {got}, want their staggered lengths {want} "
                           f"(errors: {[r.error for r in done if r.error]})")
    toks = sum(got.values())
    out = {
        "metric": "serving_agg_tok_per_sec",
        "value": toks / dt,
        "unit": "tok/s",
        "requests": args.requests,
        "slots": args.slots,
        "paged": args.paged,
        "steps_per_sync": args.steps_per_sync,
        "quant": args.quant,
        "mesh": args.mesh,
        "total_tokens": toks,
        "seconds": dt,
        "shared_prefix": args.shared_prefix,
        "prefix_cache": args.prefix_cache,
        "prefix_hits": getattr(b, "prefix_hits", 0),
        "device": bc.device_line(dev),
        "platform": dev.type,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
