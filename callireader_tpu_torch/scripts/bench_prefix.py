"""Prefix-cache prefill speedup: full-prompt prefill vs chunked suffix prefill
(port of scripts/bench_prefix.py).

  python -m callireader_tpu_torch.scripts.bench_prefix --preset callireader-2b --rows 8 \
      --prompt 4096 --prefix 3584 [--iters 5] [--device cpu]

Times the two admission programs the ContinuousBatcher dispatches for a wave
of ``rows`` requests whose prompts share a ``prefix``-token registered prefix
(runtime/serving.register_prefix): the full (rows, prompt) ``prefill`` vs the
chunked (rows, prompt - prefix) ``prefill_with_prefix`` over the prefix's
cached KV. This is the per-wave admission latency (TTFT share) the cache
removes; the decode path is untouched. Both must give the same last-position
logits: the chunked ones are held within ``LOGITS_REL_TOL`` relative L2 of
the full prefill's, or the run fails. Seeded random bf16 weights (the
engine's seed-0 LLM draw), ids from numpy ``RandomState(0)``. Runs on the
card unless ``--device cpu``. Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

# the model bound: logits through the kernels against another route
LOGITS_REL_TOL = 5e-2


def main(argv=None, *, checks=None):
    """``checks``: a dict that receives the run's ``logits_rel_err``."""
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="callireader-2b")
    p.add_argument("--rows", type=int, default=8)
    p.add_argument("--prompt", type=int, default=4096)
    p.add_argument("--prefix", type=int, default=3584)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)
    if not 0 < args.prefix < args.prompt:
        p.error("need 0 < --prefix < --prompt")

    import numpy as np
    import torch

    from callireader_tpu_torch.core.config import get_config
    from callireader_tpu_torch.core.dtypes import require_device
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import weights
    from callireader_tpu_torch.scripts import bench_common as bc

    dev = require_device(args.device)
    cfg = get_config(args.preset).llm
    params = weights.draw_llm(cfg, 0, device=dev)
    rng = np.random.RandomState(0)
    ids = rng.randint(10, 90000, (args.rows, args.prompt)).astype(np.int32)
    ids[:, : args.prefix] = ids[0, : args.prefix]  # shared prefix
    max_len = args.prompt + 128

    def ones(e):
        return torch.ones(e.shape[:2], dtype=torch.int32, device=dev)

    def timed(fn):
        out = fn()  # warm
        bc.sync(dev)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn()
        bc.sync(dev)
        return (time.perf_counter() - t0) / args.iters, out

    with torch.inference_mode():
        embeds = internlm2.embed_tokens(params, torch.from_numpy(ids).to(dev), torch.bfloat16)
        t_full, (full_logits, _) = timed(lambda: internlm2.prefill(
            params, cfg, inputs_embeds=embeds, attention_mask=ones(embeds), max_len=max_len))
        head = embeds[:1, : args.prefix]
        _, pc = internlm2.prefill(params, cfg, inputs_embeds=head, attention_mask=ones(head),
                                  max_len=args.prefix)
        pk, pv = pc.k[:, 0], pc.v[:, 0]
        tail = embeds[:, args.prefix:]
        t_chunk, (chunk_logits, _) = timed(lambda: internlm2.prefill_with_prefix(
            params, cfg, inputs_embeds=tail, attention_mask=ones(tail), prefix_k=pk,
            prefix_v=pv, max_len=max_len))
        rel = float((chunk_logits.float() - full_logits.float()).norm()
                    / full_logits.float().norm())
    if checks is not None:
        checks["logits_rel_err"] = rel
    print(f"[bench_prefix] last-position logits, chunked against full: rel err {rel:.3e} "
          f"(bound {LOGITS_REL_TOL})", file=sys.stderr)
    if not rel <= LOGITS_REL_TOL:
        raise RuntimeError(f"the chunked prefill's logits are {rel:.3e} rel off the full "
                           f"prefill's (bound {LOGITS_REL_TOL})")

    out = {
        "metric": "prefix_cache_prefill_speedup",
        "value": t_full / t_chunk,
        "unit": "x",
        "full_prefill_s": t_full,
        "chunked_prefill_s": t_chunk,
        "rows": args.rows,
        "prompt": args.prompt,
        "prefix": args.prefix,
        "preset": args.preset,
        "platform": dev.type,
        "device": bc.device_line(dev),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
