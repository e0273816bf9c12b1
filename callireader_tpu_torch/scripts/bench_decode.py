"""Decode-loop speed evidence: ms/token-step for the generate loop (port of
scripts/bench_decode.py).

  python -m callireader_tpu_torch.scripts.bench_decode --preset callireader-2b --batch 8 \
      --prompt 4096 --tokens 64 [--use-flash 0|1] [--device cpu]

Separates prefill time (``internlm2.prefill`` alone) from per-step decode
time (``generate_from_embeds``: the prefill, then the decode chunks replayed
as CUDA graphs on the card) so regressions against the HBM roofline (weight
bytes + KV bytes per step, at the H100's 3.35 TB/s) are visible. Seeded
random bf16 weights (the engine's seed-0 LLM draw), prompt ids from numpy
``RandomState(0)`` as the JAX script draws them. ``--use-flash``: default
the kernels on the card and the plain versions on the CPU; 0 swaps the
attention kernels for their plain versions on the card too. Runs on the card
unless ``--device cpu``. Prints ONE JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Iterator


@contextlib.contextmanager
def attention_route(use_flash: bool, dev) -> Iterator[None]:
    """``use_flash``: the prefill and decode attention kernels (on the card;
    the CPU has none, so asking for them there raises). Otherwise their plain
    versions on either device, swapped in behind the wrappers while active."""
    from callireader_tpu_torch.kernels import attention as k_attn
    from callireader_tpu_torch.kernels import decode_attention as k_dec

    if use_flash:
        if dev.type != "cuda":
            raise ValueError("the attention kernels run on the card: --use-flash 1 needs it")
        yield
        return
    launches = (k_attn._launch, k_dec._launch)
    k_attn._launch = lambda q, k, v, causal, qs, ks, scale, q_offset: k_attn.attention_reference(
        q, k, v, causal=causal, q_segment_ids=qs, kv_segment_ids=ks, scale=scale,
        q_offset=q_offset)
    k_dec._launch = lambda q, ck, cv, layer, valid, scale: k_dec.flash_decode_reference(
        q, ck, cv, layer, valid, scale=scale)
    try:
        yield
    finally:
        k_attn._launch, k_dec._launch = launches


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="callireader-2b")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--prompt", type=int, default=4096)
    p.add_argument("--tokens", type=int, default=64)
    p.add_argument("--use-flash", type=int, default=None)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from callireader_tpu_torch.core.config import get_config
    from callireader_tpu_torch.core.dtypes import require_device
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import generate as gen
    from callireader_tpu_torch.runtime import weights
    from callireader_tpu_torch.scripts import bench_common as bc
    from callireader_tpu_torch.train.e_it import flatten

    dev = require_device(args.device)
    cfg = get_config(args.preset).llm
    use_flash = bool(args.use_flash) if args.use_flash is not None else dev.type == "cuda"
    params = weights.draw_llm(cfg, 0, device=dev)

    B, S, T = args.batch, args.prompt, args.tokens
    max_cache = S + T
    rng = np.random.RandomState(0)
    ids = rng.randint(10, 90000, (B, S)).astype(np.int32)
    with torch.inference_mode(), attention_route(use_flash, dev):
        embeds = internlm2.embed_tokens(params, torch.from_numpy(ids).to(dev), torch.bfloat16)
        mask = torch.ones((B, S), dtype=torch.int32, device=dev)

        def prefill():
            logits, _ = internlm2.prefill(params, cfg, inputs_embeds=embeds,
                                          attention_mask=mask, max_len=max_cache)
            bc.sync(dev)
            return logits

        prefill()  # warm
        t0 = time.perf_counter()
        prefill()
        prefill_s = time.perf_counter() - t0

        # full generate (prefill + the decode steps)
        gcfg = gen.GenerateConfig(max_new_tokens=T, eos_token_ids=(-1,))

        def generate():
            _, lengths = gen.generate_from_embeds(params, cfg, embeds, mask, gen_cfg=gcfg,
                                                  max_cache_len=max_cache)
            bc.sync(dev)
            return lengths

        generate()  # warm: captures the decode graphs on the card
        t0 = time.perf_counter()
        lengths = generate()
        total_s = time.perf_counter() - t0
    if not bool((lengths.cpu() == T).all()):
        raise RuntimeError(f"generated lengths {lengths.tolist()}, want {T} each")
    per_step_ms = (total_s - prefill_s) / T * 1e3

    # rooflines (bf16): weight bytes + KV bytes per decode step
    n_params = sum(x.numel() for x in flatten(params).values())
    kv_bytes = (cfg.num_hidden_layers * B * cfg.num_key_value_heads * max_cache
                * cfg.head_dim * 2 * 2)
    hbm_gb_per_step = (n_params * 2 + kv_bytes) / 1e9
    print(f"[bench_decode] prefill {prefill_s:.3f}s, total {total_s:.3f}s, "
          f"decode {per_step_ms:.3f} ms/step, ~{hbm_gb_per_step:.2f} GB/step read",
          file=sys.stderr)
    out = {
        "metric": "decode_ms_per_step",
        "value": per_step_ms,
        "unit": "ms",
        "prefill_sec": prefill_s,
        "batch": B, "prompt": S, "tokens": T,
        "params_b": n_params / 1e9,
        "hbm_gb_per_step": hbm_gb_per_step,
        "roofline_ms_at_3350gbps": hbm_gb_per_step * 1e9 / bc.HBM_BYTES_S * 1e3,
        "use_flash": use_flash,
        "device": bc.device_line(dev),
        "platform": dev.type,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
