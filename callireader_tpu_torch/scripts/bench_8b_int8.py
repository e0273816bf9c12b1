"""Single-card 8B proof: the int8 weight-only flagship decode on one card
(port of scripts/bench_8b_int8.py).

  python -m callireader_tpu_torch.scripts.bench_8b_int8 [--batch 4 --prompt 1024 --tokens 32] \
      [--device cpu]

Builds the 8B's int8 LLM from the JAX script's host draws (``host_draws``:
numpy ``RandomState(0)``, N(0, 0.02) in float32, one layer of each stacked
leaf drawn and tiled over the layers, ``_quant_rows``' per-out-channel
absmax int8, the fused wqkv / w13 layout, the vocabulary padded to 128),
ships only int8 + scales, materialised on the device as real (L, K, N)
tensors (never an expanded view: ``params_gb_int8`` is the device's true
footprint), then runs prefill + the graphed decode (the int8 products,
the LM head, the prefill and decode attention and the RMSNorm on their
kernels on the card) and prints ONE JSON line: the marginal ms a decode step
as d(total)/d(tokens), the footprint, and ``fits_single_chip``: the peak
allocated during the run against the card's memory, measured (None on the
CPU). Runs on the card unless ``--device cpu``.

``main(num_layers=..., cfg=..., draws=...)`` (keywords, no flags) runs
another depth, another LLM config, or draws made ahead by ``host_draws``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

LAYER_LEAVES = ("wqkv", "wo", "w13", "w2")
VOCAB_LEAVES = ("tok_embeddings", "output")


def _quant_rows(w, axis_keepdim):
    """Symmetric absmax int8 with scales along all dims but the last (the
    JAX script's own, scripts/bench_8b_int8.py)."""
    import numpy as np

    absmax = np.max(np.abs(w), axis=axis_keepdim, keepdims=True)
    scale = np.maximum(absmax, 1e-8) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def leaf_shapes(cfg):
    """{name: shape} in the JAX script's draw order: the stacked layer
    leaves (L, in, out), then the vocab tables (V, E)."""
    L, E, M = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, D = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    return {"wqkv": (L, E, (Hq + 2 * Hkv) * D), "wo": (L, Hq * D, E), "w13": (L, E, 2 * M),
            "w2": (L, M, E), "tok_embeddings": (cfg.vocab_size, E), "output": (cfg.vocab_size, E)}


def host_draws(cfg, rng=None):
    """The JAX script's ``ship`` draws on the host -> ({name: (q, scale)},
    the RandomState after them, which draws the prompt next). A stacked
    leaf's one layer (in, out) is drawn and quantized (scales (1, out)); the
    vocab tables whole (scales (V, 1)). The layer count does not enter."""
    import numpy as np

    rng = np.random.RandomState(0) if rng is None else rng
    out = {}
    for name, shape in leaf_shapes(cfg).items():
        if len(shape) == 3:
            w = rng.standard_normal(shape[1:]).astype(np.float32) * 0.02
            out[name] = _quant_rows(w, 0)
        else:
            w = rng.standard_normal(shape).astype(np.float32) * 0.02
            out[name] = _quant_rows(w, 1)
        del w
        print(f"[8b-int8] drew {name} {shape}", file=sys.stderr)
    return out, rng


def build_params(host, cfg, dev, num_layers: int):
    """The int8 tree on ``dev`` from ``host_draws``' leaves: each stacked
    leaf a real (L, K, N) tensor (its one drawn layer copied into every
    layer), the fused wqkv / w13 layout, the vocabulary padded to 128 ->
    (params, cfg at ``num_layers`` layers)."""
    import torch

    from callireader_tpu_torch.models import internlm2

    L, E = num_layers, cfg.hidden_size
    cfg = dataclasses.replace(cfg, num_hidden_layers=L)
    layers = {"attn_norm": torch.ones((L, E), dtype=torch.bfloat16, device=dev),
              "ffn_norm": torch.ones((L, E), dtype=torch.bfloat16, device=dev)}
    for name in LAYER_LEAVES:
        for suffix, a in zip(("_q", "_scale"), host[name]):
            one = torch.from_numpy(a).to(dev)
            stack = torch.empty((L,) + tuple(one.shape), dtype=one.dtype, device=dev)
            stack.copy_(one.expand_as(stack))
            layers[name + suffix] = stack
            del one
    params = {"layers": layers, "norm": torch.ones((E,), dtype=torch.bfloat16, device=dev)}
    for name in VOCAB_LEAVES:
        q, s = host[name]
        params[f"{name}_q"] = torch.from_numpy(q).to(dev)
        params[f"{name}_scale"] = torch.from_numpy(s).to(dev)
    # 128-pad the vocab tables so the LM head's kernel takes them
    return internlm2.pad_vocab(params, cfg, 128)


def main(argv=None, *, num_layers=None, cfg=None, draws=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--prompt", type=int, default=1024)
    p.add_argument("--tokens", type=int, default=32)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from callireader_tpu_torch.core.config import callireader_8b
    from callireader_tpu_torch.core.dtypes import require_device
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import generate as gen
    from callireader_tpu_torch.runtime.quantize import param_bytes
    from callireader_tpu_torch.scripts import bench_common as bc

    dev = require_device(args.device)
    cfg = cfg or callireader_8b().llm
    L = num_layers or cfg.num_hidden_layers
    B, S, T = args.batch, args.prompt, args.tokens
    short = max(8, T // 4)
    if T <= short:
        p.error(f"--tokens must exceed {short}: the marginal step is d(total)/d(tokens)")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    t0 = time.perf_counter()
    host, rng = draws if draws is not None else host_draws(cfg)
    drawn_s = time.perf_counter() - t0
    params, cfg = build_params(host, cfg, dev, L)
    bc.sync(dev)
    n_bytes = param_bytes(params)
    print(f"[8b-int8] params on the device: {n_bytes / 1e9:.3f} GB, {L} layers (drawn in "
          f"{drawn_s:.1f} s, shipped in {time.perf_counter() - t0 - drawn_s:.1f} s)",
          file=sys.stderr)

    ids = rng.randint(10, 90000, (B, S)).astype(np.int32)
    with torch.inference_mode():
        embeds = internlm2.embed_tokens(params, torch.from_numpy(ids).to(dev), torch.bfloat16)
    mask = torch.ones((B, S), dtype=torch.int32, device=dev)

    def timed(tokens):
        g = gen.GenerateConfig(max_new_tokens=tokens, eos_token_ids=(-1,))
        t0 = time.perf_counter()
        _, lens = gen.generate_from_embeds(params, cfg, embeds, mask, gen_cfg=g,
                                           max_cache_len=S + T)
        lens = lens.cpu()  # the sync
        if not bool((lens == tokens).all()):  # proves the full path ran
            raise RuntimeError(f"generated lengths {lens.tolist()}, want {tokens} each")
        return time.perf_counter() - t0

    timed(T)
    print("[8b-int8] warmup decode done", file=sys.stderr)
    # marginal decode step = d(total)/d(tokens): subtracts the prefill AND
    # the fixed dispatch/readback overhead that (total/T) folds in
    t_short = timed(short)
    _ = timed(short)  # the short variant's graphs captured before timing
    t_short = timed(short)
    total = timed(T)
    marginal = (total - t_short) / (T - short)
    kv_bytes = L * B * cfg.num_key_value_heads * (S + T) * cfg.head_dim * 2 * 2
    fits = None
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        card = torch.cuda.get_device_properties(dev).total_memory
        fits = peak <= card
        print(f"[8b-int8] peak allocated {peak / 2**30:.2f} GiB of the card's "
              f"{card / 2**30:.2f} GiB", file=sys.stderr)
    out = {
        "metric": "8b_int8_single_chip_decode_ms_per_step",
        "value": marginal * 1e3,  # pure decode step
        "unit": "ms",
        "ms_per_tok_incl_prefill": total / T * 1e3,
        "total_sec_prefill_plus_decode": total,
        "params_gb_int8": n_bytes / 1e9,
        "kv_gb": kv_bytes / 1e9,
        "batch": B, "prompt": S, "tokens": T,
        "fits_single_chip": fits,
        "device": bc.device_line(dev),
        "platform": dev.type,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
