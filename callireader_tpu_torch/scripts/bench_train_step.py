"""Train-step throughput evidence: e-IT step time and tokens/sec (port of
scripts/bench_train_step.py).

  python -m callireader_tpu_torch.scripts.bench_train_step --preset callireader-2b --batch 2 \
      --seq 2048 [--lora-rank 128] [--tiles-per-sample 1] [--mesh data=1,fsdp=1,tensor=1] \
      [--device cpu]

Runs the e-IT train step (train/e_it.make_train_step: LoRA on the LLM's
seven projections over the frozen towers, the e-IT recipe's remat) on a
synthetic batch and prints ONE JSON line: seconds a step, tokens/s and
model TFLOP/s (``step_flops``: the step's own products). The towers and the LLM
are the engine's seed-0 draws (runtime/weights.init_params, the components
the step reads); ids, labels and pixels from numpy ``RandomState(0)`` in the
JAX script's order. ``--mesh``: the step over ``torch.distributed`` (a world
of 1 on one card, ``torchrun`` for more); under ``torchrun`` without it, the
JAX script's default mesh (fsdp over every rank). Runs on the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def step_flops(cfg, B: int, S: int, tiles: int, rank: int) -> float:
    """Model operations of one step on the synthetic batch (one causal
    segment a row): the LLM's products and the LM head forward and their
    input gradients through the frozen base (2x the forward); attention over
    the causal pairs (the forward, and the backward's five products: 10/4 of
    it); the LoRA products with their input and weight gradients (3x); the
    frozen tile tower's forward; the projector's forward and weight gradient.
    The recompute of remat is not counted."""
    llm, v = cfg.llm, cfg.vision
    E, D, L = llm.hidden_size, llm.head_dim, llm.num_hidden_layers
    q, kv, inner = llm.num_attention_heads * D, llm.num_key_value_heads * D, llm.intermediate_size
    shapes = {"wq": (E, q), "wk": (E, kv), "wv": (E, kv), "wo": (q, E),
              "w1": (E, inner), "w3": (E, inner), "w2": (inner, E)}
    n = B * S
    base = 2 * (2.0 * n * (L * sum(a * b for a, b in shapes.values()) + E * llm.vocab_size))
    attention = (1 + 10 / 4) * 4.0 * L * B * S * (S + 1) / 2 * q
    lora = 3 * 2.0 * n * L * rank * sum(a + b for a, b in shapes.values())
    Ev, t = v.hidden_size, (v.image_size // v.patch_size) ** 2 + 1
    tower = tiles * v.num_hidden_layers * (2.0 * t * (4 * Ev * Ev + 2 * Ev * v.intermediate_size)
                                           + 4.0 * t * t * Ev)
    projector = 2 * 2.0 * tiles * cfg.num_image_token * (4 * Ev * E + E * E)
    return base + attention + lora + tower + projector


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="callireader-2b")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq", type=int, default=2048)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--lora-rank", type=int, default=128)
    p.add_argument("--mesh", type=str, default=None)
    p.add_argument("--tiles-per-sample", type=int, default=1)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from callireader_tpu_torch.core.config import get_config
    from callireader_tpu_torch.core.dtypes import require_device
    from callireader_tpu_torch.runtime import weights
    from callireader_tpu_torch.scripts import bench_common as bc
    from callireader_tpu_torch.train import e_it, lora

    dev = require_device(args.device)
    cfg = get_config(args.preset)
    world = int(os.environ.get("WORLD_SIZE", 1))
    spec = args.mesh or (f"data=1,fsdp={world},tensor=1,seq=1" if world > 1 else None)
    mesh = None
    if spec:
        from callireader_tpu_torch.cli.common import make_mesh

        mesh = make_mesh(spec, dev)
    params = {
        "llm": weights.draw_llm(cfg.llm, 0, device=dev),
        "vision": weights.draw_vision(cfg.vision, 0, device=dev),
        "projector": weights.draw_projector(cfg, 0, device=dev),
    }
    tc = e_it.TrainConfig(lora_rank=args.lora_rank, lora_alpha=2.0 * args.lora_rank,
                          total_steps=100)
    params["llm"] = lora.add_lora(params["llm"], cfg.llm, torch.Generator(device=dev).manual_seed(1),
                                  rank=tc.lora_rank, alpha=tc.lora_alpha, dtype=torch.float32)
    axes = None
    if mesh is not None:
        from callireader_tpu_torch.parallel import spmd

        axes = spmd.engine_logical_axes(cfg, params)
    state, frozen, tx = e_it.create_train_state(params, tc, mesh, axes)
    step = e_it.make_train_step(cfg, tc, tx, mesh=mesh)

    B, S = args.batch, args.seq
    rng = np.random.RandomState(0)
    ids = rng.randint(10, 90000, (B, S)).astype(np.int32)
    nit = cfg.num_image_token * args.tiles_per_sample
    for b in range(B):
        ids[b, 4: 4 + nit] = cfg.img_context_token_id
    labels = np.where(np.arange(S)[None] > S // 2, ids, e_it.IGNORE_INDEX).astype(np.int32)
    host = {
        "input_ids": ids,
        "labels": labels,
        "segment_ids": np.zeros((B, S), np.int32),
        "positions": np.tile(np.arange(S, dtype=np.int32)[None], (B, 1)),
        "pixel_values": rng.rand(
            B * args.tiles_per_sample, cfg.force_image_size, cfg.force_image_size, 3
        ).astype(np.float32),
    }
    # the whole batch on the device (under a mesh the step takes this rank's rows)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}

    state, m = step(state, frozen, batch)
    float(m["loss"])  # sync
    print("[bench_train] warmup done", file=sys.stderr)
    t0 = time.perf_counter()
    for _ in range(args.iters):
        state, m = step(state, frozen, batch)
    loss = float(m["loss"])  # sync
    dt = (time.perf_counter() - t0) / args.iters
    tps = B * S / dt
    shape = dict(mesh.shape) if mesh is not None else {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1}
    out = {
        "metric": "eit_train_step_sec",
        "value": dt,
        "unit": "s/step",
        "tokens_per_sec": tps,
        "batch": B, "seq": S, "mesh": shape,
        "model_tflops_per_sec": (step_flops(cfg, B, S, B * args.tiles_per_sample, args.lora_rank)
                                 / dt / 1e12),
        "loss": loss,
        "device": bc.device_line(dev),
        "platform": dev.type,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
