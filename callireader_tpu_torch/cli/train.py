"""e-IT training CLI (PyTorch port of callireader_tpu/cli/train.py).

  python -m callireader_tpu_torch.cli.train --data ann.jsonl --image-root DIR \
      --preset callireader-8b --random-init --config e_it --max-iters 2 --out OUT

Runs on the GPU unless ``--device cpu`` is given. The recipe (``--config``:
a name of the config zoo, or a .py file defining ``config()``) sets the flag
defaults from its hyperparameters, as the JAX CLI does; ``e_it``'s: LoRA
r=128 alpha=256 on the LLM's seven projections as fp32 masters (bf16 over an
int8 base with ``--qlora``), the projector trainable, the ViT and the LLM
frozen, AdamW at lr 5e-5 with 3% warmup and cosine decay, gradient clip 1,
batch 2 x accumulation 2, remat on. An iteration (logs, checkpoints, the
schedule) is one update of ``--grad-accum`` micro-batches; ``--resume``
continues from a checkpoint at its step and data position;
``--eval-chat-interval N`` answers ``--eval-chat-prompt`` (32 tokens,
text only) with the live adapters after every N-th update and prints it
(the reference's EvaluateChatHook).

Page images are ``.npy`` arrays of uint8 pixels (train/data.py). The base
comes from ``--checkpoint`` (a reference-layout InternVL directory, through
cli/common.build_engine) or, with ``--random-init``, from the seeded random
init. The run ends as the JAX CLI's does: the final ``save_train_state``,
then the merged params (LoRA folded in, an int8 QLoRA base dequantized first)
exported to the reference's safetensors layout in ``<out>/export_official``.

``--mesh data=2,fsdp=2`` (or a recipe's ``mesh`` / ``sequence_parallel_size``)
trains over a mesh, one process per rank (``torchrun --nproc-per-node N -m
callireader_tpu_torch.cli.train --mesh ...``; a world of 1 without
torchrun): each rank keeps its block of the trainable leaves and their
moments, runs its rows of each batch (its part of the sequence over "seq",
through Ulysses) and adds the grads over data, fsdp and seq
(train/e_it.py). Under torchrun without ``--mesh`` the default is the JAX
CLI's: "data" as large as the batch allows, the rest "fsdp". Rank 0 alone
logs, saves and exports (the state gathered whole).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys


def _load_recipe(name_or_path: str) -> dict:
    if name_or_path.endswith(".py") or os.path.sep in name_or_path:
        import importlib.util

        spec = importlib.util.spec_from_file_location("_recipe", name_or_path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.config()
    from callireader_tpu_torch.configs import get_config as get_recipe

    return get_recipe(name_or_path)


def main(argv=None):
    parser = argparse.ArgumentParser(description="e-IT training")
    parser.add_argument("--data", type=str, required=True, help="annotation json/jsonl")
    parser.add_argument("--image-root", type=str, default="")
    parser.add_argument("--out", type=str, default="./work_dir")
    parser.add_argument("--preset", type=str, default="callireader-8b")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="InternVL checkpoint directory (reference layout)")
    parser.add_argument("--random-init", action="store_true")
    parser.add_argument("--resume", type=str, default=None)
    parser.add_argument("--batch-size", type=int, default=2)
    parser.add_argument("--grad-accum", type=int, default=2)
    parser.add_argument("--epochs", type=float, default=1.0)
    parser.add_argument("--max-iters", type=int, default=None)
    parser.add_argument("--lr", type=float, default=5e-5)
    parser.add_argument("--lora-rank", type=int, default=128)
    parser.add_argument("--lora-alpha", type=float, default=256.0)
    parser.add_argument("--qlora", action="store_true",
                        help="quantize the frozen LLM base to int8 (weight-only) under bf16 "
                        "LoRA adapters")
    parser.add_argument("--log-interval", type=int, default=10)
    parser.add_argument("--ckpt-interval", type=int, default=1500)
    parser.add_argument("--eval-chat-interval", type=int, default=0,
                        help="generate a sample completion every N iters (0=off)")
    parser.add_argument("--eval-chat-prompt", type=str, default="读出图中所有文字。")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--check-data", action="store_true",
                        help="print a decoded dataset sample and exit")
    parser.add_argument("--config", type=str, default=None,
                        help="recipe name from the config zoo (list-cfg) or a .py file defining "
                        "config(); sets flag defaults")
    parser.add_argument("--mesh", type=str, default=None,
                        help='SPMD train mesh, e.g. "data=2,fsdp=2" or "data=2,seq=4" (one '
                        'process per rank under torchrun)')
    parser.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    pre, _ = parser.parse_known_args(argv)
    if pre.config:
        recipe = _load_recipe(pre.config)
        key_map = {
            "preset": "preset", "batch_size": "batch_size",
            "accumulative_counts": "grad_accum", "lr": "lr",
            "lora_rank": "lora_rank", "lora_alpha": "lora_alpha",
            "max_epochs": "epochs", "save_steps": "ckpt_interval",
            "quant_base": "qlora", "mesh": "mesh",
        }
        parser.set_defaults(**{key_map[k]: v for k, v in recipe.items() if k in key_map})
    args = parser.parse_args(argv)
    sp = int(recipe.get("sequence_parallel_size", 1)) if pre.config else 1
    if sp > 1 and "seq=" not in (args.mesh or ""):
        args.mesh = f"{args.mesh},seq={sp}" if args.mesh else f"seq={sp}"

    import torch

    from callireader_tpu_torch.cli.common import build_engine
    from callireader_tpu_torch.train import checkpoint as ckpt_mod
    from callireader_tpu_torch.train import data as data_mod
    from callireader_tpu_torch.train import e_it, lora
    from callireader_tpu_torch.utils.profiling import Spans, TrainThroughput

    try:
        engine = build_engine(preset=args.preset, checkpoint_dir=args.checkpoint,
                              random_init_ok=args.random_init, device_tile_pages=False,
                              device=args.device)
    except FileNotFoundError as e:
        parser.error(str(e))
    os.makedirs(args.out, exist_ok=True)
    cfg, tok, dev = engine.cfg, engine.tok, engine.device
    print(f"[train] device: {dev}", file=sys.stderr)

    dataset = data_mod.EITDataset(args.data, cfg, tok, image_root=args.image_root)
    if args.check_data:
        sample = dataset[0]
        ids = sample["input_ids"]
        print(f"[check-data] {len(dataset)} samples; sample 0: {len(ids)} tokens", file=sys.stderr)
        print(f"[check-data] decoded: {tok.decode(ids.tolist(), skip_special_tokens=False)[:800]!r}",
              file=sys.stderr)
        sup = sample["labels"][sample["labels"] != e_it.IGNORE_INDEX]
        print(f"[check-data] supervised tokens: {len(sup)} -> {tok.decode(sup.tolist())[:200]!r}",
              file=sys.stderr)
        if "pixel_values" in sample:
            print(f"[check-data] pixel tiles: {sample['pixel_values'].shape}", file=sys.stderr)
        if "pseudo_embeds" in sample:
            print(f"[check-data] pseudo embeds: {sample['pseudo_embeds'].shape}", file=sys.stderr)
        return
    mesh = _train_mesh(args, dev)
    accum = max(1, args.grad_accum)
    steps_per_epoch = max(1, len(dataset) // (args.batch_size * accum))
    total_steps = args.max_iters or int(steps_per_epoch * args.epochs)

    train_cfg = e_it.TrainConfig(
        learning_rate=args.lr,
        total_steps=total_steps,
        lora_rank=args.lora_rank,
        lora_alpha=args.lora_alpha,
        grad_accum=accum,
    )

    params = engine.params
    params["llm"] = lora.add_lora(
        params["llm"], cfg.llm, torch.Generator(device=dev).manual_seed(args.seed),
        rank=train_cfg.lora_rank, alpha=train_cfg.lora_alpha,
        # QLoRA trains bf16 adapters over the int8 base; full-precision runs
        # keep fp32 masters
        dtype=torch.bfloat16 if args.qlora else torch.float32,
    )
    if args.qlora:
        from callireader_tpu_torch.runtime import quantize as quant_mod

        before = quant_mod.param_bytes(params["llm"])
        # the adapters stay bf16 (they carry the grads); the base projections
        # and vocab tables drop to int8, and _proj dispatches on the *_q leaves
        params["llm"] = quant_mod.quantize_llm_int8(params["llm"])
        # the e-IT step reads only ViT + projector + LLM: drop the
        # inference-only components
        for name in ("align", "detector", "orderformer"):
            params.pop(name, None)
        engine.detector = None
        print(f"[train] qlora: int8 base {before / 1e9:.2f} -> "
              f"{quant_mod.param_bytes(params['llm']) / 1e9:.2f} GB; inference-only components "
              f"dropped from the train state", file=sys.stderr)
    engine.params = params

    axes = None
    if mesh is not None:
        from callireader_tpu_torch.parallel import spmd

        axes = spmd.engine_logical_axes(cfg, params)
    state, frozen, tx = e_it.create_train_state(params, train_cfg, mesh, axes)
    main_rank = mesh is None or spmd.is_main()
    if args.resume:
        whole = e_it.gather_state(state)
        state = e_it.shard_state(ckpt_mod.restore_train_state(args.resume, whole), state)
        # the seed from the checkpoint, so the data shuffle continues the same stream
        meta_path = os.path.join(args.resume, "metadata.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                saved = json.load(f)
            if "seed" in saved and saved["seed"] != args.seed:
                print(f"[train] seed restored from checkpoint: {saved['seed']}", file=sys.stderr)
                args.seed = int(saved["seed"])
        print(f"[train] resumed from {args.resume} at step {state.step}", file=sys.stderr)

    step_fn = e_it.make_train_step(cfg, train_cfg, tx, policy=engine.policy, mesh=mesh)
    spans = Spans()
    thr = TrainThroughput()
    loader = data_mod.data_loader(dataset, args.batch_size, shuffle_seed=args.seed)
    # state.step counts micro-batches; an iteration is one update of `accum`
    it = state.step
    micro_per_epoch = max(1, data_mod.batches_per_epoch(len(dataset), args.batch_size))
    if args.resume and it:
        # fast-forward the shuffled stream past the consumed batches; the main
        # loop reseeds an exhausted loader with seed + it at each epoch boundary
        epoch = it // micro_per_epoch
        skip = it % micro_per_epoch
        epoch_seed = args.seed if epoch == 0 else args.seed + epoch * micro_per_epoch
        loader = data_mod.data_loader(dataset, args.batch_size, shuffle_seed=epoch_seed)
        for _ in range(skip):
            next(loader)
        if skip or epoch:
            print(f"[train] data loader fast-forwarded to epoch {epoch}, batch {skip}",
                  file=sys.stderr)
    micro_total = total_steps * accum
    last_ckpt = None
    log_path = os.path.join(args.out, "train_log.jsonl")

    while it < micro_total:
        try:
            batch = next(loader)
        except StopIteration:
            loader = data_mod.data_loader(dataset, args.batch_size, shuffle_seed=args.seed + it)
            batch = next(loader)
        batch = data_mod.to_device(batch, dev)
        with spans.span("step"):
            state, metrics = step_fn(state, frozen, batch)
            n_tok = int(metrics["n_tokens"])  # waits for the step
        it = state.step
        stats = thr.step(n_tok)
        if it % accum:
            continue  # mid-accumulation micro-batch: no update happened
        upd = it // accum
        if upd % args.log_interval == 0 and main_rank:
            rec = {
                "iter": upd,
                "loss": float(metrics["loss"]),
                "grad_norm": float(metrics["grad_norm"]),
                **{k: round(v, 2) for k, v in stats.items()},
            }
            print(f"[train] {json.dumps(rec)}", file=sys.stderr)
            with open(log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if args.ckpt_interval and upd % args.ckpt_interval == 0:
            path = os.path.join(args.out, f"iter_{upd}")
            whole = e_it.gather_state(state)
            if main_rank:
                ckpt_mod.save_train_state(path, whole, metadata={"iter": upd, "seed": args.seed})
                if last_ckpt and os.path.exists(last_ckpt):
                    shutil.rmtree(last_ckpt)  # keep one
            del whole
            last_ckpt = path
        if args.eval_chat_interval and upd % args.eval_chat_interval == 0:
            # the live tree: the decode reads the adapters the optimizer
            # updates in place (a decode graph of the first chat replays
            # with the later values)
            engine.params = e_it.merge_params(e_it.gather_state(state).trainable, frozen)
            resp = engine.chat(None, args.eval_chat_prompt, max_new_tokens=32)
            if main_rank:
                print(f"[eval-chat @{upd}] {resp!r}", file=sys.stderr)

    # final save + deployable export
    final = os.path.join(args.out, "final")
    state = e_it.gather_state(state)
    if not main_rank:
        return
    ckpt_mod.save_train_state(final, state, metadata={"iter": it // accum, "seed": args.seed})
    merged = e_it.merge_params(state.trainable, frozen)
    # drop the optimizer moments before the export: the merged LLM and the
    # fp32 staging of each tensor take their room
    state = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        print(f"[train] device memory before export: {torch.cuda.memory_allocated() / 1e9:.2f} "
              f"GB in use", file=sys.stderr)
    export_dir = os.path.join(args.out, "export_official")
    ckpt_mod.export_reference_format(merged, cfg, export_dir)
    print(f"[train] done: {it // accum} iters ({it} micro-batches); train state at {final}, "
          f"export at {export_dir}", file=sys.stderr)
    print(spans.report(), file=sys.stderr)


def _train_mesh(args, dev):
    """``--mesh`` (the recipe's), or under torchrun the JAX CLI's default
    (data = gcd(world, batch), the rest fsdp); None for one process without
    a mesh."""
    import math

    from callireader_tpu_torch.cli.common import make_mesh

    spec = args.mesh
    world = int(os.environ.get("WORLD_SIZE", 1))
    if spec is None and world > 1:
        data = math.gcd(world, args.batch_size)
        spec = f"data={data},fsdp={world // data},tensor=1,seq=1"
    if spec is None:
        return None
    mesh = make_mesh(spec, dev)
    print(f"[train] mesh: {mesh.shape}", file=sys.stderr)
    return mesh


if __name__ == "__main__":
    main()
