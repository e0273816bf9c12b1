"""Engine construction shared by the CLIs (PyTorch port of
callireader_tpu/cli/common.py).

``checkpoint_dir``: a deployed reference checkpoint (safetensors shards and
their index, the side files found under ``params/`` or beside them, or given
as ``mu_sigma_path`` / ``orderformer_path``) converted by
runtime/weights.convert_reference_checkpoint into bf16 on the device; the
components it lacks (detector, OrderFormer, resampler, align) come from the
port's seed-0 init and are named on stderr. Without a checkpoint,
``random_init_ok`` must be set: the engine draws seeded random weights
(seed 0). ``trained_assets`` overlays the committed detector, OrderFormer
and compact CalliAlign tower on the components drawn at random (the
CalliAlign tower only where the resampler was), where the preset's
architecture matches them; a component the checkpoint holds is never
replaced. ``adapter_path`` serves an e-IT checkpoint written by
``cli.train`` on whichever base was built: the LoRA leaves are attached,
the trainable subtree (LoRA + projector) is restored from the checkpoint and
the adapters are merged into the dense weights. ``quant="int8"`` then
quantizes the LLM (weight-only int8, vocab padded to 128, fused wqkv / w13),
in the JAX CLI's order; ``"int8-all"`` adds the W8A8 tile tower. A random
base without an adapter is drawn as int8 directly. ``gray_chars`` and
``device_resize_chars`` (default on: luma crops resized on the device),
``device_tile_pages`` (default on) and ``char_canvas`` go to the engine, with
the JAX build_engine's defaults.

``mesh_spec`` ("tensor=4,fsdp=2"; "data" takes the rest of the world): one
process per rank under ``torchrun`` (a world of 1 without it), NCCL on the
card and gloo with ``device="cpu"``; the engine runs its LLM tensor parallel
(runtime/engine.py) in the unfused int8 layout. A mesh whose size is not the
world's raises. Ranks other than 0 print nothing to stdout (``make_mesh``).
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

# the components a checkpoint may lack: they fall back to the seed-0 init
OPTIONAL_COMPONENTS = ("detector", "orderformer", "resampler", "align")


def merge_adapter(params, cfg, adapter_path: str, lora_rank: int, lora_alpha: float, device):
    """The e-IT checkpoint of cli.train merged onto ``params``: its LoRA
    leaves and projector restored, the adapters folded into the weights."""
    import torch

    from callireader_tpu_torch.train import checkpoint as ckpt_mod
    from callireader_tpu_torch.train import e_it, lora

    print(f"[engine] loading adapter from {adapter_path}", file=sys.stderr)
    params["llm"] = lora.add_lora(params["llm"], cfg.llm,
                                  torch.Generator(device=device).manual_seed(0),
                                  rank=lora_rank, alpha=lora_alpha, dtype=torch.float32)
    tc = e_it.TrainConfig(lora_rank=lora_rank, lora_alpha=lora_alpha)
    trainable, frozen = e_it.partition_params(params, tc)
    # the trainable subtree only: the optimizer's moments are not needed here
    state = ckpt_mod.restore_train_state(adapter_path, e_it.TrainState(trainable, {}, 0))
    params = e_it.merge_params(state.trainable, frozen)
    params["llm"] = lora.merge_lora(params["llm"])
    return params


def make_mesh(mesh_spec: str, device, fill: str = "data"):
    """The CLIs' mesh: the process group joined (torchrun's environment, or a
    world of 1), ``mesh_spec`` with ``fill`` taking the rest of the world;
    on ranks other than 0 stdout goes to the null device."""
    import torch
    import torch.distributed as dist

    from callireader_tpu_torch.parallel import spmd

    dev = torch.device(device)
    spmd.init_distributed(dev.type)
    shape = spmd.parse_mesh(mesh_spec, dist.get_world_size(), fill)
    mesh = spmd.make_mesh(shape, device=dev.type)
    if not spmd.is_main():
        sys.stdout = open(os.devnull, "w")
    print(f"[engine] SPMD mesh: {mesh.shape} over {dist.get_world_size()} ranks "
          f"({dist.get_backend()})", file=sys.stderr)
    return mesh


def quantize_params(params, cfg, quant: str):
    """The JAX build_engine's int8 order on a dense tree: quantize_llm_int8, the
    vocab padded to 128, the fused wqkv / w13 leaves (an engine under a mesh
    splits them again: runtime/engine.py); ``"int8-all"`` adds the W8A8 tile
    tower -> (params, cfg)."""
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import quantize

    before = quantize.param_bytes(params["llm"])
    params["llm"] = quantize.quantize_llm_int8(params["llm"])
    params["llm"], llm_cfg = internlm2.pad_vocab(params["llm"], cfg.llm, 128)
    cfg = dataclasses.replace(cfg, llm=llm_cfg)
    params["llm"] = quantize.fuse_llm_int8(params["llm"])
    print(f"[engine] int8 weight-only quantization: LLM {before / 1e9:.1f} GB -> "
          f"{quantize.param_bytes(params['llm']) / 1e9:.1f} GB", file=sys.stderr)
    if quant == "int8-all":
        params["vision"] = quantize.quantize_vit_int8(params["vision"])
    return params, cfg


def build_engine(
    *,
    preset: str = "callireader-8b",
    checkpoint_dir: Optional[str] = None,
    mu_sigma_path: Optional[str] = None,
    orderformer_path: Optional[str] = None,
    random_init_ok: bool = False,
    quant: Optional[str] = None,
    adapter_path: Optional[str] = None,
    lora_rank: int = 128,
    lora_alpha: float = 256.0,
    gray_chars: bool = True,
    device_resize_chars: bool = True,
    device_tile_pages: bool = True,
    char_canvas: Optional[int] = None,
    mesh_spec: Optional[str] = None,
    trained_assets: bool = True,
    device: str = "cuda",
):
    if quant not in (None, "int8", "int8-all"):
        raise ValueError(f"unknown quant mode {quant!r}")
    import torch

    from callireader_tpu_torch.core.config import get_config
    from callireader_tpu_torch.core.dtypes import require_device
    from callireader_tpu_torch.runtime import engine as engine_mod
    from callireader_tpu_torch.runtime import weights
    from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer

    dev = require_device(device)
    cfg = get_config(preset)
    mesh = make_mesh(mesh_spec, dev) if mesh_spec else None
    options = dict(gray_chars=gray_chars, device_resize_chars=device_resize_chars,
                   device_tile_pages=device_tile_pages, char_canvas=char_canvas, mesh=mesh)
    assets = weights.TRAINED_ASSETS if trained_assets else ()
    if checkpoint_dir and os.path.isdir(checkpoint_dir):
        print(f"[engine] loading checkpoint from {checkpoint_dir}", file=sys.stderr)
        params = weights.convert_reference_checkpoint(
            checkpoint_dir, cfg, mu_sigma_path=mu_sigma_path, orderformer_path=orderformer_path,
            dtype=torch.bfloat16, device=dev)
        random_components = [n for n in OPTIONAL_COMPONENTS if n not in params]
        if random_components:
            print(f"[engine] random-initializing missing components: {random_components}",
                  file=sys.stderr)
            rand = weights.init_params(cfg, 0,
                                       dtype=torch.bfloat16, device=dev)
            params.update({n: rand[n] for n in random_components})
            del rand
    elif random_init_ok:
        print("[engine] WARNING: no checkpoint found: RANDOM weights (outputs are noise; "
              "pipeline and speed testing only)", file=sys.stderr)
        random_components = list(weights.RANDOM_COMPONENTS)
        if not adapter_path:
            engine = engine_mod.build_engine(preset, device=dev, quant=quant, assets=assets,
                                             **options)
            engine.random_components = random_components
            return engine
        # the base as cli.train draws it (bf16, seed 0), then its adapters
        params = weights.init_params(cfg, 0,
                                     dtype=torch.bfloat16, device=dev)
    else:
        raise FileNotFoundError(f"checkpoint_dir {checkpoint_dir!r} not found; pass "
                                f"--random-init to run with random weights")
    if adapter_path:
        params = merge_adapter(params, cfg, adapter_path, lora_rank, lora_alpha, dev)
    if quant is not None:
        params, cfg = quantize_params(params, cfg, quant)
    cfg, loaded = weights.overlay_trained_assets(params, cfg, dtype=torch.bfloat16, device=dev,
                                                 names=assets, replaceable=random_components)
    if loaded:
        print(f"[engine] trained assets loaded: {', '.join(loaded)}", file=sys.stderr)
    engine = engine_mod.CalliReaderEngine(cfg, params, InternLM2Tokenizer(), device=dev, **options)
    engine.assets = loaded
    engine.random_components = random_components
    return engine
