"""Engine construction shared by the inference CLIs (PyTorch port of
callireader_tpu/cli/common.py).

No InternVL checkpoint ships with the repository and the port loads none
yet, so ``random_init_ok`` must be set: the engine draws seeded random weights
(``runtime.engine.build_engine``, seed 0) and overlays the committed trained
assets. ``adapter_path`` serves an e-IT checkpoint written by ``cli.train``:
the bf16 base is drawn with the seed the trainer drew it with, the LoRA
leaves are attached, the trainable subtree (LoRA + projector) is restored
from the checkpoint and the adapters are merged into the dense weights.
``quant="int8"`` then quantizes the merged LLM (weight-only int8, vocab padded
to 128, fused wqkv / w13), in the JAX CLI's order; ``"int8-all"`` adds the
W8A8 tile tower. ``device_tile_pages`` (default on, as in the JAX builder)
and ``char_canvas`` go to the engine.

Not ported yet: checkpoint loading (``checkpoint_dir``), meshes and
``trained_assets=False``; each raises.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional


def build_engine(
    *,
    preset: str = "callireader-8b",
    checkpoint_dir: Optional[str] = None,
    random_init_ok: bool = False,
    quant: Optional[str] = None,
    adapter_path: Optional[str] = None,
    lora_rank: int = 128,
    lora_alpha: float = 256.0,
    device_tile_pages: bool = True,
    char_canvas: Optional[int] = None,
    mesh_spec: Optional[str] = None,
    trained_assets: bool = True,
    device: str = "cuda",
):
    for flag, value, item in (("--checkpoint", checkpoint_dir, "A4"), ("--mesh", mesh_spec, "A11")):
        if value:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP {item})")
    if not trained_assets:
        raise NotImplementedError("--no-trained-assets is not ported yet: the port always "
                                  "overlays the committed trained assets (ROADMAP A5)")
    if quant not in (None, "int8", "int8-all"):
        raise ValueError(f"unknown quant mode {quant!r}")
    if not random_init_ok:
        raise FileNotFoundError("no checkpoint can be loaded yet; pass --random-init to run "
                                "with random weights")
    import torch

    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import engine as engine_mod
    from callireader_tpu_torch.runtime import quantize

    print("[engine] WARNING: RANDOM weights (outputs are noise; pipeline and speed testing "
          "only)", file=sys.stderr)
    options = dict(device_tile_pages=device_tile_pages, char_canvas=char_canvas)
    if not adapter_path:
        return engine_mod.build_engine(preset, device=device, quant=quant, **options)

    from callireader_tpu_torch.train import checkpoint as ckpt_mod
    from callireader_tpu_torch.train import e_it, lora

    # the base as cli.train draws it (bf16, seed 0), then its adapters
    engine = engine_mod.build_engine(preset, device=device, **options)
    params, cfg = engine.params, engine.cfg
    print(f"[engine] loading adapter from {adapter_path}", file=sys.stderr)
    params["llm"] = lora.add_lora(params["llm"], cfg.llm,
                                  torch.Generator(device=engine.device).manual_seed(0),
                                  rank=lora_rank, alpha=lora_alpha, dtype=torch.float32)
    tc = e_it.TrainConfig(lora_rank=lora_rank, lora_alpha=lora_alpha)
    trainable, frozen = e_it.partition_params(params, tc)
    # the trainable subtree only: the optimizer's moments are not needed here
    state = ckpt_mod.restore_train_state(adapter_path, e_it.TrainState(trainable, {}, 0))
    params = e_it.merge_params(state.trainable, frozen)
    params["llm"] = lora.merge_lora(params["llm"])
    if quant is not None:
        before = quantize.param_bytes(params["llm"])
        params["llm"] = quantize.quantize_llm_int8(params["llm"])
        params["llm"], llm_cfg = internlm2.pad_vocab(params["llm"], cfg.llm, 128)
        cfg = dataclasses.replace(cfg, llm=llm_cfg)
        params["llm"] = quantize.fuse_llm_int8(params["llm"])
        print(f"[engine] int8 weight-only quantization: LLM {before / 1e9:.1f} GB -> "
              f"{quantize.param_bytes(params['llm']) / 1e9:.1f} GB", file=sys.stderr)
    if quant == "int8-all":
        params["vision"] = quantize.quantize_vit_int8(params["vision"])
    engine.params, engine.cfg = params, cfg
    return engine
