"""Checkpoint converters CLI (PyTorch port of callireader_tpu/cli/convert.py).

  export       a params checkpoint -> reference-layout safetensors folder
               (train/xtuner/tools/model_converters/pth_to_hf.py)
  merge        fold LoRA adapters into the base weights, then export
               (merge.py)
  split        reshard a safetensors folder to a max shard size (split.py)
  consolidate  dtype-cast a safetensors folder, fp32 / bf16 / fp16
               (zero_to_any_dtype.py)

  python -m callireader_tpu_torch convert export --preset callireader-8b \
      --checkpoint ckpt/ --out deploy/
  python -m callireader_tpu_torch convert merge --preset ... --checkpoint ... \
      --adapter work_dir/final --out ...
  python -m callireader_tpu_torch convert split SRC DST --max-shard-size 2GB
  python -m callireader_tpu_torch convert consolidate SRC DST --dtype bfloat16

The JAX CLI's ``export`` and ``merge`` read orbax checkpoints, which cannot
be read without JAX; the port's read its own: ``--checkpoint`` is a
directory ``train/checkpoint.save_params`` wrote (``params.pt``: the whole
engine tree, LoRA leaves merged unless ``--no-merge-lora``), and
``--adapter`` one ``cli.train`` wrote (``state.pt``: its LoRA leaves and
projector are restored onto the base and merged, at ``--lora-rank`` /
``--lora-alpha``, the recipe's 128 / 256 by default). Both run on the GPU
unless ``--device cpu`` is given; ``split`` and ``consolidate`` are file
operations on the host.
"""

from __future__ import annotations

import argparse


def _parse_size(s: str) -> int:
    s = s.strip().upper()
    for suffix, mult in (("GB", 1 << 30), ("MB", 1 << 20), ("KB", 1 << 10)):
        if s.endswith(suffix):
            return int(float(s[: -len(suffix)]) * mult)
    return int(s)


def main(argv=None):
    parser = argparse.ArgumentParser(description="checkpoint converters")
    sub = parser.add_subparsers(dest="mode", required=True)

    p_exp = sub.add_parser("export", help="params checkpoint -> reference safetensors")
    p_exp.add_argument("--preset", default="callireader-8b")
    p_exp.add_argument("--checkpoint", required=True)
    p_exp.add_argument("--out", required=True)
    p_exp.add_argument("--max-shard-size", default=None)
    p_exp.add_argument("--no-merge-lora", action="store_true")
    p_exp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    p_mrg = sub.add_parser("merge", help="fold LoRA adapters into base weights")
    p_mrg.add_argument("--preset", default="callireader-8b")
    p_mrg.add_argument("--checkpoint", required=True)
    p_mrg.add_argument("--adapter", default=None, help="separate adapter checkpoint (cli.train)")
    p_mrg.add_argument("--lora-rank", type=int, default=128)
    p_mrg.add_argument("--lora-alpha", type=float, default=256.0)
    p_mrg.add_argument("--out", required=True)
    p_mrg.add_argument("--device", default="cuda", choices=["cuda", "cpu"])

    p_spl = sub.add_parser("split", help="reshard safetensors folder")
    p_spl.add_argument("src")
    p_spl.add_argument("dst")
    p_spl.add_argument("--max-shard-size", default="2GB")

    p_con = sub.add_parser("consolidate", help="dtype-cast safetensors folder")
    p_con.add_argument("src")
    p_con.add_argument("dst")
    p_con.add_argument("--dtype", default="float32", choices=["float32", "bfloat16", "float16"])

    args = parser.parse_args(argv)

    from callireader_tpu_torch.train import checkpoint as ckpt

    if args.mode in ("export", "merge"):
        from callireader_tpu_torch.cli.common import merge_adapter
        from callireader_tpu_torch.core.config import get_config
        from callireader_tpu_torch.core.dtypes import require_device
        from callireader_tpu_torch.train.lora import merge_lora

        cfg = get_config(args.preset)
        dev = require_device(args.device)
        params = ckpt.load_params(args.checkpoint, dev)
        if args.mode == "merge":
            if args.adapter:
                params = merge_adapter(params, cfg, args.adapter, args.lora_rank,
                                       args.lora_alpha, dev)
            params["llm"] = merge_lora(params["llm"])
        ckpt.export_reference_format(
            params, cfg, args.out,
            merge_lora_first=not getattr(args, "no_merge_lora", False),
            max_shard_bytes=_parse_size(args.max_shard_size)
            if getattr(args, "max_shard_size", None) else None,
        )
        print(f"[convert] wrote {args.out}")
    elif args.mode == "split":
        ckpt.consolidate_safetensors_dtype(args.src, args.dst, dtype=None,
                                           max_shard_bytes=_parse_size(args.max_shard_size))
        print(f"[convert] resharded into {args.dst}")
    else:
        ckpt.consolidate_safetensors_dtype(args.src, args.dst, dtype=args.dtype)
        print(f"[convert] consolidated to {args.dtype} in {args.dst}")


if __name__ == "__main__":
    main()
