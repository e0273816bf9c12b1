"""Command line entry with the JAX package's mode table (PyTorch port of
callireader_tpu/__main__.py).

  python -m callireader_tpu_torch MODE [ARGS...]
"""

from __future__ import annotations

import sys

MODES = (
    "list-cfg", "copy-cfg", "train", "test", "chat", "serve", "inference",
    "evaluate", "convert", "preprocess", "mmbench", "judge", "get-embeddings",
    "check-custom-dataset", "log-dataset",
)

HELP = f"""callireader-tpu (PyTorch/CUDA port) command line

    python -m callireader_tpu_torch MODE MODE_ARGS

Where MODE is one of {MODES}

  python -m callireader_tpu_torch list-cfg
  python -m callireader_tpu_torch copy-cfg e_it ./my_e_it.py
  python -m callireader_tpu_torch train --config e_it --data ann.jsonl --image-root DIR --random-init
  python -m callireader_tpu_torch convert export --checkpoint ... --out ...
  python -m callireader_tpu_torch convert merge --checkpoint ... --adapter ... --out ...
  python -m callireader_tpu_torch convert split SRC DST --max-shard-size 2GB
  python -m callireader_tpu_torch convert consolidate SRC DST --dtype bfloat16
  python -m callireader_tpu_torch inference --tgt page.npy --random-init --quant int8
  python -m callireader_tpu_torch inference --tgt page.npy --checkpoint InternVL/ --quant int8
  python -m callireader_tpu_torch chat --image page.npy --random-init
  python -m callireader_tpu_torch chat --agent --random-init
  python -m callireader_tpu_torch serve --input req.jsonl --output out.jsonl --paged --random-init
  python -m callireader_tpu_torch get-embeddings --data DIR --out OUT --random-init
  python -m callireader_tpu_torch evaluate --type full_page --data ./CalliBench --save_name exp --random-init
  python -m callireader_tpu_torch mmbench --data-path mmbench_dev.tsv --save_name exp --random-init
  python -m callireader_tpu_torch judge --type bilingual --input outputs/exp/bilingual.json
  python -m callireader_tpu_torch preprocess arxiv SRC DST --categories cs.CL
  python -m callireader_tpu_torch preprocess refcoco --ann-path refs.json --save-path out.json
  python -m callireader_tpu_torch check-custom-dataset --config e_it --data ann.jsonl --random-init
  python -m callireader_tpu_torch log-dataset --data ann.jsonl --random-init
"""


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(HELP)
        return 0
    mode, rest = argv[0], argv[1:]
    if mode == "list-cfg":
        from callireader_tpu_torch.configs import list_configs

        for name in list_configs():
            print(name)
        return 0
    if mode == "copy-cfg":
        from callireader_tpu_torch.configs import copy_config

        dst = copy_config(rest[0], rest[1] if len(rest) > 1 else ".")
        print(f"copied to {dst}")
        return 0
    if mode in ("train", "check-custom-dataset", "log-dataset"):
        from callireader_tpu_torch.cli import train as m

        if mode == "check-custom-dataset":
            rest = ["--check-data", *rest]
    elif mode in ("test", "evaluate", "mmbench"):
        from callireader_tpu_torch.cli import evaluate as m

        if mode == "mmbench":
            rest = ["--type", "mmbench", *rest]
    elif mode == "judge":
        from callireader_tpu_torch.cli import judge as m
    elif mode == "chat":
        from callireader_tpu_torch.cli import chat as m
    elif mode == "serve":
        from callireader_tpu_torch.cli import serve as m
    elif mode == "inference":
        from callireader_tpu_torch.cli import inference as m
    elif mode == "get-embeddings":
        from callireader_tpu_torch.cli import get_embeddings as m
    elif mode == "convert":
        from callireader_tpu_torch.cli import convert as m
    elif mode == "preprocess":
        from callireader_tpu_torch.cli import preprocess as m
    else:
        print(f"unknown mode {mode!r}\n{HELP}", file=sys.stderr)
        return 1
    m.main(rest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
