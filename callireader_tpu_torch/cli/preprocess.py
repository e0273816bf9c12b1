"""Dataset preprocessing CLI (a copy of callireader_tpu/cli/preprocess.py:
host JSON only, on the port's evalx/refcoco.py).

Parity target: entry_point.py preprocess modes + tools/data_preprocess/:
  arxiv   (arxiv.py:1-60)  — filter an arXiv metadata JSONL dump by category
          and update date, write the filtered JSON list for the
          arxiv_gentitle-style map fns
  refcoco (tools/data_preprocess/convert_refcoco.py behavior) — convert
          RefCOCO annotations into sharegpt-style grounding conversations
          (evalx/refcoco.py builders)

  python -m callireader_tpu_torch preprocess arxiv SRC DST --categories cs.CL \
      --start-date 2020-01-01
  python -m callireader_tpu_torch preprocess refcoco --ann-path refs.json \
      --save-path out.json [--inv]
"""

from __future__ import annotations

import argparse
import json
from datetime import datetime


def preprocess_arxiv(src_file: str, dst_file: str, categories, start_date: str) -> int:
    from_time = datetime.strptime(start_date, "%Y-%m-%d")
    want = set(categories)
    out = []
    with open(src_file, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                item = json.loads(line)
            except json.JSONDecodeError:
                print(f"Failed to parse line: {line[:80]}")
                continue
            if want & set(item.get("categories", "").split()) and datetime.strptime(
                item["update_date"], "%Y-%m-%d"
            ) >= from_time:
                out.append(item)
    with open(dst_file, "w", encoding="utf-8") as f:
        json.dump(out, f)
    return len(out)


def preprocess_refcoco(ann_path: str, save_path: str, *, inv: bool = False,
                       image_root: str = "") -> int:
    """RefCOCO annotation list -> sharegpt grounding conversations.

    Expects records with sents/bbox(xywh)/height/width/image fields (the
    layout eval_refcoco.py consumes)."""
    from callireader_tpu_torch.evalx import refcoco

    with open(ann_path, encoding="utf-8") as f:
        records = json.load(f)
    out = []
    for i, rec in enumerate(records):
        gen = refcoco.gen_identify_conversation if inv else refcoco.gen_refer_conversation
        template = (refcoco.IDENTIFY_INSTRUCTIONS if inv else refcoco.REFER_INSTRUCTIONS)[
            i % (len(refcoco.IDENTIFY_INSTRUCTIONS) if inv else len(refcoco.REFER_INSTRUCTIONS))
        ]
        conv = gen(rec["sents"], rec["bbox"], rec["height"], rec["width"], template)
        out.append({
            "id": rec.get("id", i),
            "image": (image_root + rec["image"]) if image_root else rec["image"],
            "conversations": conv,
        })
    with open(save_path, "w", encoding="utf-8") as f:
        json.dump(out, f, ensure_ascii=False)
    return len(out)


def main(argv=None):
    parser = argparse.ArgumentParser(description="dataset preprocessing")
    sub = parser.add_subparsers(dest="mode", required=True)

    p_arx = sub.add_parser("arxiv")
    p_arx.add_argument("src_file")
    p_arx.add_argument("dst_file")
    p_arx.add_argument("--categories", nargs="+", default=["cs.AI", "cs.CL", "cs.CV"])
    p_arx.add_argument("--start-date", default="2020-01-01")

    p_ref = sub.add_parser("refcoco")
    p_ref.add_argument("--ann-path", required=True)
    p_ref.add_argument("--save-path", required=True)
    p_ref.add_argument("--image-path", default="")
    p_ref.add_argument("--inv", action="store_true", help="identify (box->text) task")

    args = parser.parse_args(argv)
    if args.mode == "arxiv":
        n = preprocess_arxiv(args.src_file, args.dst_file, args.categories, args.start_date)
        print(f"[preprocess] kept {n} arxiv records -> {args.dst_file}")
    else:
        n = preprocess_refcoco(
            args.ann_path, args.save_path, inv=args.inv, image_root=args.image_path
        )
        print(f"[preprocess] wrote {n} conversations -> {args.save_path}")
    return 0


if __name__ == "__main__":
    main()
