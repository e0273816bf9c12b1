"""External-judge CLI over CalliBench result files (PyTorch port of
callireader_tpu/cli/judge.py), run after cli.evaluate wrote bilingual.json /
intent.json.

  python -m callireader_tpu_torch.cli.judge --type bilingual --input outputs/exp/bilingual.json
  python -m callireader_tpu_torch.cli.judge --type intent --input outputs/exp/intent.json \
      --save outputs/exp/intent_scores.json     # needs DEEPSEEK_API_KEY and the openai package

Prints one JSON line: {"STScore", "n"} (bilingual) or the LLM judge's
summary (intent). Without sentence_transformers and its weights the
bilingual score falls back to a hashed bag of characters, and a warning says
so on stderr.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(description="judge eval results")
    parser.add_argument("--type", choices=["bilingual", "intent"], required=True)
    parser.add_argument("--input", type=str, required=True)
    parser.add_argument("--save", type=str, default=None)
    parser.add_argument("--model", type=str, default="deepseek-chat")
    parser.add_argument("--workers", type=int, default=4)
    args = parser.parse_args(argv)

    from callireader_tpu_torch.evalx import judges

    if args.type == "bilingual":
        result = judges.STScoreJudge().score_result_file(args.input)
        if result.get("fallback_embedder"):
            print("[judge] WARNING: sentence-transformers unavailable — hash-embedding "
                  "fallback; scores are NOT comparable to paper STScores", file=sys.stderr)
        out = {"STScore": result["STScore"], "n": len(result["per_sample"])}
    else:
        judge = judges.LLMJudge(model=args.model, num_workers=args.workers)
        out = judge.score_result_file(args.input, save_path=args.save)

    print(json.dumps(out, ensure_ascii=False))
    if args.save and args.type == "bilingual":
        with open(args.save, "w", encoding="utf-8") as f:
            json.dump(out, f, ensure_ascii=False, indent=4)


if __name__ == "__main__":
    main()
