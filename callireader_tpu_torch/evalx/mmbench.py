"""MMBench-style multiple-choice VQA (port of callireader_tpu/evalx/mmbench.py).

A TSV of base64 images and A/B/C/D options; the rows go through the engine's
batched plain chat, the answer is the first option letter of the response
(else the option whose text it contains), and the accuracy is taken over the
rows that carry an answer (the dev split).
"""

from __future__ import annotations

import base64
import csv
import json
from typing import Dict, List, Optional

OPTION_LETTERS = ["A", "B", "C", "D"]


def load_tsv(path: str) -> List[Dict]:
    """MMBench TSV rows -> dicts, each image decoded into ``_image`` (uint8
    (H, W, 3)); decoding needs PIL."""
    from callireader_tpu_torch.vision import preprocess

    rows = []
    with open(path, newline="", encoding="utf-8") as f:
        for rec in csv.DictReader(f, delimiter="\t"):
            if rec.get("image"):
                rec["_image"] = preprocess.open_image(base64.b64decode(rec["image"]))
            rows.append(rec)
    return rows


def build_prompt(rec: Dict) -> str:
    q = rec.get("question", "")
    hint = rec.get("hint") or ""
    parts = []
    if hint and hint != "nan":
        parts.append(hint)
    parts.append(q)
    parts.extend(f"{letter}. {rec[letter]}" for letter in OPTION_LETTERS if rec.get(letter))
    parts.append("Answer with the option's letter from the given choices directly.")
    return "\n".join(parts)


def extract_answer(response: str, rec: Dict) -> Optional[str]:
    """The first option letter of the response, else the option whose text
    it contains."""
    for ch in response:
        if ch in OPTION_LETTERS and rec.get(ch):
            return ch
    for letter in OPTION_LETTERS:
        text = rec.get(letter)
        if text and text != "nan" and text in response:
            return letter
    return None


def evaluate_mmbench(
    engine,
    tsv_path: str,
    save_json_path: Optional[str] = None,
    *,
    batch_size: int = 8,
    max_new_tokens: int = 16,
    limit: Optional[int] = None,
) -> Dict:
    rows = load_tsv(tsv_path)
    if limit:
        rows = rows[:limit]
    detailed = []
    correct = scored = 0
    for i in range(0, len(rows), batch_size):
        chunk = rows[i:i + batch_size]
        responses = engine.batch_chat([r["_image"] for r in chunk],
                                      [build_prompt(r) for r in chunk],
                                      max_new_tokens=max_new_tokens)
        for rec, resp in zip(chunk, responses):
            pred = extract_answer(resp, rec)
            gt = rec.get("answer")
            detailed.append({
                "index": rec.get("index"),
                "question": rec.get("question"),
                "prediction": resp,
                "pred_option": pred,
                "answer": gt,
            })
            if gt:  # the dev split has answers, the test split none
                scored += 1
                correct += int(pred == gt)
    result = {
        "detailed": detailed,
        "accuracy": (correct / scored * 100) if scored else None,
        "scored": scored,
        "total": len(rows),
    }
    from callireader_tpu_torch.parallel.spmd import is_main

    if save_json_path and is_main():
        with open(save_json_path, "w", encoding="utf-8") as f:
            json.dump(result, f, ensure_ascii=False, indent=4)
    return result
