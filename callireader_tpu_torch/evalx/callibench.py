"""CalliBench evaluation harness (port of callireader_tpu/evalx/callibench.py).

Five task families over parquet splits (image bytes + a JSON annotation a
row): full-page OCR, region-wise OCR, choice QA (two turns: recognize, then
answer), bilingual interpretation and intent analysis. The result files have
the JAX package's layout key for key (``ave_precison`` spelt as there), so
either package's judges read them.

Each ``test_*`` is ``get_parquet`` followed by a runner over ``(images,
annotations)`` lists (``run_*``), so that a caller without ``pandas`` can run
the tasks on images it holds.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from callireader_tpu_torch.evalx.metrics import (
    calculate_metrics,
    evaluate_choice_accuracy,
    get_clean_string,
    ned,
    t2s,
)
from callireader_tpu_torch.vision import preprocess

RECOGNIZE_PROMPT = "这幅书法作品内容是什么？"
FULL_PAGE_PROMPT = "读出图中所有文字。"
REGION_PROMPT = "读出图中区域所有文字。"
CHOICE_SUFFIX = "\n只需要输出问题的答案，禁止输出其他内容！答案："


def get_parquet(parquet_path: str) -> Tuple[List[np.ndarray], List[Dict]]:
    """-> (uint8 (H, W, 3) RGB pages, annotation dicts). A row that fails to
    decode is reported and skipped. Needs pandas (with a parquet engine) and
    PIL."""
    import pandas as pd

    df = pd.read_parquet(parquet_path)
    images, annotations = [], []
    for index, row in df.iterrows():
        try:
            labels = json.loads(row["annotation"])
            image = preprocess.open_image(row["image"]["bytes"])
        except (KeyError, TypeError, ValueError, OSError) as e:
            print(f"Row {index} Error: {e}")
            continue
        images.append(image)
        annotations.append(labels)
    return images, annotations


def _save(result: Dict, save_json_path: Optional[str]) -> None:
    """Writes on rank 0 only (every rank of a mesh computes the result)."""
    from callireader_tpu_torch.parallel.spmd import is_main

    if save_json_path and is_main():
        with open(save_json_path, "w", encoding="utf-8") as f:
            json.dump(result, f, ensure_ascii=False, indent=4)


def _pipelined_responses(engine, pages: List[np.ndarray], prompt: str, batch_size: int,
                         **kw) -> List[str]:
    """Chunks of ``batch_size`` pages with one decode in flight: batch i is
    built (``batch_build_rows``) while decode i-1 runs, and the box stage is
    phased around the decodes as in the bench. At iteration i (decode i-1 in
    flight) ordered[i] is ready, dets[i+1] is ready and handle[i+2] is
    dispatched; only the readbacks (``detect_fetch``, ``order_fetch``) sit in
    the gap after a decode retires."""
    gen_kw = {k: v for k, v in kw.items()
              if k in ("repetition_penalty", "max_new_tokens", "eos_token_ids")}
    row_kw = {k: v for k, v in kw.items() if k in ("use_p", "drop_zero", "hard_vq", "histories")}
    use_p = row_kw.get("use_p", True)
    chunks = [pages[lo:lo + batch_size] for lo in range(0, len(pages), batch_size)]
    K = len(chunks)
    responses: List[str] = []
    handle: Dict[int, Any] = {}
    dets: Dict[int, list] = {}
    ordered: Dict[int, Optional[list]] = {}
    if K and use_p:  # prime: no decode in flight yet
        dets[0] = engine.detect_fetch(chunks[0], engine.detect_dispatch(chunks[0]))
        ordered[0] = engine.order_stage(engine.columns_stage(chunks[0], dets[0]))
        if K > 1:
            dets[1] = engine.detect_fetch(chunks[1], engine.detect_dispatch(chunks[1]))
        if K > 2:
            handle[2] = engine.detect_dispatch(chunks[2])
    prepared = None
    for i, cur in enumerate(chunks):
        odisp = None
        if use_p and i + 1 < K:
            # host columns overlap the decode; the OrderFormer forward queues
            # ahead of this batch's char and tile encodes
            odisp = engine.order_dispatch(engine.columns_stage(chunks[i + 1], dets.pop(i + 1)))
        rows = engine.batch_build_rows(cur, [prompt] * len(cur), ordered_lists=ordered.pop(i, None),
                                       **row_kw)
        if prepared is not None:  # decode i-1 retires
            responses.extend(t2s(r) for r in engine.batch_decode(prepared))
        if odisp is not None:
            ordered[i + 1] = engine.order_fetch(odisp)
        if use_p and i + 2 < K:
            dets[i + 2] = engine.detect_fetch(chunks[i + 2], handle.pop(i + 2))
        prepared = engine.batch_prepare([], [], prepared_rows=rows, **gen_kw)
        if use_p and i + 3 < K:  # queues behind the decode just launched
            handle[i + 3] = engine.detect_dispatch(chunks[i + 3])
    if prepared is not None:
        responses.extend(t2s(r) for r in engine.batch_decode(prepared))
    return responses


def run_ocr_task(engine, images, annotations, save_json_path, prompt, gt_key, region: bool,
                 batch_size: int = 1, **kw) -> Dict:
    """Full-page (``region=False``) or region-wise OCR over pages in memory:
    ``batch_size`` > 1 takes the pipelined batch route, 1 ``chat_ocr`` a page.
    A region is the annotation's ``[[x1, y1], [x2, y2]]`` slice of the page."""
    pages = []
    for img, annot in zip(images, annotations):
        page = preprocess.open_image(img)
        if region:
            [x1, y1], [x2, y2] = annot["region"]
            page = np.ascontiguousarray(page[y1:y2, x1:x2])
        pages.append(page)
    if batch_size > 1:
        responses = _pipelined_responses(engine, pages, prompt, batch_size, **kw)
    else:
        responses = [t2s(engine.chat_ocr(page, prompt, return_history=True, **kw)[0])
                     for page in pages]

    detailed = []
    sums = dict(p=0.0, r=0.0, f1=0.0, ned=0.0)
    for response, annot in zip(responses, annotations):
        gt = get_clean_string(annot[gt_key])
        pred_chars, gt_chars = list(response), list(gt)
        p, r, f1 = calculate_metrics(pred_chars, gt_chars)
        d = ned(pred_chars, gt_chars)
        detailed.append({
            "imgPath": annot.get("imagePath", annot.get("image", "")),
            "prompt": prompt,
            "output": response,
            "gt": gt,
            "precision": p,
            "recall": r,
            "f1": f1,
            "ned": d,
        })
        sums["p"] += p
        sums["r"] += r
        sums["f1"] += f1
        sums["ned"] += d
    count = len(detailed)
    avg = {
        "ave_precison": sums["p"] / count if count else 0,
        "avg_recall": sums["r"] / count if count else 0,
        "avg_f1": sums["f1"] / count if count else 0,
        "avg_ned": sums["ned"] / count if count else 0,
    }
    result = {"detailed": detailed, "average": avg}
    _save(result, save_json_path)
    return result


def test_full_page(engine, parquet_path, save_json_path, prompt=FULL_PAGE_PROMPT, batch_size=1,
                   **kw):
    images, annotations = get_parquet(parquet_path)
    return run_ocr_task(engine, images, annotations, save_json_path, prompt, "reference", False,
                        batch_size=batch_size, **kw)


def test_region_wise(engine, parquet_path, save_json_path, prompt=REGION_PROMPT, batch_size=1,
                     **kw):
    images, annotations = get_parquet(parquet_path)
    return run_ocr_task(engine, images, annotations, save_json_path, prompt, "answer", True,
                        batch_size=batch_size, **kw)


def _parse_choice_gt(annotations: List[Dict]) -> List[Tuple[str, str, str, str]]:
    gt_list = []
    for item in annotations:
        prompt = item["conversations"][0]["value"]
        gt = item["conversations"][1]["value"]
        options_line = wrong_0 = wrong_1 = None
        for line in prompt.split("\n"):
            if "A" in line or "B" in line or "C" in line:
                if line.startswith(gt + ":"):
                    options_line = line
                elif wrong_0 is None:
                    wrong_0 = line
                elif wrong_1 is None:
                    wrong_1 = line
        gt_list.append((
            gt,
            options_line.split(":")[1].strip(),
            wrong_0.split(":")[1].strip(),
            wrong_1.split(":")[1].strip(),
        ))
    return gt_list


def _two_turn(engine, images, questions2, batch_size: int, **kw) -> List[str]:
    """Recognize, then the follow-up question on that history; batched
    (``batch_chat_ocr`` twice a chunk) when ``batch_size`` > 1."""
    responses = []
    if batch_size > 1:
        for i in range(0, len(images), batch_size):
            imgs = images[i:i + batch_size]
            _, hists = engine.batch_chat_ocr(imgs, [RECOGNIZE_PROMPT] * len(imgs),
                                             return_histories=True, **kw)
            responses.extend(engine.batch_chat_ocr(imgs, questions2[i:i + batch_size],
                                                   histories=hists, **kw))
    else:
        for img, q2 in zip(images, questions2):
            _, history = engine.chat_ocr(img, RECOGNIZE_PROMPT, return_history=True, **kw)
            response, _ = engine.chat_ocr(img, q2, history=history, return_history=True, **kw)
            responses.append(response)
    return responses


def run_choice(engine, images, annotations, save_json_path, limit: Optional[int] = None,
               batch_size: int = 1, **kw):
    """Two-turn choice QA over pages in memory -> (accuracy, result)."""
    gt_list = _parse_choice_gt(annotations)
    if limit is not None:
        images, annotations, gt_list = images[:limit], annotations[:limit], gt_list[:limit]
    questions2 = [annot["conversations"][0]["value"].replace("<image>\n", "") + CHOICE_SUFFIX
                  for annot in annotations]
    responses = _two_turn(engine, images, questions2, batch_size, **kw)
    detailed = [{"imgPath": annot.get("image", ""), "output": resp, "reference": gt_info[0]}
                for annot, resp, gt_info in zip(annotations, responses, gt_list)]
    accuracy = evaluate_choice_accuracy(responses, gt_list)
    result = {"detailed": detailed,
              "summary": {"total_samples": len(responses), "accuracy": accuracy}}
    _save(result, save_json_path)
    return accuracy, result


def test_choice(engine, parquet_path, save_json_path, limit: Optional[int] = None,
                batch_size: int = 1, **kw):
    """Two-turn choice QA. The reference harness runs a 3-sample slice: pass
    limit=3 for it, None for the whole split."""
    images, annotations = get_parquet(parquet_path)
    return run_choice(engine, images, annotations, save_json_path, limit=limit,
                      batch_size=batch_size, **kw)


def run_reasoning_task(engine, images, annotations, save_json_path, extra_keys=(),
                       batch_size: int = 1, **kw) -> Dict:
    """Bilingual / intent over pages in memory: the question is the first
    turn's text before its options."""
    questions2 = []
    for annot in annotations:
        prompt = annot["conversations"][0]["value"]
        m = re.search(r"^(.*?)\n[A-Z]:", prompt, re.DOTALL)
        questions2.append(m.group(1).strip() if m else prompt)
    responses = _two_turn(engine, images, questions2, batch_size, **kw)
    detailed = []
    for annot, response in zip(annotations, responses):
        rec = {
            "imgPath": annot.get("image", ""),
            "chinese": response.split("INTENT:")[0],
            "answer": response.split("INTENT:")[-1],
            "gt": annot["conversations"][-1]["value"],
        }
        for k in extra_keys:
            rec[k] = annot.get(k.replace("calligraphy_content", "content"), "")
        detailed.append(rec)
    result = {"detailed": detailed}
    _save(result, save_json_path)
    return result


def test_bilingual(engine, parquet_path, save_json_path, **kw):
    images, annotations = get_parquet(parquet_path)
    return run_reasoning_task(engine, images, annotations, save_json_path, **kw)


def test_intent(engine, parquet_path, save_json_path, **kw):
    images, annotations = get_parquet(parquet_path)
    return run_reasoning_task(engine, images, annotations, save_json_path,
                              extra_keys=("calligraphy_content",), **kw)
