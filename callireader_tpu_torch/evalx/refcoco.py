"""RefCOCO grounding: conversation construction and IoU@0.5 scoring (port
of callireader_tpu/evalx/refcoco.py).

Boxes are COCO xywh, normalized to integer percent xyxy; the model answers
``{<x1><y1><x2><y2>}`` and a sample counts when the first four integers of
its answer overlap the ground truth at IoU > 0.5 (pixel-inclusive: the +1
convention). Host code; the inference rides ``engine.chat``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence

REFER_INSTRUCTIONS = ["[refer] give me the location of {}"]
IDENTIFY_INSTRUCTIONS = [
    "[identify] {}",
    "[identify] what object is in this location {}",
    "[identify] identify the object present at this location {}",
    "[identify] what is it in {}",
    "[identify] describe this object in {}",
    "[identify] this {} is",
    "[identify] the object in {} is",
]


def normalize_bbox(bbox: Sequence[float], height: float, width: float) -> List[int]:
    """COCO xywh -> xyxy in integer percent of the image."""
    x, y, w, h = bbox
    out = [x / width, y / height, (x + w) / width, (y + h) / height]
    return [int(v * 100) for v in out]


def bbox_answer_string(bbox_pct: Sequence[int]) -> str:
    """The grounding answer ``{<x1><y1><x2><y2>}``."""
    return "{{<{}><{}><{}><{}>}}".format(*bbox_pct)


def gen_refer_conversation(sents: str, bbox: Sequence[float], height: float,
                           width: float, instruction_template: str = "{}") -> List[Dict]:
    """The refer task: text -> box."""
    pct = normalize_bbox(bbox, height, width)
    return [
        {"from": "human", "value": instruction_template.format(sents) + "\n<image>"},
        {"from": "gpt", "value": bbox_answer_string(pct)},
    ]


def gen_identify_conversation(sents: str, bbox: Sequence[float], height: float,
                              width: float, instruction_template: str = "{}") -> List[Dict]:
    """The inverse task: box -> text."""
    pct = normalize_bbox(bbox, height, width)
    return [
        {"from": "human",
         "value": instruction_template.format(bbox_answer_string(pct)) + "\n<image>"},
        {"from": "gpt", "value": sents},
    ]


def compute_iou(bbox1: Sequence[float], bbox2: Sequence[float]) -> float:
    """Pixel-inclusive IoU of two xyxy boxes."""
    x1, y1, x2, y2 = bbox1
    x3, y3, x4, y4 = bbox2
    ix1, iy1 = max(x1, x3), max(y1, y3)
    ix2, iy2 = min(x2, x4), min(y2, y4)
    if ix2 < ix1 or iy2 < iy1:
        return 0.0
    inter = (ix2 - ix1 + 1) * (iy2 - iy1 + 1)
    a1 = (x2 - x1 + 1) * (y2 - y1 + 1)
    a2 = (x4 - x3 + 1) * (y4 - y3 + 1)
    return inter / (a1 + a2 - inter)


def parse_bbox_answer(text: str) -> Optional[List[int]]:
    """The first four integers of the model's answer, or None."""
    nums = [int(x) for x in re.findall(r"\d+", text)]
    return nums[:4] if len(nums) >= 4 else None


def eval_iou(answers: List[Dict]) -> float:
    """answers: [{"ans": str, "bbox": xywh, "height": H, "width": W}] ->
    IoU@0.5 accuracy."""
    correct = 0
    for a in answers:
        gt = normalize_bbox(a["bbox"], a["height"], a["width"])
        pred = parse_bbox_answer(a["ans"])
        if pred is not None and compute_iou(pred, gt) > 0.5:
            correct += 1
    return correct / max(len(answers), 1)


def evaluate_refcoco(engine, samples: List[Dict], *, max_new_tokens: int = 32,
                     instruction_template: str = REFER_INSTRUCTIONS[0]) -> Dict:
    """samples: [{"image": uint8 (H, W, 3) or a path, "sents": str, "bbox":
    xywh, "height": H, "width": W}] -> {"accuracy", "detailed"}."""
    answers = []
    for s in samples:
        q = instruction_template.format(s["sents"])
        ans = engine.chat(s["image"], "<image>\n" + q, max_new_tokens=max_new_tokens)
        answers.append({**{k: s[k] for k in ("bbox", "height", "width")}, "ans": ans})
    return {"accuracy": eval_iou(answers), "detailed": answers}
