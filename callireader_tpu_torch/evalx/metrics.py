"""CalliBench metrics (port of callireader_tpu/evalx/metrics.py).

  - char-set precision / recall / F1: greedy one-to-one matching of the
    predicted chars against the ground-truth chars
  - NED: Levenshtein distance over the longer length
  - the Chinese and English punctuation cleaners
  - the choice accuracy rules (a multi-letter answer is wrong; containing
    the correct option's text decides unless a wrong option's text is there
    too)
  - traditional -> simplified: OpenCC when installed, else the bundled
    longest-match phrase table and char table (``t2s_phrases.txt``,
    ``t2s.txt``), read by path from the JAX package's assets.
"""

from __future__ import annotations

import functools
import re
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

ASSETS_DIR = Path(__file__).resolve().parents[2] / "callireader_tpu" / "assets"

_CHINESE_PUNCT = re.compile(
    r"[。？！、，「」『』‘’“”"
    r"–—…【】《》：；]"
)
_ENGLISH_PUNCT = re.compile(r"[,\.!?:\'\";\(\)\[\]\{\}\-\n\*1234567890]")


def remove_chinese_punctuation(text: str) -> str:
    return _CHINESE_PUNCT.sub("", text)


def remove_english_punctuation(text: str) -> str:
    return _ENGLISH_PUNCT.sub("", text)


def get_clean_string(text: str) -> str:
    return remove_chinese_punctuation(remove_english_punctuation(text))


@functools.lru_cache(maxsize=None)
def _t2s_chars() -> Dict[int, str]:
    """The ~2.1k-pair char table, one ``<trad><simp>`` pair a line. It leaves
    the context-dependent chars (著/乾/藉/祇) unmapped: the phrase table
    decides those."""
    table = {}
    with open(ASSETS_DIR / "t2s.txt", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if len(line) == 2:
                table[ord(line[0])] = line[1]
    return table


@functools.lru_cache(maxsize=None)
def _t2s_phrases() -> Tuple[Dict[str, str], int]:
    """The phrase table (``trad simp`` a line; identity rows protect phrases
    from partial matches) -> (table, longest phrase)."""
    table = {}
    with open(ASSETS_DIR / "t2s_phrases.txt", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) == 2:
                table[parts[0]] = parts[1]
    return table, max((len(k) for k in table), default=1)


def _t2s_fallback(text: str) -> str:
    """Left to right: the longest phrase that matches here, else the char
    table (the offline stand-in for OpenCC's phrase pass)."""
    phrases, maxlen = _t2s_phrases()
    chars = _t2s_chars()
    out = []
    i, n = 0, len(text)
    while i < n:
        for ln in range(min(maxlen, n - i), 1, -1):
            cand = phrases.get(text[i:i + ln])
            if cand is not None:
                out.append(cand)
                i += ln
                break
        else:
            out.append(chars.get(ord(text[i]), text[i]))
            i += 1
    return "".join(out)


def t2s(text: str) -> str:
    """Traditional -> simplified: OpenCC (phrase-aware) when present, the
    bundled phrase and char tables otherwise."""
    try:
        import opencc  # type: ignore
    except ImportError:
        return _t2s_fallback(text)
    return opencc.OpenCC("t2s").convert(text)


def levenshtein(a: Sequence, b: Sequence) -> int:
    try:
        import Levenshtein  # type: ignore
    except ImportError:
        m, n = len(a), len(b)
        prev = list(range(n + 1))
        for i in range(1, m + 1):
            cur = [i] + [0] * n
            for j in range(1, n + 1):
                cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + (a[i - 1] != b[j - 1]))
            prev = cur
        return prev[n]
    return Levenshtein.distance(a, b)


def calculate_metrics(
    y_pred: Sequence, y_gt: Sequence, cmp: Callable = lambda a, b: a == b
) -> Tuple[float, float, float]:
    """Greedy one-to-one matching -> (precision, recall, F1)."""
    matched = set()
    tp = fp = 0
    for p in y_pred:
        for i, g in enumerate(y_gt):
            if cmp(p, g) and i not in matched:
                matched.add(i)
                tp += 1
                break
        else:
            fp += 1
    fn = len(y_gt) - tp
    precision = tp / (tp + fp) if tp + fp > 0 else 0.0
    recall = tp / (tp + fn) if tp + fn > 0 else 0.0
    f1 = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return precision, recall, f1


def ned(pred: Sequence, gt: Sequence) -> float:
    max_len = max(len(pred), len(gt))
    if max_len == 0:
        return 0.0
    return levenshtein(list(pred), list(gt)) / max_len


def mmlu_accuracy(predictions: List[str], answers: List[str]) -> float:
    """Accuracy of the first A-D letter of each prediction, in percent."""
    if len(predictions) != len(answers):
        raise ValueError("one answer per prediction")
    if not predictions:
        return 0.0
    correct = 0
    for pred, ans in zip(predictions, answers):
        first = next((c for c in pred if c in "ABCD"), None)
        correct += int(first == ans)
    return correct / len(predictions) * 100


def reward_accuracy(chosen_rewards: Sequence[float], rejected_rewards: Sequence[float]) -> float:
    """Pairwise ranking accuracy, in percent."""
    if len(chosen_rewards) != len(rejected_rewards):
        raise ValueError("one rejected reward per chosen reward")
    if not chosen_rewards:
        return 0.0
    wins = sum(c > r for c, r in zip(chosen_rewards, rejected_rewards))
    return wins / len(chosen_rewards) * 100


def evaluate_choice_accuracy(
    responses: List[str], correct_answers: List[Tuple[str, str, str, str]]
) -> float:
    """(correct letter, correct text, wrong text 0, wrong text 1) a sample ->
    accuracy in percent."""
    if len(responses) != len(correct_answers):
        raise ValueError("one answer tuple per response")
    correct = 0
    for response, ans in zip(responses, correct_answers):
        has = [letter in response for letter in "ABC"]
        if sum(has) > 1:
            ok = False
        else:
            chosen = "A" if has[0] else "B" if has[1] else "C" if has[2] else None
            ok = chosen == ans[0]
        if ans[1] in response:
            ok = not (ans[2] in response or ans[3] in response)
        correct += int(ok)
    return correct / len(responses) * 100 if responses else 0.0
