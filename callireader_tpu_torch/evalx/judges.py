"""External judges over CalliBench result files (port of
callireader_tpu/evalx/judges.py).

``STScoreJudge``: the mean cosine similarity of sentence embeddings between
the answers and the ground truth (bilingual). Its default embedder is
``all-MiniLM-L6-v2`` through ``sentence_transformers`` when that package and
its weights are present, else a hashed bag of characters (plumbing only, not
comparable to published STScores; results say so in ``fallback_embedder``).
Any callable ``texts -> (n, d) array`` can be given instead.

``LLMJudge``: an LLM scores each intent analysis from 0 to 10 through an
OpenAI-compatible client (``client_factory``; default: the DeepSeek API with
``DEEPSEEK_API_KEY``), from a queue served by worker threads; the result file
is written atomically.
"""

from __future__ import annotations

import json
import os
import queue
import re
import threading
from typing import Callable, Dict, List, Optional

import numpy as np


def default_embedder(model_name: str = "all-MiniLM-L6-v2") -> Callable[[List[str]], np.ndarray]:
    try:
        # without the weights on disk, fail at once instead of retrying downloads
        os.environ.setdefault("HF_HUB_OFFLINE", "1")
        from sentence_transformers import SentenceTransformer  # type: ignore

        model = SentenceTransformer(model_name)
        return lambda texts: np.asarray(model.encode(texts))
    except Exception:  # noqa: BLE001 - any failure to import or load takes the fallback
        def hash_embed(texts: List[str]) -> np.ndarray:
            out = np.zeros((len(texts), 256), np.float32)
            for i, t in enumerate(texts):
                for ch in t:
                    out[i, hash(ch) % 256] += 1.0
            n = np.linalg.norm(out, axis=1, keepdims=True)
            return out / np.maximum(n, 1e-9)

        hash_embed.is_fallback = True  # type: ignore[attr-defined]
        return hash_embed


class STScoreJudge:
    """Cosine similarity judge over sentence embeddings."""

    def __init__(self, embedder: Optional[Callable] = None):
        self.embed = embedder or default_embedder()

    def score(self, answers: List[str], references: List[str]) -> Dict:
        a = self.embed(answers)
        b = self.embed(references)
        a = a / np.maximum(np.linalg.norm(a, axis=1, keepdims=True), 1e-9)
        b = b / np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 1e-9)
        sims = (a * b).sum(axis=1)
        return {
            "STScore": float(sims.mean()) if len(sims) else 0.0,
            "per_sample": sims.tolist(),
            "fallback_embedder": bool(getattr(self.embed, "is_fallback", False)),
        }

    def score_result_file(self, result_json_path: str) -> Dict:
        with open(result_json_path, encoding="utf-8") as f:
            data = json.load(f)
        return self.score([d["answer"] for d in data["detailed"]],
                          [d["gt"] for d in data["detailed"]])


INTENT_JUDGE_PROMPT = (
    "You are an expert in Chinese calligraphy appreciation. Given a calligraphy "
    "work's textual content, a model's analysis of the creation intent, and a "
    "reference analysis, score the model analysis from 0 to 10 for correctness "
    "and depth. Reply with JSON: {{\"score\": <int>}}.\n"
    "Content: {content}\nModel analysis: {answer}\nReference: {reference}\n"
)


def _parse_json_score(text: str) -> Optional[float]:
    """The ``score`` of the first JSON object that has one, else the first
    number in the text."""
    for m in re.finditer(r"\{[^{}]*\}", text, re.DOTALL):
        try:
            obj = json.loads(m.group(0))
        except ValueError:
            continue
        if isinstance(obj, dict) and "score" in obj:
            try:
                return float(obj["score"])
            except (TypeError, ValueError):
                continue
    m = re.search(r"(\d+(?:\.\d+)?)", text)
    return float(m.group(1)) if m else None


class LLMJudge:
    """A queue of records scored by ``num_workers`` threads, each with its
    own client."""

    def __init__(
        self,
        client_factory: Optional[Callable] = None,
        model: str = "deepseek-chat",
        num_workers: int = 4,
    ):
        self.model = model
        self.num_workers = num_workers
        if client_factory is None:
            def client_factory():  # type: ignore[no-redef]
                from openai import OpenAI  # type: ignore

                return OpenAI(api_key=os.environ["DEEPSEEK_API_KEY"],
                              base_url="https://api.deepseek.com")

        self.client_factory = client_factory

    def _judge_one(self, client, rec: Dict) -> Optional[float]:
        prompt = INTENT_JUDGE_PROMPT.format(
            content=rec.get("calligraphy_content", ""),
            answer=rec.get("answer", ""),
            reference=rec.get("gt", ""),
        )
        for _ in range(3):
            try:
                resp = client.chat.completions.create(
                    model=self.model,
                    messages=[{"role": "user", "content": prompt}],
                    temperature=0.0,
                )
                score = _parse_json_score(resp.choices[0].message.content)
            except Exception:  # noqa: BLE001 - a failed request is retried, then scored None
                continue
            if score is not None:
                return score
        return None

    def score_result_file(self, result_json_path: str, save_path: Optional[str] = None) -> Dict:
        with open(result_json_path, encoding="utf-8") as f:
            records = json.load(f)["detailed"]
        todo: "queue.Queue" = queue.Queue()
        for i, r in enumerate(records):
            todo.put((i, r))
        scores: List[Optional[float]] = [None] * len(records)

        def worker():
            client = self.client_factory()
            while True:
                try:
                    i, rec = todo.get_nowait()
                except queue.Empty:
                    return
                scores[i] = self._judge_one(client, rec)

        threads = [threading.Thread(target=worker) for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        valid = [s for s in scores if s is not None]
        result = {
            "mean_score": float(np.mean(valid)) if valid else None,
            "judged": len(valid),
            "total": len(records),
            "per_sample": scores,
        }
        if save_path:
            tmp = save_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(result, f, ensure_ascii=False, indent=4)
            os.replace(tmp, save_path)
        return result
