"""Programmatic API (PyTorch port of callireader_tpu/apis.py).

    from callireader_tpu_torch import apis

    engine = apis.load_engine(preset="callireader-8b", checkpoint="InternVL/", quant="int8")
    text = apis.recognize(engine, "page.npy")
    answer, history = apis.ask(engine, "page.npy", "作者是谁？")
    out_dir = apis.finetune("ann.jsonl", image_root="pages/", max_iters=100)
    result = apis.evaluate_full_page(engine, "CalliBench/full_page_ocr/easy/easy.parquet")

``checkpoint`` is a reference-layout directory (cli/common.py); without one,
``random_init`` must be set.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def load_engine(
    preset: str = "callireader-8b",
    checkpoint: Optional[str] = None,
    random_init: bool = False,
    *,
    quant: Optional[str] = None,
    adapter: Optional[str] = None,
    device: str = "cuda",
):
    from callireader_tpu_torch.cli.common import build_engine

    return build_engine(preset=preset, checkpoint_dir=checkpoint, random_init_ok=random_init,
                        quant=quant, adapter_path=adapter, device=device)


def recognize(engine, image, *, use_p: bool = True, repetition_penalty: float = 1.0,
              max_new_tokens: int = 1024) -> str:
    """Full-page recognition (the reference inference.py's single-image run)."""
    return engine.chat_ocr(image, "这幅书法作品内容是什么？", use_p=use_p,
                           repetition_penalty=repetition_penalty, max_new_tokens=max_new_tokens)


def ask(engine, image, question: str, *, history: Optional[List[Tuple[str, str]]] = None,
        use_p: bool = True, max_new_tokens: int = 1024):
    """-> (answer, history)."""
    return engine.chat_ocr(image, question, history=history, return_history=True, use_p=use_p,
                           max_new_tokens=max_new_tokens)


def finetune(
    annotation_path: str, *, image_root: str = "", out_dir: str = "./work_dir",
    preset: str = "callireader-8b", checkpoint: Optional[str] = None,
    max_iters: int = 100, batch_size: int = 2,
    lora_rank: int = 128, lora_alpha: float = 256.0, learning_rate: float = 5e-5,
    device: str = "cuda",
) -> str:
    """e-IT fine-tuning through cli.train (random weights when no
    ``checkpoint`` is given) -> the work dir; its ``final/`` is what
    ``load_engine(adapter=...)`` serves."""
    from callireader_tpu_torch.cli import train as train_cli

    argv = ["--data", annotation_path, "--image-root", image_root, "--out", out_dir,
            "--preset", preset, "--batch-size", str(batch_size), "--max-iters", str(max_iters),
            "--lora-rank", str(lora_rank), "--lora-alpha", str(lora_alpha),
            "--lr", str(learning_rate), "--device", device]
    argv += ["--checkpoint", checkpoint] if checkpoint else ["--random-init"]
    train_cli.main(argv)
    return out_dir


def evaluate_full_page(engine, parquet_path: str, save_json_path: Optional[str] = None, **kw):
    """CalliBench full-page OCR on one parquet split -> the result dict
    (written to ``save_json_path`` when given)."""
    from callireader_tpu_torch.evalx import callibench

    return callibench.test_full_page(engine, parquet_path, save_json_path, **kw)
