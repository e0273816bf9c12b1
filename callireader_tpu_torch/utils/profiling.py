"""Wall-clock spans and training throughput accounting (PyTorch port of
callireader_tpu/utils/profiling.py: ``Spans``, ``llm_flops_per_token``,
``TrainThroughput``). The XLA trace helpers (``trace``, ``parse_xplane``) have
no counterpart here: torch.profiler traces the card directly.

Spans and throughput read the host clock: on CUDA a span measures device
work only where the code inside it synchronises (the train CLI's step reads
its loss, which does).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional


class Spans:
    """Named wall-clock span aggregation."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.add(name, time.time() - t0)

    def add(self, name: str, dt: float):
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            t = self.totals[name]
            lines.append(f"{name:24s} {t:8.3f}s  x{n:<5d} ({t / max(n, 1) * 1000:8.1f} ms/call)")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


def llm_flops_per_token(
    hidden: int, intermediate: int, num_layers: int, vocab: int,
    num_q_heads: int, num_kv_heads: int, head_dim: int, seq_len: int,
    causal: bool = True, backward: bool = False,
) -> float:
    """FLOPs per processed token of the LLM's products (causal attention
    counts half the context), times 3 with the backward."""
    qkv = 2 * hidden * (num_q_heads + 2 * num_kv_heads) * head_dim
    o = 2 * num_q_heads * head_dim * hidden
    mlp = 3 * 2 * hidden * intermediate
    attn_ctx = seq_len if not causal else seq_len / 2
    attn = 2 * 2 * num_q_heads * head_dim * attn_ctx
    per_layer = qkv + o + mlp + attn
    total = per_layer * num_layers + 2 * hidden * vocab
    return total * (3 if backward else 1)


class TrainThroughput:
    """tokens/s and model TFLOP/s across train steps. The clock starts at the
    first ``step`` call, so the first step's tokens count but not its time."""

    def __init__(self, cfg, seq_len: int):
        llm = cfg.llm
        self.flops_per_token = llm_flops_per_token(
            llm.hidden_size, llm.intermediate_size, llm.num_hidden_layers,
            llm.vocab_size, llm.num_attention_heads, llm.num_key_value_heads,
            llm.head_dim, seq_len, causal=True, backward=True,
        )
        self._t0: Optional[float] = None
        self.tokens = 0
        self.steps = 0

    def start(self):
        self._t0 = time.time()

    def step(self, batch_tokens: int) -> Dict[str, float]:
        if self._t0 is None:
            self.start()
        self.tokens += batch_tokens
        self.steps += 1
        dt = max(time.time() - self._t0, 1e-9)
        tps = self.tokens / dt
        return {
            "tokens_per_sec": tps,
            "tflops_per_sec": tps * self.flops_per_token / 1e12,
            "steps_per_sec": self.steps / dt,
        }
