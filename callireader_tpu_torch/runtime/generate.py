"""Greedy generation from input embeddings (PyTorch port of
callireader_tpu/runtime/generate.py, greedy path).

HF semantics kept from the JAX package: the repetition penalty sees
generated tokens only (generate() was called with inputs_embeds), the
penalty rule is score < 0 ? score * p : score / p, any eos id stops a row,
finished rows emit pad. The JAX loop is one on-device while_loop; here the
loop runs on the host and looks at ``done`` only every SYNC_EVERY steps
(each look is a device sync). Rows already done keep emitting pad, so the
extra steps change no token.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from callireader_tpu_torch.core.config import LLMConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.models import internlm2

SYNC_EVERY = 8  # decode steps between host checks of `done`
PROMPT_BUCKETS = (128, 256, 512, 1024, 2048, 3072, 3584, 4096, 6144, 8192)


def bucket_length(n: int, buckets: Sequence[int] = PROMPT_BUCKETS) -> int:
    for b in buckets:
        if b >= n:
            return b
    raise ValueError(f"prompt length {n} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 1024
    eos_token_ids: Tuple[int, ...] = (92542,)
    pad_token_id: int = 2
    repetition_penalty: float = 1.0


def _apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor, penalty: float) -> torch.Tensor:
    """logits (B, V) f32; seen (B, V) bool."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen, penalized, logits)


@torch.inference_mode()
def generate_from_embeds(
    params,
    cfg: LLMConfig,
    inputs_embeds: torch.Tensor,  # (B, S, E), left-padded to a bucket
    attention_mask: torch.Tensor,  # (B, S) 1 = valid
    *,
    gen_cfg: GenerateConfig,
    max_cache_len: int,
    policy: DTypePolicy = DEFAULT_POLICY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, max_new_tokens) int32, pad after eos; lengths (B,)
    int32, generated count including eos)."""
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    T = gen_cfg.max_new_tokens
    attention_mask = attention_mask.to(dev, torch.int32)
    logits, cache = internlm2.prefill(
        params, cfg, inputs_embeds=inputs_embeds, attention_mask=attention_mask,
        max_len=max_cache_len, policy=policy,
    )
    kv_valid = torch.zeros((B, max_cache_len), dtype=torch.int32, device=dev)
    kv_valid[:, :S] = attention_mask
    eos = torch.tensor(gen_cfg.eos_token_ids, dtype=torch.int32, device=dev)
    seen = torch.zeros((B, logits.shape[-1]), dtype=torch.bool, device=dev)
    tokens = torch.full((B, T), gen_cfg.pad_token_id, dtype=torch.int32, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((B,), dtype=torch.int32, device=dev)
    rows = torch.arange(B, device=dev)

    for i in range(T):
        if i % SYNC_EVERY == 0 and i > 0 and bool(done.all()):
            break
        logits = _apply_repetition_penalty(logits, seen, gen_cfg.repetition_penalty)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        next_tok = torch.where(done, torch.full_like(next_tok, gen_cfg.pad_token_id), next_tok)
        is_eos = (next_tok[:, None] == eos[None, :]).any(dim=-1)
        lengths = torch.where(done, lengths, lengths + 1)
        tokens[:, i] = next_tok
        seen[rows, next_tok.long()] = seen[rows, next_tok.long()] | ~done
        done = done | is_eos
        kv_valid[:, cache.length] = 1
        logits, cache = internlm2.decode_step(
            params, cfg, input_ids=next_tok[:, None], cache=cache,
            kv_valid_mask=kv_valid, policy=policy,
        )
    return tokens, lengths
