"""Generation from input embeddings (PyTorch port of
callireader_tpu/runtime/generate.py): greedy or sampled decoding
(``generate_from_embeds``) and beam search (``beam_generate_from_embeds``).

HF semantics kept from the JAX package: the repetition penalty sees
generated tokens only (generate() was called with inputs_embeds), the
penalty rule is score < 0 ? score * p : score / p, any eos id stops a row,
finished rows emit pad. Sampling applies temperature, then top-k, then top-p
exactly as the JAX ``_sample`` does, and draws with the Gumbel-max rule from
an explicit ``torch.Generator`` (the draws differ from ``jax.random``'s; the
kept set does not). The JAX loops are on-device while_loops; here the loops
run on the host and look at ``done`` only every SYNC_EVERY steps (each look
is a device sync). Rows already done keep emitting pad, so the extra steps
change no token.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

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
    do_sample: bool = False
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    # > 1: beam search (beam_generate_from_embeds), one prompt only; the
    # reference inherits num_beams from HF generate but always passes 1
    num_beams: int = 1


def _apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor, penalty: float) -> torch.Tensor:
    """logits (B, V) f32; seen (B, V) bool."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen, penalized, logits)


def _filter_logits(logits: torch.Tensor, gen_cfg: GenerateConfig) -> torch.Tensor:
    """Temperature, then top-k, then top-p: every logit outside the kept set
    becomes -inf (the JAX ``_sample``'s order and ties: a logit equal to the
    k-th largest, or to the top-p cutoff, is kept)."""
    logits = logits / max(gen_cfg.temperature, 1e-6)
    if gen_cfg.top_k > 0:
        kth = torch.sort(logits, dim=-1).values[:, -gen_cfg.top_k][:, None]
        logits = torch.where(logits < kth, float("-inf"), logits)
    if gen_cfg.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < gen_cfg.top_p).sum(dim=-1)
        cutoff = torch.gather(sorted_logits, 1, cutoff_idx[:, None])
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    return logits


def _sample(logits: torch.Tensor, gen_cfg: GenerateConfig,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """(B, V) fp32 logits -> (B,) int32: argmax, or a draw from the filtered
    distribution (Gumbel-max, as jax.random.categorical)."""
    if not gen_cfg.do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = _filter_logits(logits, gen_cfg)
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits + gumbel, dim=-1).to(torch.int32)


@torch.inference_mode()
def generate_from_embeds(
    params,
    cfg: LLMConfig,
    inputs_embeds: torch.Tensor,  # (B, S, E), left-padded to a bucket
    attention_mask: torch.Tensor,  # (B, S) 1 = valid
    *,
    gen_cfg: GenerateConfig,
    max_cache_len: int,
    generator: Optional[torch.Generator] = None,
    policy: DTypePolicy = DEFAULT_POLICY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, max_new_tokens) int32, pad after eos; lengths (B,)
    int32, generated count including eos). ``generator`` drives the draws
    when ``gen_cfg.do_sample`` (default: seeded 0 on the embeddings' device)."""
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
    if gen_cfg.do_sample and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    for i in range(T):
        if i % SYNC_EVERY == 0 and i > 0 and bool(done.all()):
            break
        logits = _apply_repetition_penalty(logits, seen, gen_cfg.repetition_penalty)
        next_tok = _sample(logits, gen_cfg, generator)
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


@torch.inference_mode()
def beam_generate_from_embeds(
    params,
    cfg: LLMConfig,
    inputs_embeds: torch.Tensor,  # (1, S, E): beams serve one prompt
    attention_mask: torch.Tensor,  # (1, S)
    *,
    gen_cfg: GenerateConfig,
    max_cache_len: int,
    policy: DTypePolicy = DEFAULT_POLICY,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam search over ``gen_cfg.num_beams`` fixed beam slots (HF generate
    with do_sample=False, length_penalty 1.0: the final ranking is
    sum-logprob / length; the repetition penalty per beam over its own
    tokens). A finished beam keeps its slot at a frozen score and emits pad.
    The prompt prefills once; the stacked (L, k, Hkv, S, D) cache is reordered
    by parent every step with ``index_select`` on dim 1. Returns (tokens
    (1, T), lengths (1,)) of the best beam, generate_from_embeds' contract."""
    k = gen_cfg.num_beams
    B, S, _ = inputs_embeds.shape
    if B != 1:
        raise ValueError(f"beam search serves a single prompt, got {B} rows")
    dev = inputs_embeds.device
    T = gen_cfg.max_new_tokens
    neg_inf = -1e30
    attention_mask = attention_mask.to(dev, torch.int32)
    logits, cache = internlm2.prefill(
        params, cfg, inputs_embeds=inputs_embeds, attention_mask=attention_mask,
        max_len=max_cache_len, policy=policy,
    )
    cache = internlm2.KVCache(cache.k.repeat_interleave(k, dim=1),
                              cache.v.repeat_interleave(k, dim=1), cache.length)
    logits = logits.repeat(k, 1)
    V = logits.shape[-1]
    kv_valid = torch.zeros((k, max_cache_len), dtype=torch.int32, device=dev)
    kv_valid[:, :S] = attention_mask
    eos = torch.tensor(gen_cfg.eos_token_ids, dtype=torch.int32, device=dev)
    pad_col = torch.arange(V, device=dev) == gen_cfg.pad_token_id
    seen = torch.zeros((k, V), dtype=torch.bool, device=dev)
    # only beam 0 is live at step 0 (all beams hold the same prompt)
    scores = torch.full((k,), neg_inf, dtype=torch.float32, device=dev)
    scores[0] = 0.0
    tokens = torch.full((k, T), gen_cfg.pad_token_id, dtype=torch.int32, device=dev)
    done = torch.zeros((k,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((k,), dtype=torch.int32, device=dev)
    rows = torch.arange(k, device=dev)

    for i in range(T):
        if i % SYNC_EVERY == 0 and i > 0 and bool(done.all()):
            break
        lp = torch.log_softmax(
            _apply_repetition_penalty(logits.float(), seen, gen_cfg.repetition_penalty), dim=-1)
        # live beams fan out over the vocab; a finished beam offers one
        # candidate, itself extended by pad at its frozen score
        cand = torch.where(done[:, None],
                           torch.where(pad_col[None, :], scores[:, None], neg_inf),
                           scores[:, None] + lp)
        top_scores, top_idx = torch.topk(cand.reshape(-1), k)
        parent = top_idx // V
        tok = (top_idx % V).to(torch.int32)
        cache.k = cache.k.index_select(1, parent)
        cache.v = cache.v.index_select(1, parent)
        seen, tokens, done = seen[parent], tokens[parent], done[parent]
        lengths, kv_valid = lengths[parent], kv_valid[parent]

        is_eos = (tok[:, None] == eos[None, :]).any(dim=-1)
        tok = torch.where(done, torch.full_like(tok, gen_cfg.pad_token_id), tok)
        lengths = torch.where(done, lengths, lengths + 1)
        tokens[:, i] = tok
        seen[rows, tok.long()] = seen[rows, tok.long()] | ~done
        done = done | is_eos
        scores = top_scores
        kv_valid[:, cache.length] = 1
        logits, cache = internlm2.decode_step(
            params, cfg, input_ids=tok[:, None], cache=cache, kv_valid_mask=kv_valid,
            policy=policy,
        )
    norm = scores / torch.clamp(lengths.float(), min=1.0)
    best = int(torch.argmax(norm))
    return tokens[best][None], lengths[best][None]


def pad_embeds_left(embeds_list, pad_embed, bucket: Optional[int] = None):
    """Host helper: left-pad a list of (S_i, E) numpy arrays to a common
    bucketed length -> (embeds (B, S, E), mask (B, S) int32)."""
    S = bucket_length(max(e.shape[0] for e in embeds_list)) if bucket is None else bucket
    B = len(embeds_list)
    out = np.tile(np.asarray(pad_embed, dtype=embeds_list[0].dtype)[None, None, :], (B, S, 1))
    mask = np.zeros((B, S), np.int32)
    for i, e in enumerate(embeds_list):
        out[i, S - e.shape[0]:] = e
        mask[i, S - e.shape[0]:] = 1
    return out, mask
