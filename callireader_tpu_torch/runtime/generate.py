"""Generation from input embeddings (PyTorch port of
callireader_tpu/runtime/generate.py): greedy or sampled decoding
(``generate_from_embeds``, ``start_generate``) and beam search
(``beam_generate_from_embeds``).

HF semantics kept from the JAX package: the repetition penalty sees
generated tokens only (generate() was called with inputs_embeds), the
penalty rule is score < 0 ? score * p : score / p, any eos id stops a row,
finished rows emit pad. Sampling applies temperature, then top-k, then top-p
exactly as the JAX ``_sample`` does, and draws with the Gumbel-max rule from
an explicit ``torch.Generator`` (the draws differ from ``jax.random``'s; the
kept set does not).

The JAX decode is one on-device ``lax.while_loop``. Here the loop's state
lives on the device (``DecodeState``: the cache, logits, ``seen``, tokens,
``done``, lengths, the validity mask, the step and slot counters) and
``_decode_chunk`` advances it SYNC_EVERY steps in place with no host read;
on a CUDA device each chunk is a CUDA graph (runtime/decode_graph.py), so a
step costs replays instead of ~900 launches from Python. The host looks at
``done`` between chunks only (each look is a device sync), where the loop
stops; rows already done keep emitting pad, so the extra steps of a chunk
change no token. A ``max_new_tokens`` that is not a multiple of SYNC_EVERY
ends with a tail graph of the remaining steps. Under a mesh (``mesh=``) the
model runs tensor parallel and its KV cache holds the rank's heads; the
graphs capture the collectives, and every rank of the tensor group, on the
same logits, makes the same choices. ``eager=True`` runs the same
chunks uncaptured on the card (tests and chip_smoke.py compare the two); on
the CPU they always run uncaptured. Beam search stays host-stepped.

Every route times its ``prefill`` (the mask's upload, the state, the
prefill) and its ``decode`` (the chunks run or enqueued) as spans of
utils/profiling.SPANS, with their device time between CUDA events: the
prefill's around it, the decode's around each chunk, so that the device time
leaves out the gaps in which the device waits for the host's next chunk.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

import torch

from callireader_tpu_torch.core.config import LLMConfig, MLAMoEConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.models import internlm2, mla_moe
from callireader_tpu_torch.runtime import decode_graph
from callireader_tpu_torch.utils.profiling import SPANS, readback, snapshot_tallies, upload

SYNC_EVERY = 8  # decode steps between host checks of `done`: a chunk, one graph
# decode graphs with their state kept between calls; each holds its KV cache
# (L x B x Hkv x max_len x D x 2 x 2 bytes: 2.1 GB at callireader-8b, B=4,
# 4096 slots) and a memory pool of one chunk's temporaries
GRAPHS = decode_graph.GraphCache(capacity=2)
PROMPT_BUCKETS = (128, 256, 512, 1024, 2048, 3072, 3584, 4096, 6144, 8192)


def llm_family(cfg):
    """The model module of an LLM config: InternLM2, or the MLA-MoE block
    (models/mla_moe.py); both give ``KVCache.create``, ``prefill``,
    ``decode_step_at`` and ``embed_tokens`` with one signature."""
    return mla_moe if isinstance(cfg, MLAMoEConfig) else internlm2


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


@dataclasses.dataclass
class DecodeState:
    """The decode loop's state, on the device and updated in place (the JAX
    while_loop's carry): the cache, the next logits, the seen-token mask, the
    tokens so far, done flags, generated lengths, the attendable slots, the
    index of the next token (``step``) and the cache slot it writes
    (``slot``), both (1,) int64."""

    cache: "internlm2.KVCache | mla_moe.LatentCache"  # the family's cache
    logits: torch.Tensor  # (B, V) in the policy's logits dtype
    seen: torch.Tensor  # (B, V) bool
    tokens: torch.Tensor  # (B, T) int32
    done: torch.Tensor  # (B,) bool
    lengths: torch.Tensor  # (B,) int32
    kv_valid: torch.Tensor  # (B, max_len) int32
    step: torch.Tensor
    slot: torch.Tensor
    eos: torch.Tensor  # (n_eos,) int32
    rows: torch.Tensor  # (B,) int64

    @classmethod
    def create(cls, cfg: LLMConfig, B: int, T: int, max_len: int, eos_ids, device,
               logits_dtype, mesh=None) -> "DecodeState":
        z = dict(device=device)
        return cls(
            cache=llm_family(cfg).KVCache.create(cfg, B, max_len, torch.bfloat16, device, mesh),
            logits=torch.zeros((B, cfg.vocab_size), dtype=logits_dtype, **z),
            seen=torch.zeros((B, cfg.vocab_size), dtype=torch.bool, **z),
            tokens=torch.zeros((B, T), dtype=torch.int32, **z),
            done=torch.zeros((B,), dtype=torch.bool, **z),
            lengths=torch.zeros((B,), dtype=torch.int32, **z),
            kv_valid=torch.zeros((B, max_len), dtype=torch.int32, **z),
            step=torch.zeros((1,), dtype=torch.int64, **z),
            slot=torch.zeros((1,), dtype=torch.int64, **z),
            eos=torch.tensor(eos_ids, dtype=torch.int32, **z),
            rows=torch.arange(B, **z),
        )

    def reset(self, logits: torch.Tensor, attention_mask: torch.Tensor, pad_id: int) -> None:
        """The state after a prefill of S slots: ``logits`` (B, V), the
        prompt's mask (B, S) int32 as the attendable slots."""
        S = attention_mask.shape[1]
        self.logits.copy_(logits)
        self.seen.zero_()
        self.tokens.fill_(pad_id)
        self.done.zero_()
        self.lengths.zero_()
        self.kv_valid.zero_()
        self.kv_valid[:, :S] = attention_mask
        self.step.zero_()
        self.slot.fill_(S)


def _decode_chunk(st: DecodeState, params, cfg: LLMConfig, gen_cfg: GenerateConfig,
                  policy: DTypePolicy, generator: Optional[torch.Generator], n: int,
                  mesh=None) -> None:
    """``n`` steps of the loop on ``st``, in place and without a host read:
    pick each row's token from the current logits, record it, then run the
    decode step that writes it at ``slot`` (JAX generate.py's step_fn)."""
    for _ in range(n):
        logits = _apply_repetition_penalty(st.logits, st.seen, gen_cfg.repetition_penalty)
        next_tok = _sample(logits, gen_cfg, generator)
        next_tok = torch.where(st.done, torch.full_like(next_tok, gen_cfg.pad_token_id), next_tok)
        is_eos = (next_tok[:, None] == st.eos[None, :]).any(dim=-1)
        st.lengths.copy_(torch.where(st.done, st.lengths, st.lengths + 1))
        st.tokens.index_copy_(1, st.step, next_tok[:, None])
        idx = next_tok.long()
        st.seen[st.rows, idx] = st.seen[st.rows, idx] | ~st.done
        st.done.logical_or_(is_eos)
        st.logits.copy_(llm_family(cfg).decode_step_at(
            params, cfg, input_ids=next_tok[:, None], cache=st.cache, kv_valid=st.kv_valid,
            slot=st.slot, policy=policy, mesh=mesh))
        st.step.add_(1)
        st.slot.add_(1)


class _Graphs:
    """One cached decode: its state, its chunk graph of SYNC_EVERY steps and
    a tail graph of the remainder, sharing the chunk's memory pool. Holds no
    reference to the parameters, so that GRAPHS drops the entry when they
    die."""

    def __init__(self, st: DecodeState, chunk: Callable, device,
                 generator: Optional[torch.Generator], mesh=None):
        self.st, self.chunk, self.device, self.generator = st, chunk, device, generator
        self.mesh = mesh
        self.by_steps = {}

    def run(self, params, n: int) -> None:
        g = self.by_steps.get(n)
        if g is None:
            g = self.by_steps[n] = decode_graph.StepGraph(
                self.device, generator=self.generator, share=self.by_steps.get(SYNC_EVERY),
                mesh=self.mesh)
        g(lambda: self.chunk(params, n))


class DecodeRun:
    """A greedy or sampled decode after its prefill (``start_generate``):
    its plan of chunks (SYNC_EVERY steps each, then the remainder).

    ``finish()`` runs the chunks not yet run, looking at ``done`` before
    each (the loop stops at the first chunk boundary where every row is
    done, as the JAX while_loop stops at the first step), and returns
    (tokens, lengths). ``enqueue_all()`` puts every chunk on the stream at
    once and returns (tokens, lengths) without a host read: the counterpart
    of the JAX async dispatch, so that the host can prepare the next batch
    while this one decodes. An enqueued loop cannot stop early: the chunks
    after every row is done run as pad steps (no token changes;
    ``pad_steps`` counts them). Both return copies, so that the next decode
    through the same graphs (which resets this state in stream order) leaves
    the result alone."""

    def __init__(self, st: DecodeState, plan: List[Tuple[int, Callable[[], None]]],
                 on_error: Callable[[], None]):
        self.st, self.plan, self.on_error = st, plan, on_error
        self.next = 0  # chunks run so far
        self.steps = 0  # decode steps run so far

    @torch.inference_mode()
    def step(self) -> bool:
        """Runs the next chunk (no look at ``done``); False if none is left."""
        if self.next == len(self.plan):
            return False
        n, fn = self.plan[self.next]
        try:
            with SPANS.device("decode"):
                fn()
        except Exception:
            self.on_error()
            raise
        self.next, self.steps = self.next + 1, self.steps + n
        return True

    def _result(self) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.inference_mode():
            return self.st.tokens.clone(), self.st.lengths.clone()

    def enqueue_all(self) -> Tuple[torch.Tensor, torch.Tensor]:
        while self.step():
            pass
        return self._result()

    def finish(self) -> Tuple[torch.Tensor, torch.Tensor]:
        while not (self.steps and bool(readback(self.st.done.all()))) and self.step():
            pass
        return self._result()


def pad_steps(tokens: np.ndarray, lengths: np.ndarray, eos_ids: Sequence[int]) -> int:
    """The steps of an enqueued T-step decode (``DecodeRun.enqueue_all``)
    that ``finish()`` would not have run: those after the first chunk
    boundary where every row had emitted an eos."""
    T = tokens.shape[1]
    last = tokens[np.arange(tokens.shape[0]), np.maximum(lengths, 1) - 1]
    if tokens.shape[0] == 0 or not np.isin(last, eos_ids).all():
        return 0
    stop = max(SYNC_EVERY, -(-int(lengths.max()) // SYNC_EVERY) * SYNC_EVERY)
    return T - min(T, stop)


def _plan(T: int) -> List[int]:
    """Step counts of the chunks of a T-step decode: SYNC_EVERY each, then
    the remainder."""
    return [SYNC_EVERY] * (T // SYNC_EVERY) + ([T % SYNC_EVERY] if T % SYNC_EVERY else [])


@torch.inference_mode()
def start_generate(
    params,
    cfg: LLMConfig,
    inputs_embeds: torch.Tensor,  # (B, S, E), left-padded to a bucket
    attention_mask: torch.Tensor,  # (B, S) 1 = valid
    *,
    gen_cfg: GenerateConfig,
    max_cache_len: int,
    generator: Optional[torch.Generator] = None,
    policy: DTypePolicy = DEFAULT_POLICY,
    eager: bool = False,
    mesh=None,
) -> DecodeRun:
    """The prefill, enqueued, and the decode loop ready to run -> a
    DecodeRun. On a CUDA device (unless ``eager``) the state and the chunk
    graphs come from ``GRAPHS``, keyed by (config, B, cache capacity, T,
    sampling knobs, policy, device, generator) and the parameters' identity:
    a repeated call replays graphs captured by an earlier one, on the same
    state: run (or enqueue) a DecodeRun's chunks before the next call with
    the same key. ``generator`` drives the draws when ``gen_cfg.do_sample``
    (default: seeded 0 anew on each call). ``mesh``: tensor parallel, the
    parameters the rank's blocks (models/internlm2.py)."""
    B, S, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    T = gen_cfg.max_new_tokens
    if gen_cfg.num_beams > 1:
        raise ValueError("beam search is beam_generate_from_embeds")
    own_generator = gen_cfg.do_sample and generator is None
    if not gen_cfg.do_sample:
        generator = None

    def build() -> _Graphs:
        gen = torch.Generator(device=dev) if own_generator else generator
        st = DecodeState.create(cfg, B, T, max_cache_len, gen_cfg.eos_token_ids, dev,
                                policy.logits_dtype, mesh)
        return _Graphs(st, lambda p, n: _decode_chunk(st, p, cfg, gen_cfg, policy, gen, n, mesh),
                       dev, gen, mesh)

    graphed = dev.type == "cuda" and not eager
    with SPANS.span("prefill"):
        attention_mask = upload(attention_mask, dev, torch.int32)
        if graphed:
            key = (cfg, B, max_cache_len, T, gen_cfg, policy, str(dev),
                   None if own_generator else id(generator), id(mesh))
            g = GRAPHS.get(key, params, build)
        else:
            g = build()
        if own_generator:
            g.generator.manual_seed(0)
        with SPANS.device("prefill"):
            logits, _ = llm_family(cfg).prefill(
                params, cfg, inputs_embeds=inputs_embeds, attention_mask=attention_mask,
                max_len=max_cache_len, policy=policy, cache=g.st.cache, mesh=mesh,
            )
            g.st.reset(logits, attention_mask, gen_cfg.pad_token_id)
    run = g.run if graphed else g.chunk
    plan = [(n, lambda n=n: run(params, n)) for n in _plan(T)]
    return DecodeRun(g.st, plan, on_error=lambda: GRAPHS.discard(g))


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
    eager: bool = False,
    overlap: bool = False,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (tokens (B, max_new_tokens) int32, pad after eos; lengths (B,)
    int32, generated count including eos). ``generator`` drives the draws
    when ``gen_cfg.do_sample`` (default: seeded 0 on the embeddings' device).
    On a CUDA device the chunks are CUDA graphs unless ``eager``.
    ``overlap``: every chunk is enqueued and the call returns before the
    decode retires (``DecodeRun.enqueue_all``; rows done early run pad
    steps); else it stops at the first chunk boundary where all rows are
    done."""
    run = start_generate(params, cfg, inputs_embeds, attention_mask, gen_cfg=gen_cfg,
                         max_cache_len=max_cache_len, generator=generator, policy=policy,
                         eager=eager, mesh=mesh)
    with SPANS.span("decode"):
        out = run.enqueue_all() if overlap else run.finish()
    snapshot_tallies()  # the device tallies as this decode leaves them, read back with its tokens
    return out


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
    mesh=None,
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
    if isinstance(cfg, MLAMoEConfig):
        raise NotImplementedError("beam search reorders InternLM2's K/V cache; the MLA-MoE LLM "
                                  "decodes greedy or sampled only")
    if B != 1:
        raise ValueError(f"beam search serves a single prompt, got {B} rows")
    dev = inputs_embeds.device
    T = gen_cfg.max_new_tokens
    neg_inf = -1e30
    with SPANS.span("prefill"):
        attention_mask = upload(attention_mask, dev, torch.int32)
        with SPANS.device("prefill"):
            logits, cache = internlm2.prefill(
                params, cfg, inputs_embeds=inputs_embeds, attention_mask=attention_mask,
                max_len=max_cache_len, policy=policy, mesh=mesh,
            )
    with SPANS.span("decode"):
        eos = upload(torch.tensor(gen_cfg.eos_token_ids, dtype=torch.int32), dev)
        with SPANS.device("decode"):
            cache = internlm2.KVCache(cache.k.repeat_interleave(k, dim=1),
                                      cache.v.repeat_interleave(k, dim=1), cache.length)
            logits = logits.repeat(k, 1)
            V = logits.shape[-1]
            kv_valid = torch.zeros((k, max_cache_len), dtype=torch.int32, device=dev)
            kv_valid[:, :S] = attention_mask
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
                if i % SYNC_EVERY == 0 and i > 0 and bool(readback(done.all())):
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
                    policy=policy, mesh=mesh,
                )
        norm = scores / torch.clamp(lengths.float(), min=1.0)
        best = int(readback(torch.argmax(norm)))
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
