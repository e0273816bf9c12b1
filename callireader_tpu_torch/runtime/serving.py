"""Continuous-batching serving scheduler (PyTorch port of
callireader_tpu/runtime/serving.py).

A fixed pool of KV-cache slots is kept busy: requests prefill into free slots
as they arrive and every active slot advances one token per device step, so
short answers retire early and their slots are refilled without waiting for
the longest request of a batch.

Device work:
  - multi-row prefill (internlm2.prefill at the prompt bucket; same-bucket
    admissions share one call, which amortizes the weight reads)
  - multi-slot decode (internlm2.decode_step_multislot over the slot pool),
    optionally ``steps_per_sync`` steps per host tick
  - the token pick on the device (repetition penalty + argmax + seen mask)
The host keeps the queue and slot bookkeeping, O(slots) Python per tick, with
B (or k * B) token ids as the only device-to-host traffic.

Where the JAX package is functional (donated buffers, per-shape ``jax.jit``
caches, a ``lax.scan`` window), the port updates IN PLACE: the one slot
cache, ``seen`` and ``last_logits`` are written by index. A tick's decode
(one step, or the window of k steps with its picks) reads static input
buffers that the host fills with ``copy_`` (``TickInputs``) and is a CUDA
graph on the card (runtime/decode_graph.py: its first tick runs eagerly and
is captured, later ticks replay it), with one device-to-host copy of the
picked ids at its end; on the CPU the same function runs uncaptured.
Admission (prefill) runs eagerly. Under a mesh (``mesh=``) the model runs
tensor parallel on the rank's blocks of the params, and the slot cache (the
page pool of runtime/paged_cache.py) holds the rank's KV heads; the
bookkeeping, the page tables and the picks are the same on every rank.
Everything that launches work runs inside ``torch.inference_mode()``, which is
thread-local: ``submit``, ``register_prefix`` and ``step`` each enter it on
the thread that calls them. All launches go to that thread's current stream;
``submit`` called from another thread uploads on the same (default) stream,
so the upload is ordered before the prefill that reads it.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from callireader_tpu_torch.core.config import LLMConfig, MLAMoEConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.models import internlm2
from callireader_tpu_torch.runtime import decode_graph
from callireader_tpu_torch.runtime import generate as gen


def _penalize(logits: torch.Tensor, seen: torch.Tensor, pens: torch.Tensor) -> torch.Tensor:
    """HF repetition penalty over the already-seen vocab rows, per slot."""
    pen = torch.where(logits < 0, logits * pens[:, None], logits / pens[:, None])
    return torch.where(seen, pen, logits)


def _pick_tokens(logits: torch.Tensor, seen: torch.Tensor, pens: torch.Tensor) -> torch.Tensor:
    """HF repetition penalty + greedy argmax for every slot, on the device.
    Marks the picked ids in ``seen`` in place; returns (B,) int32."""
    toks = torch.argmax(_penalize(logits, seen, pens), dim=-1)
    # a device value: a host scalar would be a host-to-device copy, which a
    # CUDA graph capture refuses
    rows = torch.arange(seen.shape[0], device=seen.device)
    seen[rows, toks] = torch.ones_like(toks, dtype=torch.bool)
    return toks.to(torch.int32)


class TickInputs:
    """The static (B,) inputs of a batcher's tick on the device, filled from
    the host before each run so that a captured tick reads them anew: the
    first tokens, lengths, starts, active mask and repetition penalties (and
    the paged batcher's page table, ``extra``)."""

    def __init__(self, B: int, device, **extra: torch.Tensor):
        self.tokens = torch.zeros((B,), dtype=torch.int32, device=device)
        self.lengths = torch.zeros((B,), dtype=torch.int64, device=device)
        self.starts = torch.zeros((B,), dtype=torch.int64, device=device)
        self.active = torch.zeros((B,), dtype=torch.int64, device=device)
        self.pens = torch.ones((B,), dtype=torch.float32, device=device)
        for name, t in extra.items():
            setattr(self, name, t)

    def fill(self, **host: Any) -> None:
        """name=numpy array or device tensor -> copied into the buffer."""
        for name, a in host.items():
            src = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
            getattr(self, name).copy_(src)


@dataclasses.dataclass
class Request:
    uid: int
    embeds: np.ndarray  # (S, E) prompt embeddings (post-splice)
    max_new_tokens: int = 1024
    eos_token_ids: Tuple[int, ...] = (92542,)
    repetition_penalty: float = 1.0
    # filled on completion:
    tokens: Optional[List[int]] = None
    # set instead of tokens when the request is rejected at admission (prompt
    # exceeds the cache capacity): the request fails, never the server
    error: Optional[str] = None
    # device-resident copy of `embeds`, populated at submit() so the upload
    # does not stall admission
    dev_embeds: Optional[torch.Tensor] = None
    # memoized prefix digests: plen -> sha1 of embeds[:plen]. Populated at
    # submit() so the scheduler's admission matching never hashes multi-MB
    # prompt rows between decode ticks
    digests: Dict[int, bytes] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class PrefixEntry:
    """One cached prompt prefix: its embed-row digest + device KV. The KV
    tensors own their storage (a view would keep a whole prefill cache alive)."""

    digest: bytes
    plen: int
    k: torch.Tensor  # (L, Hkv, plen, D)
    v: torch.Tensor
    last_used: int = 0  # monotone tick for LRU eviction


def _digest_rows(embeds: np.ndarray) -> bytes:
    return hashlib.sha1(np.ascontiguousarray(embeds, np.float32).tobytes()).digest()


class PrefixCacheMixin:
    """Prefix KV cache shared by the contiguous and paged batchers: register a
    prompt prefix once (system prompt, chat history, agent transcript); later
    requests whose leading embed rows match bit-exactly prefill only their
    suffix via internlm2.prefill_with_prefix. Host classes provide
    ``params/cfg/policy/device``, ``_prefill_fn(bucket)`` (a prefill whose
    cache holds exactly the bucket), a ``_cache_dtype`` property and
    ``_prefix_capacity()``."""

    def _init_prefix_cache(self) -> None:
        self.prefixes: List[PrefixEntry] = []
        self.prefix_hits = 0
        # registered-prefix KV is device memory ((L, Hkv, plen, D) each);
        # cap the registry and evict the least-recently-hit entry past it
        self.max_prefixes = 8

    def _to_dev(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, dtype)

    def _req_rows(self, req: Request) -> torch.Tensor:
        return req.dev_embeds if req.dev_embeds is not None else self._to_dev(req.embeds)

    @torch.inference_mode()
    def register_prefix(self, embeds: np.ndarray, *, quantum: int = 128) -> int:
        """Prefill ``embeds`` once and cache its KV. Subsequent requests whose
        prompt starts with these embed rows (bit-exact) prefill only the
        remainder. The cached length is floored to a ``quantum`` multiple and
        clamped below the batcher's cache capacity (a hit must leave suffix
        room). If a shorter registered prefix already covers the leading
        rows, only the delta is prefilled (chunked, over the cached KV).
        Returns the cached length in tokens (0 = not cacheable)."""
        cap = self._prefix_capacity()
        plen = (min(embeds.shape[0], cap - quantum) // quantum) * quantum
        if plen <= 0:
            return 0
        rows = embeds[:plen]
        digest = _digest_rows(rows)
        base: Optional[PrefixEntry] = None
        for e in self.prefixes:  # kept sorted by -plen: first hit is longest
            if e.plen == plen and e.digest == digest:
                e.last_used = self.prefix_hits
                return plen
            if base is None and e.plen < plen and _digest_rows(rows[: e.plen]) == e.digest:
                base = e
        if base is not None:
            k, v = self._extend_prefix_kv(base, rows[base.plen:])
        else:
            _logits, cache = self._prefill_fn(plen)(
                self.params, self._to_dev(rows)[None],
                torch.ones((1, plen), dtype=torch.int32, device=self.device),
            )
            # the prefill's cache holds exactly plen positions of one row, so
            # the entry owns it whole (a slice of a larger cache would pin it)
            k, v = cache.k[:, 0], cache.v[:, 0]
        self.prefixes.append(PrefixEntry(
            digest=digest, plen=plen, k=k, v=v, last_used=self.prefix_hits,
        ))
        if len(self.prefixes) > self.max_prefixes:
            self.prefixes.remove(min(self.prefixes, key=lambda e: e.last_used))
        self.prefixes.sort(key=lambda e: -e.plen)
        return plen

    def _extend_prefix_kv(self, base: PrefixEntry, suffix_rows: np.ndarray):
        """KV for ``[base | suffix_rows]`` via one chunked prefill over the
        base entry's cached KV. suffix_rows is unpadded, so the returned
        layout is exactly ``[prefix | suffix]`` at rows [0, total) of a cache
        of that capacity (which the entry then owns whole)."""
        sb = int(suffix_rows.shape[0])
        total = base.plen + sb
        _logits, cache = self._prefill_prefix_fn(total)(
            self.params, self._to_dev(suffix_rows)[None],
            torch.ones((1, sb), dtype=torch.int32, device=self.device), base.k, base.v,
        )
        return cache.k[:, 0], cache.v[:, 0]

    def _req_digest(self, req: Request, plen: int) -> bytes:
        d = req.digests.get(plen)
        if d is None:
            d = _digest_rows(req.embeds[:plen])
            req.digests[plen] = d
        return d

    def _prehash(self, req: Request) -> None:
        """Memoize the request's digests at the currently registered plens,
        from submit(), so admission matching is dictionary lookups. Iterates a
        snapshot: register_prefix may mutate self.prefixes meanwhile (a missed
        entry only costs a memoization)."""
        for e in list(self.prefixes):
            if req.embeds.shape[0] > e.plen:
                self._req_digest(req, e.plen)

    def _match_prefix(self, req: Request) -> Optional[PrefixEntry]:
        # longest registered prefix that leaves >= 1 suffix token (the chunked
        # prefill computes next-token logits from the suffix's last row)
        for e in self.prefixes:
            if req.embeds.shape[0] > e.plen and self._req_digest(req, e.plen) == e.digest:
                e.last_used = self.prefix_hits
                return e
        return None

    def _prefill_prefix_fn(self, max_len: int) -> Callable:
        """Chunked prefill emitting a cache of capacity ``max_len`` (prefix +
        suffix width: the callers consume exactly that region)."""
        return lambda p, e, m, pk, pv: internlm2.prefill_with_prefix(
            p, self.cfg, inputs_embeds=e, attention_mask=m, prefix_k=pk, prefix_v=pv,
            max_len=max_len, policy=self.policy, cache_dtype=self._cache_dtype, mesh=self.mesh,
        )

    def _group_admissions(self, reqs_with_buckets):
        """(req, bucket, payload) triples -> {(bucket, digest): (entry, [(req, payload)])}.

        Keyed by the matched entry's DIGEST, not its plen: two different
        registered prefixes can share a (quantized) length, and collapsing
        their hits into one group would prefill every request in it against
        the first entry's KV. Callers read plen off the group's entry."""
        by_key: Dict[Tuple[int, bytes], Tuple[Optional[PrefixEntry], List[Any]]] = {}
        for req, bucket, payload in reqs_with_buckets:
            entry = self._match_prefix(req) if self.prefixes else None
            key = (bucket, entry.digest if entry is not None else b"")
            by_key.setdefault(key, (entry, []))[1].append((req, payload))
        return by_key

    def _left_padded(self, reqs, width: int, skip: int = 0):
        """Rows ``embeds[skip:]`` of each request, left-padded on the device
        to ``width`` -> (stack (n, width, E), mask (n, width))."""
        rows = []
        mask = np.zeros((len(reqs), width), np.int32)
        for i, req in enumerate(reqs):
            n = req.embeds.shape[0] - skip
            # one dtype for the stack (a caller-provided device row may be
            # bf16, a re-uploaded one float32); prefill casts to it anyway
            e = self._req_rows(req)[skip:].to(self.policy.compute_dtype)
            rows.append(torch.nn.functional.pad(e, (0, 0, width - n, 0)))
            mask[i, width - n:] = 1
        return torch.stack(rows), self._to_dev(mask)

    def _prefill_group(self, entry: Optional[PrefixEntry], reqs, bucket: int):
        """One prefill for an admission group: chunked over the group's prefix
        entry, or whole. -> (logits (n, V), cache)."""
        if entry is not None:
            stack, mask = self._left_padded(reqs, bucket - entry.plen, skip=entry.plen)
            self.prefix_hits += len(reqs)
            return self._prefill_prefix_fn(bucket)(
                self.params, stack, mask, entry.k, entry.v)
        stack, mask = self._left_padded(reqs, bucket)
        return self._prefill_fn(bucket)(self.params, stack, mask)


class ContinuousBatcher(PrefixCacheMixin):
    def __init__(
        self,
        llm_params: Dict[str, Any],
        cfg: LLMConfig,
        *,
        num_slots: int = 8,
        max_len: int = 4096,
        policy: DTypePolicy = DEFAULT_POLICY,
        cache_dtype=torch.bfloat16,
        steps_per_sync: int = 1,
        eager: bool = False,
        mesh=None,
    ):
        if isinstance(cfg, MLAMoEConfig):
            raise NotImplementedError(
                "the contiguous server serves InternLM2's K/V cache; the MLA-MoE LLM serves through the "
                "engine's batch route (a multislot latent-cache decode is later work)")
        self.params = llm_params
        self.cfg = cfg
        self.mesh = mesh
        self.B = num_slots
        self.max_len = max_len
        self.device = llm_params["norm"].device
        # >1: K decode steps per host tick, with the pick on the device: the
        # host reads K*B token ids per round trip instead of B. Costs up to
        # K-1 throwaway steps per retiring request and delays admission by up
        # to K steps.
        self.steps_per_sync = max(1, steps_per_sync)
        self.policy = policy
        shape = (cfg.num_hidden_layers, num_slots, internlm2.kv_heads(cfg, mesh), max_len,
                 cfg.head_dim)
        self.cache_k = torch.zeros(shape, dtype=cache_dtype, device=self.device)
        self.cache_v = torch.zeros(shape, dtype=cache_dtype, device=self.device)
        self.lengths = np.zeros(num_slots, np.int64)
        self.starts = np.zeros(num_slots, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * num_slots
        # the seen-token mask lives on the device: the per-step host transfer
        # is then B token ids instead of (B, vocab) logits
        self.seen = torch.zeros((num_slots, cfg.vocab_size), dtype=torch.bool, device=self.device)
        self.last_logits = torch.zeros((num_slots, cfg.vocab_size), dtype=torch.float32,
                                       device=self.device)
        self.queue: List[Request] = []
        self.done: List[Request] = []
        self._pending: List[Any] = [None] * num_slots
        self._init_prefix_cache()
        self._in = TickInputs(num_slots, self.device)
        # the tick's CUDA graph (``eager``: uncaptured on the card too, for tests)
        self._tick = decode_graph.StepGraph(self.device, eager=eager, mesh=mesh)

    @property
    def _cache_dtype(self):
        return self.cache_k.dtype

    def _tick_fn(self) -> Optional[torch.Tensor]:
        """The tick's decode on ``self._in``: one step writing
        ``last_logits`` (steps_per_sync 1), or the window -> its (k, B) ids."""
        inp, k = self._in, self.steps_per_sync
        if k == 1:
            self.last_logits.copy_(self._decode(inp.tokens, inp.lengths, inp.starts))
            return None
        return self._decode_k(inp.tokens, inp.lengths, inp.active, inp.starts, k, inp.pens)

    def _prefix_capacity(self) -> int:
        return self.max_len

    # ------------------------------------------------------------------

    def _prefill_fn(self, bucket: int) -> Callable:
        # the prefill's own cache holds the bucket only: admission copies
        # that region into the slot, the rest of the slot is never read
        return lambda p, e, m: internlm2.prefill(
            p, self.cfg, inputs_embeds=e, attention_mask=m, max_len=bucket,
            policy=self.policy, cache_dtype=self.cache_k.dtype, mesh=self.mesh,
        )

    def _decode(self, tokens: torch.Tensor, lengths: torch.Tensor, starts: torch.Tensor):
        return internlm2.decode_step_multislot(
            self.params, self.cfg, input_ids=tokens[:, None], cache_k=self.cache_k,
            cache_v=self.cache_v, lengths=lengths, starts=starts, policy=self.policy,
            mesh=self.mesh,
        )

    def _decode_k(self, first_tokens, lengths, active, starts, k: int, pens) -> torch.Tensor:
        """K decode+pick steps without a host sync; returns the (K, B) picked
        ids (the K-1 follow-on tokens after ``first_tokens`` plus the final
        step's picks)."""
        toks, out = first_tokens, []
        for _ in range(k):
            logits = self._decode(toks, lengths, starts)
            toks = _pick_tokens(logits, self.seen, pens)
            lengths = lengths + active
            out.append(toks)
        return torch.stack(out)

    @torch.inference_mode()
    def submit(self, req: Request) -> None:
        # start the prompt-embed upload now, so admission later finds the
        # rows on the device
        if req.dev_embeds is None:
            req.dev_embeds = self._to_dev(req.embeds)
        self._prehash(req)
        self.queue.append(req)

    def _reject(self, req: Request, why: str) -> None:
        req.tokens = []
        req.error = why
        self.done.append(req)

    def _admission_bucket(self, req: Request) -> Optional[int]:
        """Prompt bucket if the request fits the cache, else None (rejected).
        Windowed mode needs `steps_per_sync` write headroom past the bucket:
        otherwise the first window would write outside the slot before the
        late cap check retires it."""
        try:
            bucket = gen.bucket_length(req.embeds.shape[0])
        except ValueError:
            self._reject(req, f"prompt length {req.embeds.shape[0]} exceeds buckets")
            return None
        headroom = self.steps_per_sync if self.steps_per_sync > 1 else 0
        if bucket + headroom > self.max_len:
            self._reject(
                req, f"prompt bucket {bucket} + window {headroom} exceeds max_len {self.max_len}")
            return None
        return bucket

    def _fill_free_slots(self) -> None:
        free = [s for s in range(self.B) if self.slot_req[s] is None]
        if not free or not self.queue:
            return
        # group the admissible requests by (prompt bucket, matched prefix): a
        # single n-row prefill amortizes the weight reads that dominate 1-row
        # prefill; prefix-cache hits share one chunked prefill
        take = self.queue[: len(free)]
        del self.queue[: len(take)]
        admissible = []
        for req in take:
            bucket = self._admission_bucket(req)
            if bucket is not None:
                admissible.append((req, bucket, req))
        it = iter(free)
        for (bucket, _dig), (entry, pairs) in self._group_admissions(admissible).items():
            reqs = [r for r, _ in pairs]
            logits, cache = self._prefill_group(entry, reqs, bucket)
            for i, req in enumerate(reqs):
                slot = next(it)
                # only the prompt-bucket region: copying max_len would move
                # the whole slot per admitted request
                self.cache_k[:, slot, :, :bucket] = cache.k[:, i, :, :bucket]
                self.cache_v[:, slot, :, :bucket] = cache.v[:, i, :, :bucket]
                self.last_logits[slot] = logits[i]
                self.lengths[slot] = bucket  # left-padded rows occupy [0, bucket)
                self.starts[slot] = bucket - req.embeds.shape[0]
                self.slot_req[slot] = req
                self.seen[slot] = False
                req.tokens = []
                if self.steps_per_sync > 1:
                    # windowed mode keeps per-slot pending input tokens; the
                    # argmax stays on the device so admits do not sync
                    # (resolved in one copy at the next window)
                    self._pending[slot] = torch.argmax(logits[i])

    @torch.inference_mode()
    def step(self) -> int:
        """One scheduler tick: fill slots, sample every active slot's next
        token, run one decode. Returns the number of active slots."""
        self._fill_free_slots()
        active = [s for s in range(self.B) if self.slot_req[s] is not None]
        if not active:
            return 0

        if self.steps_per_sync > 1:
            return self._step_windowed(active)

        pens = np.ones(self.B, np.float32)
        for s in active:
            pens[s] = self.slot_req[s].repetition_penalty
        toks_dev = _pick_tokens(self.last_logits, self.seen, self._to_dev(pens))
        next_tokens = toks_dev.cpu().numpy()  # B ids: the only per-step device-to-host copy
        for s in active:
            req = self.slot_req[s]
            tok = int(next_tokens[s])
            req.tokens.append(tok)
            if tok in req.eos_token_ids or len(req.tokens) >= req.max_new_tokens or (
                self.lengths[s] + 1 >= self.max_len
            ):
                self.done.append(req)
                self.slot_req[s] = None

        still = [s for s in range(self.B) if self.slot_req[s] is not None]
        if not still:
            return 0
        self._in.fill(tokens=toks_dev, lengths=self.lengths, starts=self.starts)
        self._tick(self._tick_fn)
        for s in still:
            self.lengths[s] += 1
        return len(still)

    def _step_windowed(self, active: List[int]) -> int:
        """steps_per_sync decode+pick steps per host tick. Each slot's pending
        token feeds the window; every picked token is a real generated token
        (appended exactly once, fed as the next input exactly once). One
        (k, B)-id device-to-host copy per k steps instead of k round trips."""
        k = self.steps_per_sync
        # resolve freshly admitted slots' seed tokens (one sync for all)
        fresh = [s for s in active if not isinstance(self._pending[s], int)]
        if fresh:
            seeds = torch.stack([self._pending[s] for s in fresh]).cpu().tolist()
            for s, tok in zip(fresh, seeds):
                req = self.slot_req[s]
                req.tokens.append(tok)
                self.seen[s, tok] = True
                if tok in req.eos_token_ids or req.max_new_tokens <= 1:
                    self.done.append(req)
                    self.slot_req[s] = None
                    self._pending[s] = None
                else:
                    self._pending[s] = tok
            active = [s for s in active if self.slot_req[s] is not None]
            if not active:
                return 0
        next_tokens = np.zeros(self.B, np.int32)
        pens = np.ones(self.B, np.float32)
        for s in active:
            next_tokens[s] = self._pending[s]
            pens[s] = self.slot_req[s].repetition_penalty
        active_mask = np.zeros(self.B, np.int64)
        active_mask[active] = 1
        self._in.fill(tokens=next_tokens, lengths=self.lengths, active=active_mask,
                      starts=self.starts, pens=pens)
        window = self._tick(self._tick_fn).cpu().numpy()  # (k, B)
        for s in active:
            req = self.slot_req[s]
            retired = False
            for j in range(k):
                tok = int(window[j, s])
                self.lengths[s] += 1
                if retired:
                    continue
                req.tokens.append(tok)
                if (
                    tok in req.eos_token_ids
                    or len(req.tokens) >= req.max_new_tokens
                    or self.lengths[s] + k >= self.max_len
                ):
                    self.done.append(req)
                    self.slot_req[s] = None
                    self._pending[s] = None
                    retired = True
            if not retired:
                self._pending[s] = int(window[k - 1, s])
        return len([s for s in range(self.B) if self.slot_req[s] is not None])

    def run(self) -> List[Request]:
        """Drain queue + slots to completion; returns finished requests."""
        while self.queue or any(r is not None for r in self.slot_req):
            self.step()
        out, self.done = self.done, []
        return out
