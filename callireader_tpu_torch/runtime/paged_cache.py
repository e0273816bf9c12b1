"""Paged KV cache + paged continuous-batching scheduler (PyTorch port of
callireader_tpu/runtime/paged_cache.py).

vLLM-style memory management: the KV cache is a global pool of fixed-size
pages (L, NPAGES, Hkv, page, D); each request owns just the pages its tokens
occupy, so device memory scales with live tokens instead of slots x max_len.
Attention walks the page table inside the kernel
(kernels/paged_decode.py): the gather never materializes.

The pools are written IN PLACE (prompt pages at admission, one (page, offset)
per slot and layer at each decode step). On a CUDA device every decode goes
through the paged kernel, whatever the page size; a page size the kernel
lacks raises there. A tick's decode (one step, or the window of k steps)
reads static inputs the host fills before each tick, the page table among
them, and is a CUDA graph on the card, as in runtime/serving.py. Under a
mesh (``mesh=``) the pools hold the rank's KV heads and the page tables are
the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from callireader_tpu_torch.core.config import LLMConfig, MLAMoEConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.kernels.paged_decode import paged_flash_decode
from callireader_tpu_torch.models import internlm2
from callireader_tpu_torch.runtime import decode_graph
from callireader_tpu_torch.runtime import generate as gen
from callireader_tpu_torch.runtime.serving import (
    PrefixCacheMixin, Request, TickInputs, _penalize, _pick_tokens,
)


class PagePool:
    """Host-side page allocator over the device pools."""

    def __init__(self, num_pages: int):
        # page 0 is reserved as the trash page: inactive decode slots write
        # their garbage token there instead of corrupting live pages
        self.free = list(range(num_pages - 1, 0, -1))

    def alloc(self, n: int) -> List[int]:
        if len(self.free) < n:
            raise MemoryError(f"page pool exhausted (need {n}, have {len(self.free)})")
        return [self.free.pop() for _ in range(n)]

    def release(self, pages: List[int]) -> None:
        self.free.extend(pages)


@dataclasses.dataclass
class _Slot:
    req: Request
    pages: List[int]
    start: int      # first valid token offset inside the first page region
    length: int     # absolute token count written (incl. left pad region)
    seq: int = 0    # admission order: preemption picks the youngest (max)


class PagedBatcher(PrefixCacheMixin):
    """Continuous batching over the paged pool.

    Same scheduling contract as runtime/serving.ContinuousBatcher, but a slot
    holds only as many pages as its tokens need (bucketed prompt + generation
    growth), and pages return to the pool the moment a request finishes.
    Supports the prefix KV cache (PrefixCacheMixin): hits prefill only their
    suffix; the prefix KV is copied into the request's own pages (no page
    sharing: the copy is cheap and keeps the decode-write invariants).
    """

    def __init__(
        self,
        llm_params: Dict[str, Any],
        cfg: LLMConfig,
        *,
        num_slots: int = 8,
        num_pages: int = 256,
        page_size: int = 128,
        max_pages_per_slot: int = 32,
        policy: DTypePolicy = DEFAULT_POLICY,
        cache_dtype=torch.bfloat16,
        steps_per_sync: int = 1,
        alloc_watermark: Optional[int] = None,
        eager: bool = False,
        mesh=None,
    ):
        if isinstance(cfg, MLAMoEConfig):
            raise NotImplementedError(
                "the paged server serves InternLM2's K/V cache; the MLA-MoE LLM serves through the "
                "engine's batch route (a paged latent-cache decode is later work)")
        self.params = llm_params
        self.cfg = cfg
        self.mesh = mesh
        self.B = num_slots
        self.page = page_size
        self.P = max_pages_per_slot
        self.policy = policy
        self.device = llm_params["norm"].device
        # >1: k decode+pick steps per host tick without a host sync (valid
        # windows / write targets derived on the device from lengths + table)
        self.steps_per_sync = max(1, steps_per_sync)
        # the first window after admit writes at bucket..bucket+k-1; the page
        # rounding of the prompt bucket guarantees >= page_size headroom
        if self.steps_per_sync > page_size:
            raise ValueError("steps_per_sync must be <= page_size")

        self._pending: List[Any] = [None] * num_slots
        L, Hkv, D = cfg.num_hidden_layers, internlm2.kv_heads(cfg, mesh), cfg.head_dim
        pool_shape = (L, num_pages, Hkv, page_size, D)
        self.kpool = torch.zeros(pool_shape, dtype=cache_dtype, device=self.device)
        self.vpool = torch.zeros(pool_shape, dtype=cache_dtype, device=self.device)
        self.pool = PagePool(num_pages)
        self.slots: List[Optional[_Slot]] = [None] * num_slots
        self.last_logits = torch.zeros((num_slots, cfg.vocab_size), dtype=torch.float32,
                                       device=self.device)
        self.queue: List[Request] = []
        self.done: List[Request] = []
        # pages are allocated LAZILY: admission takes only the prompt's pages
        # and decode growth allocates one page at a time, so memory really
        # does scale with live tokens (not with max_new_tokens worst cases).
        # The watermark keeps a small reserve out of admission's reach so
        # running decodes can grow before preemption kicks in.
        self.watermark = num_slots if alloc_watermark is None else alloc_watermark
        self.n_preempted = 0
        self._admit_seq = 0
        self.seen = torch.zeros((num_slots, cfg.vocab_size), dtype=torch.bool, device=self.device)
        self._init_prefix_cache()
        self._in = TickInputs(num_slots, self.device, table=torch.zeros(
            (num_slots, max_pages_per_slot), dtype=torch.int32, device=self.device))
        # the tick's CUDA graph (``eager``: uncaptured on the card too, for tests)
        self._tick = decode_graph.StepGraph(self.device, eager=eager, mesh=mesh)

    @property
    def _cache_dtype(self):
        return self.kpool.dtype

    def _prefix_capacity(self) -> int:
        return self.P * self.page

    # ------------------------------------------------------------------

    def _prefill_fn(self, bucket: int) -> Callable:
        return lambda p, e, m: internlm2.prefill(
            p, self.cfg, inputs_embeds=e, attention_mask=m, max_len=bucket,
            policy=self.policy, cache_dtype=self.kpool.dtype, mesh=self.mesh,
        )

    def _insert_pages(self, cache: torch.Tensor, pool: torch.Tensor, page_ids: torch.Tensor):
        """cache (L, Hkv, n*page, D) of one row -> pool[:, page_ids[i]] for
        each of its n page-sized windows, in one indexed write."""
        L, Hkv, S, D = cache.shape
        n = S // self.page
        src = cache.reshape(L, Hkv, n, self.page, D).permute(0, 2, 1, 3, 4)
        pool[:, page_ids] = src.to(pool.dtype)

    def _decode(self, ids, page_table, valid, write_page, write_off, positions) -> torch.Tensor:
        """One decode step over all slots -> logits (B, V). Each layer writes
        the new token's K/V into (layer, page, :, offset) of the pools per
        slot (inactive slots all write page 0, offset 0: the trash page,
        whichever write wins) and attends through the paged kernel."""
        def attend(i, q):
            return paged_flash_decode(q, self.kpool, self.vpool, i, page_table, valid)

        return internlm2.decode_layers(
            self.params, self.cfg, input_ids=ids, positions=positions,
            kv_seq_len=self.P * self.page, cache_k=self.kpool, cache_v=self.vpool,
            write_rows=write_page, write_pos=write_off, policy=self.policy, mesh=self.mesh,
            attend=attend)

    def _derive_step_arrays(self, page_table, lengths, starts, active):
        """(B,) lengths/starts/active -> (valid (B, P, page), write_page,
        write_off, positions), on the device. Valid keys of an active slot
        are [start, length]: its cache plus the token being written. An
        inactive slot has no valid key, writes the trash page and sits at
        position 0."""
        flat = torch.arange(self.P * self.page, device=self.device)[None, :]
        valid = (
            (flat >= starts[:, None]) & (flat < (lengths + 1)[:, None]) & (active[:, None] > 0)
        ).to(torch.int32).reshape(-1, self.P, self.page)
        write_page = torch.gather(page_table, 1, (lengths // self.page)[:, None])[:, 0].long()
        write_off = lengths % self.page
        positions = (lengths - starts)[:, None]
        return valid, write_page, write_off, positions

    def _decode_k(self, first_tokens, page_table, lengths, starts, k: int, pens, active):
        """k decode+pick steps without a host sync -> the (k, B) picked ids."""
        toks, out = first_tokens, []
        for _ in range(k):
            valid, wp, wo, pos = self._derive_step_arrays(page_table, lengths, starts, active)
            logits = self._decode(toks[:, None], page_table, valid, wp, wo, pos)
            toks = _pick_tokens(logits, self.seen, pens)
            lengths = lengths + active
            out.append(toks)
        return torch.stack(out)

    def _tick_fn(self) -> Optional[torch.Tensor]:
        """The tick's decode on ``self._in``: one step writing
        ``last_logits`` (steps_per_sync 1), or the window -> its (k, B) ids."""
        inp, k = self._in, self.steps_per_sync
        if k == 1:
            arrays = self._derive_step_arrays(inp.table, inp.lengths, inp.starts, inp.active)
            self.last_logits.copy_(self._decode(inp.tokens[:, None], inp.table, *arrays))
            return None
        return self._decode_k(inp.tokens, inp.table, inp.lengths, inp.starts, k, inp.pens,
                              inp.active)

    # ------------------------------------------------------------------

    @property
    def slot_req(self) -> List[Optional[Request]]:
        """ContinuousBatcher-compatible view for the HTTP scheduler loop."""
        return [s.req if s is not None else None for s in self.slots]

    @torch.inference_mode()
    def submit(self, req: Request) -> None:
        # upload the prompt embeds now (see runtime/serving.ContinuousBatcher.submit)
        if req.dev_embeds is None:
            req.dev_embeds = self._to_dev(req.embeds)
        self._prehash(req)
        self.queue.append(req)

    def _reject(self, req: Request, why: str) -> None:
        req.tokens = []
        req.error = why
        self.done.append(req)

    def _preempt(self, s: int) -> None:
        """vLLM-style preempt-and-recompute: free the slot's pages and requeue
        its request at the front, with the tokens generated so far folded into
        the prompt embeds (float32: prefill casts to the compute dtype, so the
        replay matches decode). Re-admission replays them through one prefill
        and decode resumes where it stopped."""
        slot = self.slots[s]
        req = slot.req
        if req.tokens:
            ids = torch.tensor([req.tokens], dtype=torch.int32, device=self.device)
            emb = internlm2.embed_tokens(self.params, ids, torch.float32, self.mesh,
                                         self.cfg)[0].cpu().numpy()
            req.embeds = np.concatenate([req.embeds, emb.astype(req.embeds.dtype)], axis=0)
            req.dev_embeds = None  # stale; uploaded again at re-admission
        self.pool.release(slot.pages)
        self.slots[s] = None
        self._pending[s] = None
        self.queue.insert(0, req)
        self.n_preempted += 1

    def _grow(self, s: int, need: int) -> bool:
        """Grow slot ``s``'s pages until they cover ``need`` tokens. When the
        pool runs dry, preempt the youngest OTHER slot and retry; if no other
        slot exists the pool itself cannot hold this request: fail it (never
        the server). Returns False when the slot no longer exists or hit the
        architectural P-page cap (caller retires it as length-finished)."""
        slot = self.slots[s]
        while len(slot.pages) * self.page < need:
            if len(slot.pages) >= self.P:
                return False
            if not self.pool.free:
                victims = [
                    (self.slots[t].seq, t)
                    for t in range(self.B)
                    if t != s and self.slots[t] is not None
                ]
                if not victims:
                    self.pool.release(slot.pages)
                    self.slots[s] = None
                    self._pending[s] = None
                    self._reject(
                        slot.req,
                        f"page pool exhausted mid-decode with nothing to "
                        f"preempt (need {need} tokens)",
                    )
                    return False
                self._preempt(max(victims)[1])
            slot.pages.extend(self.pool.alloc(1))
        return True

    def _admit(self) -> None:
        # take as many queued requests as free slots + pages allow, grouped by
        # prompt bucket: an n-row prefill amortizes the weight reads that
        # dominate 1-row prefill. Only the PROMPT's pages are taken here;
        # decode growth allocates lazily (see _grow), so admission doesn't
        # hoard pages for generation that may never happen.
        free_slots = [s for s in range(self.B) if self.slots[s] is None]
        taken: List[Tuple[Request, int, List[int]]] = []  # (req, bucket, pages)
        cap = self.P * self.page
        while free_slots[len(taken):] and self.queue:
            req = self.queue[0]
            S = req.embeds.shape[0]
            try:
                bucket = gen.bucket_length(max(S, self.page))
            except ValueError:
                self.queue.pop(0)
                if req.tokens:
                    # resumed after preemption and the grown prompt no longer
                    # buckets: retire as length-finished with the output it
                    # already produced; never discard generated text on a
                    # scheduling artifact
                    self.done.append(req)
                else:
                    self._reject(req, f"prompt length {S} exceeds buckets")
                continue
            bucket = -(-bucket // self.page) * self.page
            # admission guard: the prompt (plus the windowed-mode decode
            # headroom) must fit a slot's page budget: fail the request,
            # never the server
            headroom = self.steps_per_sync if self.steps_per_sync > 1 else 0
            if bucket + headroom > cap:
                self.queue.pop(0)
                if req.tokens:
                    # resumed request outgrew a slot: length-finish, keep tokens
                    self.done.append(req)
                else:
                    self._reject(
                        req,
                        f"prompt bucket {bucket} + window {headroom} exceeds "
                        f"slot capacity {cap} ({self.P} pages x {self.page})",
                    )
                continue
            n_pages = bucket // self.page
            # watermark: leave growth headroom for the decodes already running
            reserve = self.watermark if any(s is not None for s in self.slots) or taken else 0
            if len(self.pool.free) < n_pages + reserve:
                break  # backpressure: wait for pages
            self.queue.pop(0)
            taken.append((req, bucket, self.pool.alloc(n_pages)))
        if not taken:
            return

        it = iter(free_slots)
        for (bucket, _dig), (entry, group) in self._group_admissions(taken).items():
            logits, cache = self._prefill_group(entry, [r for r, _ in group], bucket)
            n_prompt = bucket // self.page
            for i, (req, pages) in enumerate(group):
                s = next(it)
                ids = torch.tensor(pages[:n_prompt], dtype=torch.int64, device=self.device)
                self._insert_pages(cache.k[:, i], self.kpool, ids)
                self._insert_pages(cache.v[:, i], self.vpool, ids)
                self.last_logits[s] = logits[i]
                self._admit_seq += 1
                self.slots[s] = _Slot(
                    req=req, pages=pages, start=bucket - req.embeds.shape[0],
                    length=bucket, seq=self._admit_seq,
                )
                self.seen[s] = False
                if req.tokens:
                    # resumed after preemption: its generated ids were folded
                    # into the prompt; re-mark them for repetition-penalty
                    # parity with the uninterrupted run
                    self.seen[s, torch.tensor(req.tokens, dtype=torch.int64, device=self.device)] = True
                else:
                    req.tokens = []
                if self.steps_per_sync > 1:
                    # stays on the device: admits do not sync; resolved in
                    # _step_windowed. Penalty-aware pick (not a raw argmax): a
                    # resumed request's seed token must see the re-marked seen
                    # row. The picked token is marked when the window takes it.
                    pen = torch.full((1,), float(req.repetition_penalty), device=self.device)
                    self._pending[s] = torch.argmax(
                        _penalize(logits[i][None], self.seen[s][None], pen)[0])

    def _pens(self, active: List[int]) -> np.ndarray:
        pens = np.ones(self.B, np.float32)
        for s in active:
            pens[s] = self.slots[s].req.repetition_penalty
        return pens

    def _fill_inputs(self, active: List[int], tokens, pens: np.ndarray) -> None:
        """The tick's inputs: ``tokens``, ``pens`` and the active slots' page
        table, lengths and starts, and the active mask (inactive slots:
        zeros)."""
        page_table = np.zeros((self.B, self.P), np.int32)
        lengths = np.zeros(self.B, np.int64)
        starts = np.zeros(self.B, np.int64)
        active_mask = np.zeros(self.B, np.int64)
        for s in active:
            slot = self.slots[s]
            page_table[s, : len(slot.pages)] = slot.pages
            lengths[s] = slot.length
            starts[s] = slot.start
            active_mask[s] = 1
        self._in.fill(tokens=tokens, pens=pens, table=page_table, lengths=lengths,
                      starts=starts, active=active_mask)

    def _retire(self, s: int) -> None:
        slot = self.slots[s]
        self.done.append(slot.req)
        self.pool.release(slot.pages)
        self.slots[s] = None
        self._pending[s] = None

    @torch.inference_mode()
    def step(self) -> int:
        self._admit()
        active = [s for s in range(self.B) if self.slots[s] is not None]
        if not active:
            return 0
        if self.steps_per_sync > 1:
            return self._step_windowed(active)

        pens = self._pens(active)
        toks_dev = _pick_tokens(self.last_logits, self.seen, self._to_dev(pens))
        next_tokens = toks_dev.cpu().numpy()  # B ids: the only per-step device-to-host copy
        for s in active:
            slot = self.slots[s]
            req = slot.req
            tok = int(next_tokens[s])
            req.tokens.append(tok)
            if tok in req.eos_token_ids or len(req.tokens) >= req.max_new_tokens or (
                slot.length + 1 >= self.P * self.page  # architectural cap
            ):
                self._retire(s)

        # lazy growth: every survivor needs capacity for the token the decode
        # below will write at offset `length`; exhaustion preempts the
        # youngest other slot (its request requeues and replays)
        for s in range(self.B):
            if self.slots[s] is not None:
                self._grow(s, self.slots[s].length + 1)

        still = [s for s in range(self.B) if self.slots[s] is not None]
        if still:
            self._fill_inputs(still, toks_dev, pens)
            self._tick(self._tick_fn)
            for s in still:
                self.slots[s].length += 1
        return len(still)

    def _step_windowed(self, active: List[int]) -> int:
        k = self.steps_per_sync
        fresh = [s for s in active if not isinstance(self._pending[s], int)]
        if fresh:
            seeds = torch.stack([self._pending[s] for s in fresh]).cpu().tolist()
            for s, tok in zip(fresh, seeds):
                req = self.slots[s].req
                req.tokens.append(tok)
                self.seen[s, tok] = True
                if tok in req.eos_token_ids or len(req.tokens) >= req.max_new_tokens:
                    self._retire(s)
                else:
                    self._pending[s] = tok
            active = [s for s in active if self.slots[s] is not None]
            if not active:
                return 0
        # lazy growth: the window writes at length..length+k-1 per slot
        for s in list(active):
            if self.slots[s] is not None:
                self._grow(s, self.slots[s].length + k)
        active = [s for s in active if self.slots[s] is not None]
        if not active:
            return 0
        next_tokens = np.zeros(self.B, np.int32)
        for s in active:
            next_tokens[s] = self._pending[s]
        self._fill_inputs(active, next_tokens, self._pens(active))
        window = self._tick(self._tick_fn).cpu().numpy()  # (k, B): one device-to-host copy
        cap = self.P * self.page  # architectural cap; _grow covers the rest
        for s in active:
            slot = self.slots[s]
            req = slot.req
            retired = False
            for j in range(k):
                tok = int(window[j, s])
                slot.length += 1
                if retired:
                    continue
                req.tokens.append(tok)
                if (
                    tok in req.eos_token_ids
                    or len(req.tokens) >= req.max_new_tokens
                    or slot.length + k >= cap
                ):
                    self._retire(s)
                    retired = True
            if not retired:
                self._pending[s] = int(window[k - 1, s])
        return len([s for s in range(self.B) if self.slots[s] is not None])

    def run(self) -> List[Request]:
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        out, self.done = self.done, []
        return out
