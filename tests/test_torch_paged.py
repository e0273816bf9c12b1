"""Port paged serving against the JAX package on the CPU: the plain version
of the paged decode kernel against the JAX Pallas kernel in interpret mode,
the page allocator, and ``PagedBatcher`` (token parity with the JAX batcher,
lazy growth, preemption, rejection) on the tiny LLM in fp32.

Tolerances: kernel outputs 1e-4 max abs in fp32 (the JAX test's own bound for
this kernel; same math, other summation order); for bf16 inputs the rule of
kernels/tolerance.py (the output's bf16 rounding plus 1e-5). Token ids must be
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.kernels.paged_decode import paged_flash_decode as j_paged_flash_decode
from callireader_tpu.models import internlm2 as jllm
from callireader_tpu.runtime.paged_cache import PagedBatcher as JPaged
from callireader_tpu.runtime.serving import Request as JRequest
from callireader_tpu_torch.core import config as tconfig
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.kernels import paged_decode as tpaged
from callireader_tpu_torch.kernels import tolerance
from callireader_tpu_torch.runtime.paged_cache import PagedBatcher as TPaged
from callireader_tpu_torch.runtime.paged_cache import PagePool
from callireader_tpu_torch.runtime.serving import Request as TRequest
from callireader_tpu_torch.runtime.weights import from_jax_params

JCFG = callireader_tiny().llm
TCFG = tconfig.callireader_tiny().llm


# ------------------------------------------------------------ kernel (plain)


def _pool_case(case):
    """Scattered page table, partial pages and a page-0 entry; ``dead`` adds
    an empty slot and dead table entries that point at live pages."""
    L, NP, B, Hq, Hkv, page, D, P = 2, 8, 2, 8, 2, 16, 32, 3
    table = [[3, 5, 1], [7, 2, 0]]
    valid = np.zeros((3, P, page), np.int32)
    valid[0, :2, :] = 1
    valid[0, 2, :5] = 1
    valid[1, 0, 4:] = 1
    valid[1, 1, :] = 1
    if case == "dead":
        B = 3
        table = [[3, 5, 5], [7, 3, 3], [5, 7, 3]]  # slot 0's and 1's tails, all of slot 2: dead
        valid[0, 2] = 0
        valid[1, 1, 9:] = 0
    rng = np.random.default_rng(0)
    q = rng.standard_normal((B, Hq, 1, D), dtype=np.float32)
    kpool = rng.standard_normal((L, NP, Hkv, page, D), dtype=np.float32)
    vpool = rng.standard_normal((L, NP, Hkv, page, D), dtype=np.float32)
    return q, kpool, vpool, np.asarray(table, np.int32), valid[:B]


@pytest.mark.parametrize("case", ["scattered", "dead"])
@pytest.mark.parametrize("layer", [0, 1])
def test_paged_plain_matches_jax_kernel(case, layer):
    q, kpool, vpool, table, valid = _pool_case(case)
    want = np.asarray(j_paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kpool), jnp.asarray(vpool), jnp.asarray(layer),
        jnp.asarray(table), jnp.asarray(valid), interpret=True))
    got = tpaged.paged_flash_decode(
        torch.from_numpy(q), torch.from_numpy(kpool), torch.from_numpy(vpool), layer,
        torch.from_numpy(table), torch.from_numpy(valid)).numpy()
    live = slice(0, 2)
    np.testing.assert_allclose(got[live], want[live], atol=1e-4)
    if case == "dead":
        # an empty slot gives zeros (the JAX kernel masks with -1e30, not -inf,
        # and averages V there: output of an inactive slot, which no caller reads)
        assert (got[2] == 0).all() and np.abs(got[live]).min() > 0


def test_paged_plain_bf16_within_the_card_tolerance():
    """bf16 pools and queries: the plain version's bf16 output stands within
    the card's rule from the fp32 result on the same bf16 inputs, and the rule
    fails an output that lost one page."""
    q, kpool, vpool, table, valid = (torch.from_numpy(x) for x in _pool_case("scattered"))
    qb, kb, vb = q.bfloat16(), kpool.bfloat16(), vpool.bfloat16()
    want = tpaged.paged_flash_decode_reference(qb.float(), kb.float(), vb.float(), 1, table, valid)
    got = tpaged.paged_flash_decode(qb, kb, vb, 1, table, valid)
    assert got.dtype == torch.bfloat16
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["paged_flash_decode"]
    cut = valid.clone()
    cut[:, 1] = 0
    lost = tpaged.paged_flash_decode(qb, kb, vb, 1, table, cut)
    assert tolerance.excess_error(lost, want) > 10 * tolerance.ATOL["paged_flash_decode"]


def test_paged_plain_ignores_dead_entries_wherever_they_point():
    q, kpool, vpool, table, valid = (torch.from_numpy(x) for x in _pool_case("dead"))
    base = tpaged.paged_flash_decode(q, kpool, vpool, 0, table, valid)
    moved = table.clone()
    moved[0, 2], moved[2, 0] = 0, 99  # dead entries: another page, and one outside the pool
    assert torch.equal(tpaged.paged_flash_decode(q, kpool, vpool, 0, moved, valid), base)


# ------------------------------------------------------------ allocator


def test_page_pool():
    pool = PagePool(8)
    a = pool.alloc(3)
    assert 0 not in a  # the trash page is reserved
    b = pool.alloc(4)
    assert set(a).isdisjoint(b)
    with pytest.raises(MemoryError):
        pool.alloc(2)
    pool.release(a)
    assert len(pool.alloc(3)) == 3


# ------------------------------------------------------------ PagedBatcher


@pytest.fixture(scope="module")
def params():
    jp = jllm.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def _embeds(jp, ids):
    return np.array(jllm.embed_tokens(jp, jnp.asarray(np.asarray(ids)[None]), jnp.float32))[0]


def _run(make, Request, rows, max_new, rep=1.0):
    b = make()
    for uid, e in enumerate(rows):
        b.submit(Request(uid, e.copy(), max_new_tokens=max_new, eos_token_ids=(-1,),
                         repetition_penalty=rep))
    done = b.run()
    assert all(r.error is None for r in done), [r.error for r in done]
    return {r.uid: [int(t) for t in r.tokens] for r in done}, b


def _jpaged(jp, **kw):
    return lambda: JPaged(jp, JCFG, policy=J_FP32, use_flash=False, cache_dtype=jnp.float32, **kw)


def _tpaged(tp, **kw):
    return lambda: TPaged(tp, TCFG, policy=T_FP32, cache_dtype=torch.float32, **kw)


@pytest.mark.parametrize("k", [1, 4])
def test_paged_batcher_tokens_match_jax(params, k):
    jp, tp = params
    rows = [_embeds(jp, ids) for ids in ([1, 5, 9, 3], [1, 7, 11], [1, 42, 17, 23, 8])]
    kw = dict(num_slots=2, num_pages=32, page_size=64, max_pages_per_slot=4, steps_per_sync=k)
    want, _ = _run(_jpaged(jp, **kw), JRequest, rows, 7, rep=1.3)
    got, b = _run(_tpaged(tp, **kw), TRequest, rows, 7, rep=1.3)
    assert got == want and all(len(t) == 7 for t in got.values())
    assert len(b.pool.free) == 31  # all pages returned


def test_paged_batcher_matches_jax_through_its_pallas_kernel(params):
    """The JAX batcher decoding through the Pallas paged kernel (interpret
    mode) gives the tokens the port gives through its plain version."""
    jp, tp = params
    rows = [_embeds(jp, ids) for ids in ([1, 5, 9, 3], [1, 42, 17, 23, 8])]
    kw = dict(num_slots=2, num_pages=8, page_size=128, max_pages_per_slot=2)
    want, _ = _run(lambda: JPaged(jp, JCFG, policy=J_FP32, use_flash=False, interpret=True,
                                  cache_dtype=jnp.float32, **kw), JRequest, rows, 3)
    got, _ = _run(_tpaged(tp, **kw), TRequest, rows, 3)
    assert got == want


def test_lazy_growth_holds_only_live_pages(params):
    jp, tp = params
    rng = np.random.default_rng(0)
    rows = [_embeds(jp, [1] + list(rng.integers(2, 50, size=10)))]
    b = _tpaged(tp, num_slots=2, num_pages=32, page_size=64, max_pages_per_slot=8)()
    b.submit(TRequest(0, rows[0], max_new_tokens=8, eos_token_ids=(-1,)))
    held = []
    while b.queue or any(s is not None for s in b.slots):
        b.step()
        held.append(31 - len(b.pool.free))
    # prompt bucket 128 = 2 pages, + 1 growth page for the 8 generated tokens
    assert max(held) == 3 and held[0] == 3 and held[-1] == 0
    assert len(b.done[0].tokens) == 8 and b.n_preempted == 0


@pytest.mark.parametrize("k,rep", [(1, 1.0), (4, 1.0), (4, 1.5)])
def test_oversubscribed_pool_preempts_and_completes_with_parity(params, k, rep):
    """The pool is too small for all requests' growth: the scheduler preempts
    (never crashes), every request completes with the uncontended run's
    tokens, all pages return."""
    jp, tp = params
    rng = np.random.default_rng(1)
    rows = [_embeds(jp, [u + 1] + list(rng.integers(2, 50, size=12 + 2 * u))) for u in range(3)]
    kw = dict(num_slots=3, page_size=64, max_pages_per_slot=8, steps_per_sync=k)
    base, b0 = _run(_tpaged(tp, num_pages=64, **kw), TRequest, rows, 96, rep)
    assert b0.n_preempted == 0
    # 9 usable pages for 3 requests needing 4 pages each at their peak
    got, b1 = _run(_tpaged(tp, num_pages=10, alloc_watermark=1, **kw), TRequest, rows, 96, rep)
    assert b1.n_preempted >= 1
    assert len(b1.pool.free) == 9
    assert got == base


def test_windowed_resumed_seed_respects_penalty(params):
    """A resumed request whose already-generated token is the post-prefill
    argmax: with a strong penalty the seed switches away from it, and windowed
    mode agrees with the per-tick path."""
    jp, tp = params
    rng = np.random.default_rng(5)
    emb = _embeds(jp, [1] + list(rng.integers(2, 50, size=12)))
    first, _ = _run(_tpaged(tp, num_slots=1, num_pages=16, page_size=64, max_pages_per_slot=4),
                    TRequest, [emb], 1)
    seed_tok = first[0][0]

    def run(k):
        b = _tpaged(tp, num_slots=1, num_pages=16, page_size=64, max_pages_per_slot=4,
                    steps_per_sync=k)()
        req = TRequest(0, emb.copy(), max_new_tokens=6, eos_token_ids=(-1,),
                       repetition_penalty=8.0)
        req.tokens = [seed_tok]  # resumed: this id was already generated
        b.submit(req)
        done = b.run()
        assert done[0].error is None
        return done[0].tokens

    per_tick = run(1)
    assert per_tick[1] != seed_tok
    assert run(4) == per_tick


def test_overlong_prompt_and_resumed_overflow(params):
    """A prompt needing more pages than a slot holds is rejected at admission;
    a resumed request in the same spot retires with the tokens it has."""
    jp, tp = params
    b = _tpaged(tp, num_slots=2, num_pages=16, page_size=64, max_pages_per_slot=2)()
    big = _embeds(jp, np.arange(2, 142))  # 140 rows -> bucket 256 > capacity 128
    resumed = TRequest(0, big, max_new_tokens=8, eos_token_ids=(-1,))
    resumed.tokens = [11, 12, 13]
    b.submit(resumed)
    b.submit(TRequest(1, big.copy(), max_new_tokens=8, eos_token_ids=(-1,)))
    b.submit(TRequest(2, _embeds(jp, [1, 5, 9]), max_new_tokens=4, eos_token_ids=(-1,)))
    by_uid = {r.uid: r for r in b.run()}
    assert by_uid[0].error is None and by_uid[0].tokens == [11, 12, 13]
    assert by_uid[1].error is not None and by_uid[1].tokens == []
    assert by_uid[2].error is None and len(by_uid[2].tokens) >= 1  # bucket 128 fills the slot
    assert len(b.pool.free) == 15  # nothing leaked


def test_pool_too_small_for_one_request_fails_request_not_server(params):
    jp, tp = params
    rng = np.random.default_rng(3)
    b = _tpaged(tp, num_slots=2, num_pages=3, page_size=64, max_pages_per_slot=8)()
    b.submit(TRequest(0, _embeds(jp, [1] + list(rng.integers(2, 50, size=12))),
                      max_new_tokens=200, eos_token_ids=(-1,)))
    done = b.run()
    assert len(done) == 1
    assert done[0].error is not None and "exhaust" in done[0].error
    assert len(b.pool.free) == 2  # everything released


def test_steps_per_sync_beyond_a_page_is_refused(params):
    _, tp = params
    with pytest.raises(ValueError, match="steps_per_sync"):
        _tpaged(tp, num_slots=1, num_pages=4, page_size=16, steps_per_sync=17)()
