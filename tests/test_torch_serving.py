"""Port serving path against the JAX package on the CPU (tiny LLM, fp32):
``decode_step_multislot``, ``prefill_with_prefix``, the contiguous
``ContinuousBatcher`` and the prefix cache of both batchers.

Weights cross through ``from_jax_params``; prompts are embedded by the JAX
package and handed to both as the same numpy rows. The JAX side runs as its own
CPU tests run it (fp32 policy, ``use_flash=False``: its plain attention).
Tolerances: logits rtol/atol 1e-4 (same math, other summation order), cache
contents 1e-5 inside ``[start, length)``; generated token ids must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.models import internlm2 as jllm
from callireader_tpu.runtime.paged_cache import PagedBatcher as JPaged
from callireader_tpu.runtime.serving import ContinuousBatcher as JBatcher
from callireader_tpu.runtime.serving import Request as JRequest
from callireader_tpu_torch.core import config as tconfig
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.models import internlm2 as tllm
from callireader_tpu_torch.runtime import generate as tgen
from callireader_tpu_torch.runtime.paged_cache import PagedBatcher as TPaged
from callireader_tpu_torch.runtime.serving import ContinuousBatcher as TBatcher
from callireader_tpu_torch.runtime.serving import Request as TRequest
from callireader_tpu_torch.runtime.weights import from_jax_params

JCFG = callireader_tiny().llm
TCFG = tconfig.callireader_tiny().llm
PROMPTS = [[1, 5, 9, 3], [1, 7, 11], [1, 42, 17, 23, 8]]


@pytest.fixture(scope="module")
def params():
    jp = jllm.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return jp, tp


def _embeds(jp, ids):
    return np.array(jllm.embed_tokens(jp, jnp.asarray(np.asarray(ids)[None]), jnp.float32))[0]


def _jbatcher(jp, paged=False, **kw):
    if paged:
        return JPaged(jp, JCFG, policy=J_FP32, use_flash=False, cache_dtype=jnp.float32, **kw)
    return JBatcher(jp, JCFG, policy=J_FP32, use_flash=False, cache_dtype=jnp.float32, **kw)


def _tbatcher(tp, paged=False, **kw):
    cls = TPaged if paged else TBatcher
    return cls(tp, TCFG, policy=T_FP32, cache_dtype=torch.float32, **kw)


def _drain(b, Request, rows, max_new, rep=1.0):
    for uid, e in enumerate(rows):
        b.submit(Request(uid, e.copy(), max_new_tokens=max_new, eos_token_ids=(-1,),
                         repetition_penalty=rep))
    done = b.run()
    assert all(r.error is None for r in done)
    return {r.uid: [int(t) for t in r.tokens] for r in done}


# ------------------------------------------------------------ model functions


@pytest.mark.parametrize("with_starts", [True, False])
def test_decode_step_multislot_matches_jax(params, with_starts):
    jp, tp = params
    rng = np.random.default_rng(0)
    L, Hkv, D = JCFG.num_hidden_layers, JCFG.num_key_value_heads, JCFG.head_dim
    B, max_len = 3, 48
    ck = rng.standard_normal((L, B, Hkv, max_len, D), dtype=np.float32)
    cv = rng.standard_normal((L, B, Hkv, max_len, D), dtype=np.float32)
    ids = rng.integers(2, 900, (B, 1)).astype(np.int32)
    lengths = np.asarray([20, 7, 33], np.int32)
    starts = np.asarray([4, 0, 30], np.int32) if with_starts else None
    jl, jk, jv = jllm.decode_step_multislot(
        jp, JCFG, input_ids=jnp.asarray(ids), cache_k=jnp.asarray(ck), cache_v=jnp.asarray(cv),
        lengths=jnp.asarray(lengths), active=jnp.ones((B,), bool),
        starts=None if starts is None else jnp.asarray(starts), policy=J_FP32, use_flash=False)
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    tl = tllm.decode_step_multislot(
        tp, TCFG, input_ids=torch.from_numpy(ids), cache_k=tk, cache_v=tv,
        lengths=torch.from_numpy(lengths),
        starts=None if starts is None else torch.from_numpy(starts), policy=T_FP32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    # the cache was written in place, at (layer, b, :, lengths[b], :) only
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    changed = (tk.numpy() != ck).any(axis=(0, 2, 4))  # (B, max_len)
    assert (changed == (np.arange(max_len)[None] == lengths[:, None])).all()


@pytest.mark.parametrize("pads", [(0, 0), (5, 2)], ids=["plain", "left_padded"])
def test_prefill_with_prefix_matches_jax(params, pads):
    jp, tp = params
    rng = np.random.default_rng(1)
    P, S, max_len = 8, 6, 24
    prefix = _embeds(jp, [1] + list(rng.integers(2, 50, size=P - 1)))
    _, pc = jllm.prefill(jp, JCFG, inputs_embeds=jnp.asarray(prefix)[None], max_len=P,
                         policy=J_FP32, use_flash=False, cache_dtype=jnp.float32)
    pk, pv = np.array(pc.k[:, 0]), np.array(pc.v[:, 0])
    rows = np.stack([_embeds(jp, rng.integers(2, 50, size=S)) for _ in pads])
    mask = np.ones((len(pads), S), np.int32)
    for b, pad in enumerate(pads):
        mask[b, :pad] = 0
    jl, jc = jllm.prefill_with_prefix(
        jp, JCFG, inputs_embeds=jnp.asarray(rows), attention_mask=jnp.asarray(mask),
        prefix_k=jnp.asarray(pk), prefix_v=jnp.asarray(pv), max_len=max_len, policy=J_FP32,
        use_flash=False, cache_dtype=jnp.float32)
    tl, tc = tllm.prefill_with_prefix(
        tp, TCFG, inputs_embeds=torch.from_numpy(rows), attention_mask=torch.from_numpy(mask),
        prefix_k=torch.from_numpy(pk), prefix_v=torch.from_numpy(pv), max_len=max_len,
        policy=T_FP32, cache_dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    assert tc.length == P + S and tc.k.shape == jc.k.shape
    for b, pad in enumerate(pads):  # [pad | prefix | suffix]: live inside [pad, P + S)
        np.testing.assert_allclose(tc.k[:, b, :, pad:P + S].numpy(),
                                   np.asarray(jc.k[:, b, :, pad:P + S]), atol=1e-5)
        np.testing.assert_allclose(tc.v[:, b, :, pad:P + S].numpy(),
                                   np.asarray(jc.v[:, b, :, pad:P + S]), atol=1e-5)
        np.testing.assert_allclose(tc.k[:, b, :, pad:pad + P].numpy(), pk, atol=0)


def test_prefill_with_prefix_matches_full_prefill(params):
    """The port against itself: chunked prefill over a cached prefix gives the
    whole prompt's logits and cache."""
    jp, tp = params
    rng = np.random.default_rng(2)
    ids = [1] + list(rng.integers(2, 50, size=11))
    full = torch.from_numpy(_embeds(jp, ids))[None]
    ones = lambda n: torch.ones((1, n), dtype=torch.int32)
    lf, cf = tllm.prefill(tp, TCFG, inputs_embeds=full, attention_mask=ones(12), max_len=12,
                          cache_dtype=torch.float32, policy=T_FP32)
    _, pc = tllm.prefill(tp, TCFG, inputs_embeds=full[:, :8], attention_mask=ones(8), max_len=8,
                         cache_dtype=torch.float32, policy=T_FP32)
    lc, cc = tllm.prefill_with_prefix(tp, TCFG, inputs_embeds=full[:, 8:], attention_mask=ones(4),
                                      prefix_k=pc.k[:, 0], prefix_v=pc.v[:, 0], max_len=12,
                                      cache_dtype=torch.float32, policy=T_FP32)
    np.testing.assert_allclose(lc.numpy(), lf.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(cc.k.numpy(), cf.k.numpy(), atol=1e-5)
    np.testing.assert_allclose(cc.v.numpy(), cf.v.numpy(), atol=1e-5)


def test_dynamic_ntk_rope_per_slot_positions_match_jax():
    """cos/sin for per-slot positions once the cache capacity exceeds
    max_position_embeddings: the base rescales on the run's largest position
    (inactive slots sit at 0), as in the JAX rule."""
    import dataclasses

    jc = dataclasses.replace(JCFG, max_position_embeddings=64)
    tc = dataclasses.replace(TCFG, max_position_embeddings=64)
    for pos in ([[3], [0], [40]], [[90], [0], [12]]):
        jcos, jsin = jllm.cos_sin_for(jc, jnp.asarray(pos, jnp.int32), 256)
        tcos, tsin = tllm.cos_sin_for(tc, torch.tensor(pos, dtype=torch.int64), 256)
        np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), atol=1e-5)
        np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), atol=1e-5)


# ------------------------------------------------------------ ContinuousBatcher


@pytest.mark.parametrize("k,rep", [(1, 1.0), (1, 1.3), (4, 1.3)])
def test_continuous_batcher_tokens_match_jax(params, k, rep):
    jp, tp = params
    rows = [_embeds(jp, ids) for ids in PROMPTS]
    kw = dict(num_slots=2, max_len=256, steps_per_sync=k)
    want = _drain(_jbatcher(jp, **kw), JRequest, rows, 7, rep)
    got = _drain(_tbatcher(tp, **kw), TRequest, rows, 7, rep)
    assert got == want
    assert all(len(t) == 7 for t in got.values())


def test_continuous_batcher_matches_generate_from_embeds(params):
    jp, tp = params
    got = _drain(_tbatcher(tp, num_slots=3, max_len=256), TRequest,
                 [_embeds(jp, ids) for ids in PROMPTS], 6, rep=1.5)
    for uid, ids in enumerate(PROMPTS):
        e = torch.from_numpy(_embeds(jp, ids))[None]
        toks, lengths = tgen.generate_from_embeds(
            tp, TCFG, e, torch.ones((1, len(ids)), dtype=torch.int32),
            gen_cfg=tgen.GenerateConfig(max_new_tokens=6, eos_token_ids=(-1,),
                                        repetition_penalty=1.5),
            max_cache_len=256, policy=T_FP32)
        assert got[uid] == toks[0, :int(lengths[0])].tolist()


def test_windowed_equals_single_step_and_slots_refill(params):
    jp, tp = params
    rows = [_embeds(jp, [1, 10 + u]) for u in range(5)]  # 5 requests through 2 slots
    runs = [_drain(_tbatcher(tp, num_slots=2, max_len=256, steps_per_sync=k), TRequest, rows, 5,
                   rep=1.3) for k in (1, 4)]
    assert runs[0] == runs[1]
    assert sorted(runs[0]) == [0, 1, 2, 3, 4] and all(len(t) == 5 for t in runs[0].values())


def test_mixed_bucket_admissions(params):
    """Prompts landing in different buckets admit through the grouped
    multi-row prefill, in both batchers and both sync modes."""
    jp, tp = params
    rng = np.random.RandomState(3)
    prompts = [[1, 5, 9], list(rng.randint(10, 900, 150)), [1, 7, 11, 13],
               list(rng.randint(10, 900, 140))]
    rows = [_embeds(jp, ids) for ids in prompts]
    base = _drain(_jbatcher(jp, num_slots=4, max_len=512), JRequest, rows, 5)
    paged = dict(paged=True, num_slots=4, num_pages=64, page_size=64, max_pages_per_slot=8)
    for kw in (dict(num_slots=4, max_len=512), dict(num_slots=4, max_len=512, steps_per_sync=4),
               paged, dict(paged, steps_per_sync=4)):
        assert _drain(_tbatcher(tp, **kw), TRequest, rows, 5) == base


def test_overlong_prompt_rejected_not_crash(params):
    jp, tp = params
    b = _tbatcher(tp, num_slots=2, max_len=256, steps_per_sync=4)
    rng = np.random.RandomState(3)
    b.submit(TRequest(0, _embeds(jp, rng.randint(10, 900, 200)), max_new_tokens=8,
                      eos_token_ids=(-1,)))  # bucket 256 + window 4 > 256
    b.submit(TRequest(1, _embeds(jp, [1, 5, 9]), max_new_tokens=6, eos_token_ids=(-1,)))
    by_uid = {r.uid: r for r in b.run()}
    assert by_uid[0].error is not None and by_uid[0].tokens == []
    assert by_uid[1].error is None and len(by_uid[1].tokens) == 6


def test_eos_retires_a_request_early(params):
    jp, tp = params
    rows = [_embeds(jp, PROMPTS[0])]
    full = _drain(_tbatcher(tp, num_slots=1, max_len=256), TRequest, rows, 6)[0]
    b = _tbatcher(tp, num_slots=1, max_len=256)
    b.submit(TRequest(0, rows[0], max_new_tokens=6, eos_token_ids=(full[2],)))
    assert b.run()[0].tokens == full[:full.index(full[2]) + 1]


# ------------------------------------------------------------ prefix cache


def _prefix_prompts(seed, n_prefix, tails):
    rng = np.random.default_rng(seed)
    prefix = [1] + list(rng.integers(2, 50, size=n_prefix - 1))
    return prefix, [prefix + list(rng.integers(2, 50, size=n)) for n in tails]


BATCHERS = {
    "contiguous": dict(num_slots=4, max_len=256),
    "paged": dict(paged=True, num_slots=4, num_pages=24, page_size=64, max_pages_per_slot=4),
}


@pytest.mark.parametrize("kind", sorted(BATCHERS))
def test_prefix_cache_token_parity(params, kind):
    """Requests sharing a registered prefix decode to the tokens of a batcher
    with no prefix cache, and to the JAX batcher's; a request that matches no
    prefix is unaffected."""
    jp, tp = params
    prefix, prompts = _prefix_prompts(0, 20, (3, 5, 7))
    prompts.append([1, 42, 17, 23])
    rows = [_embeds(jp, ids) for ids in prompts]

    def run(register):
        b = _tbatcher(tp, **BATCHERS[kind])
        if register:
            assert b.register_prefix(_embeds(jp, prefix), quantum=4) == 20
        return _drain(b, TRequest, rows, 6), b

    base, b0 = run(False)
    cached, b1 = run(True)
    assert b0.prefix_hits == 0 and b1.prefix_hits == 3
    assert cached == base
    jb = _jbatcher(jp, **BATCHERS[kind])
    assert jb.register_prefix(_embeds(jp, prefix), quantum=4) == 20
    assert _drain(jb, JRequest, rows, 6) == cached
    if kind == "paged":
        assert len(b1.pool.free) == 23


@pytest.mark.parametrize("kind", sorted(BATCHERS))
def test_register_prefix_quantum_dedup_clamp_and_lru(params, kind):
    jp, tp = params
    b = _tbatcher(tp, **BATCHERS[kind])
    e = _embeds(jp, np.arange(1, 11))  # 10 rows
    assert b.register_prefix(e, quantum=4) == 8  # floored to the quantum
    assert b.register_prefix(e, quantum=4) == 8  # dedup: no second entry
    assert len(b.prefixes) == 1
    assert b.register_prefix(e[:3], quantum=4) == 0  # too short
    # an entry owns its storage: plen positions, not a slice of a larger cache
    entry = b.prefixes[0]
    assert entry.k.shape == (TCFG.num_hidden_layers, TCFG.num_key_value_heads, 8, TCFG.head_dim)
    assert entry.k.untyped_storage().nbytes() == entry.k.numel() * entry.k.element_size()
    # longer than the cache: clamped so that a hit leaves suffix room
    long = _embeds(jp, np.arange(400) % 50 + 1)
    assert b.register_prefix(long, quantum=16) == 256 - 16
    # LRU cap: the least recently hit entry goes
    b.max_prefixes = 3
    for i in range(3):
        assert b.register_prefix(_embeds(jp, np.arange(8) + 100 + 10 * i), quantum=4) == 8
    assert len(b.prefixes) == 3
    assert [p.plen for p in b.prefixes] == sorted((p.plen for p in b.prefixes), reverse=True)


@pytest.mark.parametrize("kind", sorted(BATCHERS))
def test_distinct_prefixes_of_one_length_in_one_admission(params, kind):
    """Two registered prefixes of the same quantized length must not collapse
    into one admission group: each request prefills over its own prefix KV."""
    jp, tp = params
    rng = np.random.default_rng(7)
    pre_a = [1] + list(rng.integers(2, 50, size=19))
    pre_b = [2] + list(rng.integers(2, 50, size=19))
    prompts = [pre + list(rng.integers(2, 50, size=n)) for n in (5, 7) for pre in (pre_a, pre_b)]
    rows = [_embeds(jp, ids) for ids in prompts]
    base = _drain(_tbatcher(tp, **BATCHERS[kind]), TRequest, rows, 6)
    b = _tbatcher(tp, **BATCHERS[kind])
    for pre in (pre_a, pre_b):
        assert b.register_prefix(_embeds(jp, pre), quantum=4) == 20
    assert _drain(b, TRequest, rows, 6) == base
    assert b.prefix_hits == 4


@pytest.mark.parametrize("kind", sorted(BATCHERS))
def test_register_prefix_incremental_extension(params, kind, monkeypatch):
    """Registering a prompt that extends a registered prefix prefills only the
    delta over the base KV and yields the entry a from-scratch registration
    yields."""
    jp, tp = params
    rng = np.random.default_rng(3)
    base_ids = [1] + list(rng.integers(2, 50, size=7))
    full_ids = base_ids + list(rng.integers(2, 50, size=8))
    b = _tbatcher(tp, **BATCHERS[kind])
    deltas = []
    orig = b._extend_prefix_kv
    monkeypatch.setattr(b, "_extend_prefix_kv",
                        lambda base, rows: deltas.append((base.plen, rows.shape[0])) or orig(base, rows))
    assert b.register_prefix(_embeds(jp, base_ids), quantum=4) == 8
    assert b.register_prefix(_embeds(jp, full_ids), quantum=4) == 16
    assert deltas == [(8, 8)] and len(b.prefixes) == 2
    b2 = _tbatcher(tp, **BATCHERS[kind])
    assert b2.register_prefix(_embeds(jp, full_ids), quantum=4) == 16
    ext, scratch = b.prefixes[0], b2.prefixes[0]
    np.testing.assert_allclose(ext.k.numpy(), scratch.k.numpy(), atol=1e-4)
    np.testing.assert_allclose(ext.v.numpy(), scratch.v.numpy(), atol=1e-4)
    req_rows = [_embeds(jp, full_ids + list(rng.integers(2, 50, size=5)))]
    assert _drain(b, TRequest, req_rows, 6) == _drain(_tbatcher(tp, **BATCHERS[kind]), TRequest,
                                                      req_rows, 6)
    assert b.prefix_hits == 1
