"""The decode loop as chunks of device-resident steps (runtime/generate.py
``DecodeState`` / ``_decode_chunk``) and its CUDA graphs
(runtime/decode_graph.py).

CPU: the chunks, uncaptured, against the JAX package's on-device
``while_loop`` (tiny LLM, fp32 policy, weights through ``from_jax_params``,
the same numpy embeddings to both): token ids and lengths equal, including
rows left-padded under a repetition penalty, a ``max_new_tokens`` that is not
a multiple of the chunk, and every row reaching eos before the end (the loop
stops at the first chunk boundary). The async ``batch_prepare`` +
``batch_decode`` give the texts of ``batch_chat_ocr`` and of the JAX engine.

Card (marked ``cuda``; ``pytest --noconftest -m cuda tests/test_torch_decode_graph.py``):
the graphs replayed against the same chunks and ticks run uncaptured, token
ids equal, for greedy, tail and sampled generation, the contiguous and the
paged server at k = 1 and 8; the replay-aware launch counts equal the eager
ones; a capture that fails raises.
"""

import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from callireader_tpu_torch.kernels._build import COUNTS
from callireader_tpu_torch.models import internlm2 as tllm
from callireader_tpu_torch.runtime import decode_graph
from callireader_tpu_torch.runtime import generate as tgen


@pytest.fixture(scope="module")
def jx():
    """The JAX side (imported here so the card-only cases of this file run
    where JAX is absent)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from callireader_tpu.core.config import callireader_tiny
    from callireader_tpu.core.dtypes import FP32_POLICY
    from callireader_tpu.models import internlm2 as jllm
    from callireader_tpu.runtime import generate as jgen
    from callireader_tpu_torch.core import config as tconfig
    from callireader_tpu_torch.runtime.weights import from_jax_params

    jcfg = callireader_tiny().llm
    jp = jllm.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    tp = from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    return types.SimpleNamespace(jax=jax, jnp=jnp, jgen=jgen, jllm=jllm, jcfg=jcfg, jp=jp,
                                 J_FP32=FP32_POLICY, tcfg=tconfig.callireader_tiny().llm, tp=tp)


def _rows(jx, seed, lengths, S):
    """Left-padded prompt embeddings (B, S, E) and mask from random ids."""
    rng = np.random.default_rng(seed)
    emb = np.array(jx.jnp.take(jx.jp["tok_embeddings"],
                               jx.jnp.asarray(rng.integers(3, 900, (len(lengths), S))), axis=0))
    mask = np.zeros((len(lengths), S), np.int32)
    for b, n in enumerate(lengths):
        mask[b, S - n:] = 1
        emb[b, :S - n] = 0.0
    return emb.astype(np.float32), mask


def _jax_generate(jx, emb, mask, max_new, **kw):
    gcfg = jx.jgen.GenerateConfig(max_new_tokens=max_new, **kw)
    toks, lens = jx.jgen.generate_from_embeds(
        jx.jp, jx.jcfg, jx.jnp.asarray(emb), jx.jnp.asarray(mask), gen_cfg=gcfg,
        max_cache_len=emb.shape[1] + max_new, policy=jx.J_FP32, use_flash=False)
    return np.asarray(toks), np.asarray(lens)


def _port_generate(jx, emb, mask, max_new, overlap=False, **kw):
    from callireader_tpu_torch.core.dtypes import FP32_POLICY

    gcfg = tgen.GenerateConfig(max_new_tokens=max_new, **kw)
    steps = tllm.DECODE_STEPS.launches
    toks, lens = tgen.generate_from_embeds(
        jx.tp, jx.tcfg, torch.from_numpy(emb), torch.from_numpy(mask), gen_cfg=gcfg,
        max_cache_len=emb.shape[1] + max_new, policy=FP32_POLICY, overlap=overlap)
    return toks.numpy(), lens.numpy(), tllm.DECODE_STEPS.launches - steps


@pytest.mark.parametrize("case", ["penalty_left_padded", "tail", "eos_every_row"])
def test_chunked_generate_matches_jax(jx, case):
    emb, mask = _rows(jx, 3, [5, 9, 16], 16)
    if case == "penalty_left_padded":
        kw, T = dict(eos_token_ids=(-1,), repetition_penalty=1.5), 16
    elif case == "tail":  # 13 = one chunk of 8 and a tail of 5
        kw, T = dict(eos_token_ids=(-1,), repetition_penalty=1.3), 13
    else:
        # eos = a token each row emits within its first 3 steps: every row is
        # done before the first chunk boundary, where the loop must stop
        first, _ = _jax_generate(jx, emb, mask, 3, eos_token_ids=(-1,), repetition_penalty=1.2)
        kw, T = dict(eos_token_ids=tuple(int(first[b, 1 + b % 2]) for b in range(3)),
                     repetition_penalty=1.2), 24
    jt, jl = _jax_generate(jx, emb, mask, T, **kw)
    tt, tl, steps = _port_generate(jx, emb, mask, T, **kw)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tt, jt)
    if case == "eos_every_row":
        assert (jl <= 3).all() and steps == tgen.SYNC_EVERY
        assert (tt[:, 3:] == 2).all()  # pad after eos
    else:
        assert steps == T and (tl == T).all()


def test_overlap_enqueues_every_chunk(jx):
    """``overlap=True`` runs all T steps without a look at ``done`` (chunks
    after every row is done are pad steps) and gives the same tokens."""
    emb, mask = _rows(jx, 4, [7, 11], 12)
    first, _ = _jax_generate(jx, emb, mask, 2, eos_token_ids=(-1,))
    kw = dict(eos_token_ids=(int(first[0, 0]), int(first[1, 1])))
    polled_t, polled_l, polled_steps = _port_generate(jx, emb, mask, 24, **kw)
    t, l, steps = _port_generate(jx, emb, mask, 24, overlap=True, **kw)
    np.testing.assert_array_equal(t, polled_t)
    np.testing.assert_array_equal(l, polled_l)
    assert polled_steps == 8 and steps == 24
    assert tgen.pad_steps(t, l, kw["eos_token_ids"]) == 16
    # a row that never reaches eos: nothing is padding
    assert tgen.pad_steps(t, l, (-1,)) == 0


def test_plan_and_pad_steps():
    assert tgen._plan(16) == [8, 8] and tgen._plan(13) == [8, 5] and tgen._plan(3) == [3]
    tokens = np.full((2, 20), 2, np.int32)
    tokens[0, :3], tokens[1, :10] = [5, 6, 9], np.arange(10, 20)
    # row 0 ends at 3, row 1 at 10 (eos 19): the polled loop stops after 16 steps
    assert tgen.pad_steps(tokens, np.array([3, 10]), (9, 19)) == 4
    assert tgen.pad_steps(tokens, np.array([3, 10]), (9,)) == 0


def test_decode_step_at_equals_decode_step(jx):
    """The device-slot step writes and attends what the host-slot step does,
    and marks the slot in the validity buffer in place."""
    from callireader_tpu_torch.core.dtypes import FP32_POLICY

    emb, mask = _rows(jx, 5, [6, 8], 8)
    out = []
    for at in (False, True):
        logits, cache = tllm.prefill(jx.tp, jx.tcfg, inputs_embeds=torch.from_numpy(emb),
                                     attention_mask=torch.from_numpy(mask), max_len=12,
                                     policy=FP32_POLICY)
        valid = torch.zeros((2, 12), dtype=torch.int32)
        valid[:, :8] = torch.from_numpy(mask)
        ids = logits.argmax(-1)[:, None].int()
        if at:
            lg = tllm.decode_step_at(jx.tp, jx.tcfg, input_ids=ids, cache=cache, kv_valid=valid,
                                     slot=torch.tensor([8]), policy=FP32_POLICY)
            assert cache.length == 8 and valid[:, 8].tolist() == [1, 1]
        else:
            lg, cache = tllm.decode_step(jx.tp, jx.tcfg, input_ids=ids, cache=cache,
                                         kv_valid_mask=valid, policy=FP32_POLICY)
        out.append((lg, cache.k.clone(), cache.v.clone()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_prefill_fills_a_given_cache(jx):
    from callireader_tpu_torch.core.dtypes import FP32_POLICY

    emb, mask = _rows(jx, 6, [4, 6], 6)
    fresh_logits, fresh = tllm.prefill(jx.tp, jx.tcfg, inputs_embeds=torch.from_numpy(emb),
                                       attention_mask=torch.from_numpy(mask), max_len=10,
                                       policy=FP32_POLICY)
    own = tllm.KVCache.create(jx.tcfg, 2, 10, torch.bfloat16, "cpu")
    logits, cache = tllm.prefill(jx.tp, jx.tcfg, inputs_embeds=torch.from_numpy(emb),
                                 attention_mask=torch.from_numpy(mask), max_len=10,
                                 policy=FP32_POLICY, cache=own)
    assert cache is own and cache.length == 6
    assert torch.equal(logits, fresh_logits) and torch.equal(own.k, fresh.k)
    with pytest.raises(ValueError, match="holds"):
        tllm.prefill(jx.tp, jx.tcfg, inputs_embeds=torch.from_numpy(emb),
                     attention_mask=torch.from_numpy(mask), max_len=12, policy=FP32_POLICY,
                     cache=own)


def test_step_graph_on_cpu_calls_its_function():
    hits = []
    g = decode_graph.StepGraph(torch.device("cpu"))
    assert [g(lambda: hits.append(1) or len(hits)) for _ in range(3)] == [1, 2, 3]
    assert not g.captured


def test_graph_cache_lru_and_parameter_identity():
    cache = decode_graph.GraphCache(capacity=2)
    p1 = {"a": torch.zeros(2), "layers": {"w": torch.ones(3)}}
    p2 = {"a": torch.zeros(2), "layers": {"w": torch.ones(3)}}
    built = []

    def build(tag):
        built.append(tag)
        return tag

    assert cache.get("k", p1, lambda: build("p1")) == "p1"
    assert cache.get("k", p1, lambda: build("again")) == "p1"  # a hit
    assert cache.get("k", p2, lambda: build("p2")) == "p2"  # other tensors, other entry
    # a new leaf in place of an old one is another parameter set
    p1b = dict(p1, layers={"w": torch.ones(3)})
    assert cache.get("k", p1b, lambda: build("p1b")) == "p1b"
    assert len(cache) == 2 and built == ["p1", "p2", "p1b"]  # the LRU dropped p1's entry
    del p2
    import gc
    gc.collect()
    assert len(cache) == 1  # p2's leaves died: its entry went with them
    cache.discard("p1b")
    assert len(cache) == 0


@pytest.fixture(scope="module")
def engines():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from callireader_tpu.core.config import callireader_tiny
    from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
    from callireader_tpu.runtime.engine import CalliReaderEngine as JEngine
    from callireader_tpu.runtime.engine import init_all_params
    from callireader_tpu.runtime.tokenizer import InternLM2Tokenizer as JTok
    from callireader_tpu_torch.core.config import callireader_tiny as t_tiny
    from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
    from callireader_tpu_torch.runtime.engine import CalliReaderEngine as TEngine
    from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer as TTok
    from callireader_tpu_torch.runtime.weights import from_jax_params

    cfg = callireader_tiny()
    params = init_all_params(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    jeng = JEngine(cfg, params, JTok("callireader_tpu/assets/tokenizer.model"),
                   policy=J_FP32, use_flash=False, device_tile_pages=True)
    teng = TEngine(t_tiny(), from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                             device="cpu"), TTok(),
                   device="cpu", policy=T_FP32, device_tile_pages=True)
    return jeng, teng


def _page(seed, w, h):
    rng = np.random.default_rng(seed)
    page = np.full((h, w, 3), 230, np.uint8) + rng.integers(0, 20, (h, w, 3), dtype=np.uint8)
    boxes = []
    for c in range(2):
        for r in range(2):
            x0, y0 = 6 + c * 30, 6 + r * 30
            page[y0:y0 + 18, x0:x0 + 16] = rng.integers(10, 70, (18, 16, 3), dtype=np.uint8)
            boxes.append([float(x0), float(y0), float(x0 + 16), float(y0 + 18)])
    return page, boxes


def test_async_batch_prepare_matches_batch_chat_ocr_and_jax(engines):
    jeng, teng = engines
    (p0, b0), (p1, b1) = _page(7, 72, 80), _page(8, 90, 70)
    pages, ordered, questions = [p0, p1], [b0, b1], ["读出图中所有文字。", "你好"]
    jrows = jeng.batch_build_rows(pages, questions, ordered_lists=ordered)
    jprep = jeng.batch_prepare([], [], prepared_rows=jrows, max_new_tokens=11,
                               repetition_penalty=1.5)
    jtext = jeng.batch_decode(jprep)
    tprep = teng.batch_prepare(pages, questions, ordered_lists=ordered, max_new_tokens=11,
                               repetition_penalty=1.5)
    assert tprep["overlap"] and "pad_steps" not in tprep
    ttext = teng.batch_decode(tprep)
    np.testing.assert_array_equal(tprep["lengths"].numpy(), np.asarray(jprep["lengths"]))
    np.testing.assert_array_equal(tprep["tokens"].numpy(), np.asarray(jprep["tokens"]))
    assert ttext == jtext
    assert tprep["pad_steps"] == tgen.pad_steps(tprep["tokens"].numpy(),
                                                tprep["lengths"].numpy(),
                                                tprep["gen_cfg"].eos_token_ids)
    assert teng.batch_chat_ocr(pages, questions, ordered_lists=ordered, max_new_tokens=11,
                               repetition_penalty=1.5) == ttext


# ---------------------------------------------------------------- the card

SMALL = dict(vocab_size=2048, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
             num_attention_heads=4, num_key_value_heads=1)  # D = 128, 4 query heads a KV head


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from callireader_tpu_torch.core.config import LLMConfig
    from callireader_tpu_torch.runtime.quantize import init_llm_int8

    cfg = LLMConfig(**SMALL)
    params = init_llm_int8(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    B, S = 3, 128
    emb = torch.randn((B, S, cfg.hidden_size), generator=g, device="cuda").bfloat16()
    mask = torch.ones((B, S), dtype=torch.int32, device="cuda")
    mask[0, :40], mask[1, :5] = 0, 0
    return types.SimpleNamespace(cfg=cfg, params=params, emb=emb, mask=mask)


def _counts():
    """The launch counts (the program's own counters, span totals among
    them, are no launches)."""
    return {c.name: c.launches for c in COUNTS if c.replayed}


def _zero():
    for c in COUNTS:
        c.launches = 0


def _card_generate(card, T, eager, **kw):
    gcfg = tgen.GenerateConfig(max_new_tokens=T, **kw)
    gen = (torch.Generator(device="cuda").manual_seed(11) if gcfg.do_sample else None)
    _zero()
    toks, lens = tgen.generate_from_embeds(card.params, card.cfg, card.emb, card.mask,
                                           gen_cfg=gcfg, max_cache_len=card.emb.shape[1] + T,
                                           generator=gen, eager=eager)
    return toks.cpu(), lens.cpu(), _counts()


SAMPLED = dict(do_sample=True, temperature=0.7, top_k=40, top_p=0.9)


@pytest.mark.cuda
@pytest.mark.parametrize("case,T,kw", [
    ("greedy", 24, dict(eos_token_ids=(-1,), repetition_penalty=1.5)),
    ("tail", 29, dict(eos_token_ids=(-1,), repetition_penalty=1.2)),
    ("sampled", 28, dict(eos_token_ids=(-1,), **SAMPLED)),
    ("sampled_own_generator", 20, dict(eos_token_ids=(-1,), **SAMPLED)),
])
def test_graph_generate_equals_eager(card, case, T, kw):
    eager = _card_generate(card, T, True, **kw)
    if case == "sampled_own_generator":  # no generator: each call seeds its own with 0
        gcfg = tgen.GenerateConfig(max_new_tokens=T, **kw)
        runs = [tgen.generate_from_embeds(card.params, card.cfg, card.emb, card.mask,
                                          gen_cfg=gcfg, max_cache_len=card.emb.shape[1] + T,
                                          eager=e) for e in (True, False, False)]
        for toks, lens in runs[1:]:
            assert torch.equal(toks.cpu(), runs[0][0].cpu())
            assert torch.equal(lens.cpu(), runs[0][1].cpu())
        return
    for _ in range(2):  # the first call captures, the second replays the cached graphs only
        graph = _card_generate(card, T, False, **kw)
        assert torch.equal(graph[0], eager[0]) and torch.equal(graph[1], eager[1]), case
        # replays count as the launches they captured
        assert graph[2] == eager[2] and graph[2]["decode_step"] == T
    if kw.get("do_sample"):  # the draws move between chunks: not one token repeated
        assert len(set(eager[0][0].tolist())) > T // 2


def _card_batcher(card, paged, k, eager):
    from callireader_tpu_torch.runtime.paged_cache import PagedBatcher
    from callireader_tpu_torch.runtime.serving import ContinuousBatcher

    if paged:
        return PagedBatcher(card.params, card.cfg, num_slots=4, num_pages=40, page_size=128,
                            max_pages_per_slot=4, steps_per_sync=k, eager=eager)
    return ContinuousBatcher(card.params, card.cfg, num_slots=4, max_len=512, steps_per_sync=k,
                             eager=eager)


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True], ids=["contiguous", "paged"])
@pytest.mark.parametrize("k", [1, 8])
def test_graph_ticks_equal_eager(card, paged, k):
    from callireader_tpu_torch.runtime.serving import Request

    rows = [card.emb[b, -n:].float().cpu().numpy() for b, n in enumerate((88, 123, 128))]
    rows.append(rows[0][:50])
    out = []
    for eager in (True, False):
        b = _card_batcher(card, paged, k, eager)
        _zero()
        for uid, r in enumerate(rows):  # 4 requests of 30 to 45 tokens: slots retire apart
            b.submit(Request(uid, r, max_new_tokens=30 + 5 * uid, eos_token_ids=(-1,),
                             repetition_penalty=1.3))
        done = b.run()
        out.append(({r.uid: r.tokens for r in done}, _counts()))
        assert eager or b._tick.captured
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1] and out[0][1]["decode_step"] > 0


CAPTURE_FAILS = r"""
import torch
from callireader_tpu_torch.runtime import decode_graph
x = torch.ones(4, device="cuda")
y = torch.zeros(4, device="cuda")
g = decode_graph.StepGraph(torch.device("cuda"))
try:
    # the first run is eager (a host read is allowed there), then the capture meets it
    g(lambda: y.copy_(x * float(x.sum().item())))
except Exception as e:
    print("raised", type(e).__name__)
else:
    raise SystemExit("the capture did not raise")
assert y.tolist() == [4.0] * 4 and not g.captured
"""


@pytest.mark.cuda
def test_capture_failure_raises(card):
    """A capture that meets a host read raises and leaves no graph (in a
    process of its own: a failed capture may leave PyTorch's allocator state
    behind)."""
    r = subprocess.run([sys.executable, "-c", CAPTURE_FAILS], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "raised" in r.stdout, r.stdout + r.stderr
