"""The port's int8 weight-only LLM against the JAX package on the CPU.

Inputs come from numpy seeds (or one JAX-initialised tree moved across with
``from_jax_params``) and go to both frameworks. Tolerances:
- the plain int8 products against the JAX kernels in interpret mode: in fp32,
  max |port - jax| <= 1e-5 * max |jax| (same exact products, fp32 summation
  order only); in bf16, each output within its own bf16 rounding of the fp32
  product (kernels/tolerance.py, the card's check);
- quantization, padding and fusion: bit-identical;
- prefill + 4 greedy decode steps at a 128-wide config: identical tokens,
  logits within 2e-4 (rtol and atol) of both JAX routes, the bound the JAX
  package holds its own kernel route to (tests/test_int8_decode_parity.py);
- the tiny preset's batch_chat_ocr: identical token ids.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from callireader_tpu.core.config import LLMConfig as JLLMConfig
from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.kernels import int8_matmul as jk
from callireader_tpu.models import internlm2 as jllm
from callireader_tpu.runtime import quantize as jq
from callireader_tpu.runtime.engine import CalliReaderEngine as JEngine
from callireader_tpu.runtime.engine import init_all_params
from callireader_tpu.runtime.tokenizer import InternLM2Tokenizer as JTok
from callireader_tpu_torch.core import config as tconfig
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.kernels import int8_matmul as tk
from callireader_tpu_torch.kernels import tolerance
from callireader_tpu_torch.models import internlm2 as tllm
from callireader_tpu_torch.runtime import quantize as tq
from callireader_tpu_torch.runtime.engine import CalliReaderEngine as TEngine
from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer as TTok
from callireader_tpu_torch.runtime.weights import from_jax_params

SHAPES = [(4, 512, 1024), (1, 1024, 1280), (16, 4096, 512), (3, 256, 128)]
REAL_V = 92553
CFG = dict(vocab_size=REAL_V, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
           num_attention_heads=2, num_key_value_heads=1, max_position_embeddings=128)
JCFG, TCFG = JLLMConfig(**CFG), tconfig.LLMConfig(**CFG)


def _t(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _quantized(rng, K, N, L=None):
    shape = (K, N) if L is None else (L, K, N)
    w = rng.standard_normal(shape).astype(np.float32) * 0.02
    scale = np.abs(w).max(-2, keepdims=True) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, np.squeeze(scale, -2).astype(np.float32)


def _close_fp32(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _within_bf16_rounding(got, exact):
    """got: a bf16 result (torch or jax); exact: the fp32 product."""
    got = torch.from_numpy(np.asarray(got, np.float32)) if not isinstance(got, torch.Tensor) else got
    assert got.dtype in (torch.bfloat16, torch.float32)
    assert tolerance.excess_error(got, exact) <= tolerance.ATOL["int8_matmul"]


# ------------------------------------------------------------ plain kernels


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_int8_matmul_plain_matches_jax_interpret(M, K, N):
    rng = np.random.default_rng(M + K + N)
    q, scale = _quantized(rng, K, N)
    h = rng.standard_normal((M, K)).astype(np.float32)
    got = tk.int8_matmul(torch.from_numpy(h), torch.from_numpy(q), torch.from_numpy(scale))
    want = jk.int8_matmul(jnp.asarray(h), jnp.asarray(q), jnp.asarray(scale), interpret=True)
    assert got.dtype == torch.float32
    _close_fp32(got, want)

    hb = torch.from_numpy(h).bfloat16()
    got_b = tk.int8_matmul(hb, torch.from_numpy(q), torch.from_numpy(scale))
    want_b = jk.int8_matmul(jnp.asarray(h, jnp.bfloat16), jnp.asarray(q), jnp.asarray(scale),
                            interpret=True)
    exact = tk.int8_matmul_reference(hb.float(), torch.from_numpy(q), torch.from_numpy(scale))
    assert got_b.dtype == torch.bfloat16 and want_b.dtype == jnp.bfloat16
    _within_bf16_rounding(got_b, exact)
    _within_bf16_rounding(want_b, exact)


@pytest.mark.parametrize("scale_shape", ["(L, N)", "(L, 1, N)"])
def test_int8_matmul_stacked_every_layer(scale_shape):
    """JAX's stacked kernel (layer index into the (L, K, N) stack) against the
    port's route for it: the model slices layer ``i`` as a view and calls
    ``int8_matmul`` on it."""
    rng = np.random.default_rng(2)
    L, M, K, N = 3, 4, 512, 1024
    q, scale = _quantized(rng, K, N, L)
    h = rng.standard_normal((M, K)).astype(np.float32)
    ts = torch.from_numpy(scale if scale_shape == "(L, N)" else scale[:, None])
    stack = {"layers": {"w_q": torch.from_numpy(q), "w_scale": ts}}
    for layer in range(L):
        got = tllm._proj(tllm._layer(stack, layer), torch.from_numpy(h), "w")
        want = jk.int8_matmul_stacked(jnp.asarray(h), jnp.asarray(q), jnp.asarray(scale),
                                      jnp.asarray(layer, jnp.int32), interpret=True)
        _close_fp32(got, want)


@pytest.mark.parametrize("M,K,N", [(4, 128, 92672), (3, 512, 256)])
def test_int8_matmul_nt_plain_matches_jax_interpret(M, K, N):
    rng = np.random.default_rng(K + N)
    q_kn, scale = _quantized(rng, K, N)
    q = np.ascontiguousarray(q_kn.T)  # (N, K): the LM-head layout, per-row scales
    h = rng.standard_normal((M, K)).astype(np.float32)
    got = tk.int8_matmul_nt(torch.from_numpy(h), torch.from_numpy(q), torch.from_numpy(scale))
    want = jk.int8_matmul_nt(jnp.asarray(h), jnp.asarray(q), jnp.asarray(scale), interpret=True)
    _close_fp32(got, want)

    hb = torch.from_numpy(h).bfloat16()
    got_b = tk.int8_matmul_nt(hb, torch.from_numpy(q), torch.from_numpy(scale))
    want_b = jk.int8_matmul_nt(jnp.asarray(h, jnp.bfloat16), jnp.asarray(q), jnp.asarray(scale),
                               interpret=True)
    exact = tk.int8_matmul_nt_reference(hb.float(), torch.from_numpy(q), torch.from_numpy(scale))
    _within_bf16_rounding(got_b, exact)
    _within_bf16_rounding(want_b, exact)


@pytest.mark.parametrize("nt", [False, True])
def test_tolerance_passes_rounding_and_fails_dropped_k_block(nt):
    """The card's check passes the output's own bf16 rounding and fails an
    output that lost one 128-deep K block."""
    rng = np.random.default_rng(23)
    M, K, N = 4, 4096, 512
    q, scale = (torch.from_numpy(x) for x in _quantized(rng, K, N))
    h = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).bfloat16().float()
    if nt:
        q = q.T.contiguous()
    run = tk.int8_matmul_nt_reference if nt else tk.int8_matmul_reference
    name = "int8_matmul_nt" if nt else "int8_matmul"
    want = run(h, q, scale)
    cut = h.clone()
    cut[:, 1024:1152] = 0
    assert tolerance.excess_error(want.bfloat16(), want) <= tolerance.ATOL[name]
    assert tolerance.excess_error(run(cut, q, scale).bfloat16(), want) > 10 * tolerance.ATOL[name]


# ------------------------------------------------------------ quantization


@pytest.fixture(scope="module")
def fp32_tree():
    return jllm.init_params(jax.random.PRNGKey(5), JCFG, jnp.float32)


def _assert_trees_identical(got, want):
    want = jax.tree_util.tree_map(np.asarray, want)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_identical(got[k], want[k])
            continue
        g, w = got[k].numpy(), want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g.view(np.uint8), w.view(np.uint8)), k


def test_quantize_pad_fuse_bit_identical(fp32_tree):
    jqp = jq.quantize_llm_int8(fp32_tree)
    tqp = tq.quantize_llm_int8(_t(fp32_tree))
    _assert_trees_identical(tqp, jqp)

    jpad, jcfg = jllm.pad_vocab(jqp, JCFG, 128)
    tpad, tcfg = tllm.pad_vocab(tqp, TCFG, 128)
    _assert_trees_identical(tpad, jpad)
    assert (tcfg.vocab_size, tcfg.real_vocab_size) == (jcfg.vocab_size, jcfg.real_vocab_size) == (92672, REAL_V)

    _assert_trees_identical(tq.fuse_llm_int8(tpad), jq.fuse_llm_int8(jpad))
    assert tq.param_bytes(tq.fuse_llm_int8(tpad)) == jq.param_bytes(jq.fuse_llm_int8(jpad))


@pytest.mark.parametrize("axis", [-1, 0])
def test_quantize_weight_bit_identical(axis):
    w = np.random.default_rng(4).standard_normal((96, 40)).astype(np.float32) * 0.05
    w[3, 5] = 0.0
    jqv, js = jq.quantize_weight(jnp.asarray(w), axis=axis)
    tqv, ts = tq.quantize_weight(torch.from_numpy(w), axis=axis)
    assert np.array_equal(tqv.numpy(), np.asarray(jqv))
    assert np.array_equal(ts.numpy().view(np.uint32), np.asarray(js).view(np.uint32))


def test_fuse_skips_lora_and_unquantized_trees(fp32_tree):
    tqp = tq.quantize_llm_int8(_t(fp32_tree))
    lora = dict(tqp, layers=dict(tqp["layers"], wq_lora_a=torch.zeros(1)))
    assert tq.fuse_llm_int8(lora) is lora
    plain = _t(fp32_tree)
    assert tq.fuse_llm_int8(plain) is plain


def test_init_llm_int8_matches_jax_tree():
    cfg_j, cfg_t = callireader_tiny().llm, tconfig.callireader_tiny().llm
    want = jq.init_llm_int8_device(jax.random.PRNGKey(0), cfg_j, fused=True)
    got = tq.init_llm_int8(cfg_t, torch.Generator().manual_seed(0), device="cpu")

    def sig(tree, name):
        return {k: sig(v, name) if isinstance(v, dict) else (tuple(v.shape), name(v.dtype))
                for k, v in tree.items()}

    assert sig(got, lambda d: str(d).replace("torch.", "")) == sig(want, lambda d: str(d))
    for k in ("wqkv", "wo", "w13", "w2"):  # absmax rows hit +-127 exactly once scaled
        q = got["layers"][f"{k}_q"]
        assert (q.abs().amax(dim=1) == 127).all()
        assert (got["layers"][f"{k}_scale"] > 0).all()


# ------------------------------------------------------------ LLM int8


@pytest.fixture(scope="module")
def llm_int8():
    """The 128-wide config's LLM, quantized and 128-padded in JAX, unfused
    and fused, in both packages."""
    params = jllm.init_params(jax.random.PRNGKey(0), JCFG, jnp.float32)
    qparams, jcfg = jllm.pad_vocab(jq.quantize_llm_int8(params), JCFG, 128)
    fused = dict(qparams, layers=jq.fuse_llm_int8({"layers": qparams["layers"]})["layers"])
    assert "wqkv_q" in fused["layers"] and "w13_q" in fused["layers"]
    _, tcfg = tllm.pad_vocab({}, TCFG, 128)
    return jcfg, tcfg, {"unfused": qparams, "fused": fused}


IDS = np.random.RandomState(0).randint(5, 900, (2, 7))


def _jax_run(params, cfg, mode, monkeypatch):
    monkeypatch.setenv("CALLIREADER_INT8_KERNEL", mode)
    logits, cache = jllm.prefill(params, cfg, input_ids=jnp.asarray(IDS), max_len=32,
                                 cache_dtype=jnp.float32, policy=J_FP32, use_flash=False)
    toks, all_logits = [], []
    for step in range(5):
        if step:
            logits, cache = jllm.decode_step(params, cfg, input_ids=cur, cache=cache,
                                             policy=J_FP32, use_flash=False)
        cur = jnp.argmax(logits, -1)[:, None]
        toks.append(np.asarray(cur[:, 0]))
        all_logits.append(np.asarray(logits, np.float32))
    return np.stack(toks), all_logits


def _port_run(params, cfg):
    emb = tllm.embed_tokens(params, torch.from_numpy(IDS), torch.float32)
    logits, cache = tllm.prefill(params, cfg, inputs_embeds=emb,
                                 attention_mask=torch.ones(IDS.shape, dtype=torch.int32),
                                 max_len=32, cache_dtype=torch.float32, policy=T_FP32)
    toks, all_logits = [], []
    for step in range(5):
        if step:
            logits, cache = tllm.decode_step(params, cfg, input_ids=cur, cache=cache, policy=T_FP32)
        cur = torch.argmax(logits, -1)[:, None].to(torch.int32)
        toks.append(cur[:, 0].numpy())
        all_logits.append(logits.numpy())
    return np.stack(toks), all_logits


@pytest.mark.parametrize("layout", ["unfused", "fused"])
def test_llm_int8_prefill_decode_matches_both_jax_routes(llm_int8, layout, monkeypatch):
    jcfg, tcfg, trees = llm_int8
    toks, logits = _port_run(_t(trees[layout]), tcfg)
    for mode in ("interpret", "0"):
        jtoks, jlogits = _jax_run(trees[layout], jcfg, mode, monkeypatch)
        np.testing.assert_array_equal(toks, jtoks)
        for a, b in zip(logits, jlogits):
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4)
    assert (toks < REAL_V).all()
    for lg in logits:  # pad rows never win
        assert (lg[:, REAL_V:] == np.finfo(np.float32).min).all()
        assert (lg.argmax(-1) < REAL_V).all()


def _count_routes(monkeypatch):
    """Calls of the (K, N) kernel (the layer projections) and of the (N, K)
    LM-head kernel from the model."""
    counts = {"kn": 0, "nt": 0}
    for key, name in (("kn", "int8_matmul"), ("nt", "int8_matmul_nt")):
        orig = getattr(tllm, name)

        def spy(*a, _orig=orig, _key=key):
            counts[_key] += 1
            return _orig(*a)

        monkeypatch.setattr(tllm, name, spy)
    return counts


@pytest.mark.parametrize("S,prefill_kn", [(20, 0), (16, 4 * 2)])
def test_int8_routes_by_rows(llm_int8, monkeypatch, S, prefill_kn):
    """Prefill of 2 x 20 rows keeps its projections on the XLA form and sends
    only the LM head (2 rows) to the nt kernel; 2 x 16 = 32 rows take the
    kernel route, as in JAX. Each decode step: 4 x L (K, N) + 1 nt."""
    _, tcfg, trees = llm_int8
    params = _t(trees["fused"])
    counts = _count_routes(monkeypatch)
    emb = torch.from_numpy(np.random.default_rng(S).standard_normal((2, S, 128)).astype(np.float32))
    _, cache = tllm.prefill(params, tcfg, inputs_embeds=emb,
                            attention_mask=torch.ones((2, S), dtype=torch.int32),
                            max_len=S + 4, cache_dtype=torch.float32, policy=T_FP32)
    assert counts == {"kn": prefill_kn, "nt": 1}
    for step in range(1, 3):
        tllm.decode_step(params, tcfg, input_ids=torch.full((2, 1), 7, dtype=torch.int32),
                         cache=cache, policy=T_FP32)
        assert counts == {"kn": prefill_kn + 4 * 2 * step, "nt": 1 + step}


def test_int8_2d_weight_route():
    """One layer's (K, N) int8 weight takes the kernel for few rows and the
    XLA form otherwise, with its rounding."""
    rng = np.random.default_rng(9)
    q, scale = (torch.from_numpy(x) for x in _quantized(rng, 256, 384))
    p = {"w_q": q, "w_scale": scale[None]}
    few = torch.from_numpy(rng.standard_normal((2, 3, 256)).astype(np.float32)).bfloat16()
    many = torch.from_numpy(rng.standard_normal((3, 20, 256)).astype(np.float32)).bfloat16()
    assert torch.equal(tllm._proj(p, few, "w"),
                       tk.int8_matmul_reference(few.reshape(6, 256), q, scale).reshape(2, 3, 384))
    assert torch.equal(tllm._proj(p, many, "w"), (many @ q.bfloat16()) * scale.bfloat16())


# ------------------------------------------------------------ end to end


def _page(seed, w, h):
    rng = np.random.default_rng(seed)
    page = np.full((h, w, 3), 236, np.uint8)
    page += rng.integers(0, 16, page.shape, dtype=np.uint8)
    boxes = []
    for c in range(2):
        for r in range(3):
            x0, y0 = 6 + c * 30, 6 + r * 28
            bw, bh = int(rng.integers(14, 24)), int(rng.integers(14, 24))
            page[y0:y0 + bh, x0:x0 + bw] = rng.integers(10, 70, (bh, bw, 3), dtype=np.uint8)
            boxes.append([float(x0), float(y0), float(x0 + bw), float(y0 + bh)])
    return page, boxes


def test_batch_chat_ocr_int8_tokens_match_jax():
    """The tiny preset with the JAX-quantized, 128-padded, fused LLM."""
    cfg = callireader_tiny()
    params = init_all_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    llm, llm_cfg = jllm.pad_vocab(jq.quantize_llm_int8(params["llm"]), cfg.llm, 128)
    params["llm"] = jq.fuse_llm_int8(llm)
    cfg = dataclasses.replace(cfg, llm=llm_cfg)
    jeng = JEngine(cfg, params, JTok("callireader_tpu/assets/tokenizer.model"),
                   policy=J_FP32, use_flash=False, device_tile_pages=True)
    tcfg = tconfig.callireader_tiny()
    _, tllm_cfg = tllm.pad_vocab({}, tcfg.llm, 128)
    teng = TEngine(dataclasses.replace(tcfg, llm=tllm_cfg), _t(params), TTok(), device="cpu",
                   policy=T_FP32)
    assert teng.cfg.llm.vocab_size == 92672 and teng.cfg.llm.real_vocab_size == 92554

    (p0, b0), (p1, b1) = _page(0, 70, 96), _page(1, 100, 90)
    questions = ["读出图中所有文字。", "这幅书法作品内容是什么？"]
    jrows = jeng.batch_build_rows([p0, p1], questions, ordered_lists=[b0, b1])
    jprep = jeng.batch_prepare([], [], prepared_rows=jrows, max_new_tokens=6,
                               repetition_penalty=1.5)
    tprep = teng.batch_prepare([p0, p1], questions, ordered_lists=[b0, b1], max_new_tokens=6,
                               repetition_penalty=1.5)
    np.testing.assert_allclose(tprep["embeds"].numpy(), np.asarray(jrows["embeds"]), atol=1e-4)
    assert (tprep["lengths"].numpy() == np.asarray(jprep["lengths"])).all()
    assert (tprep["tokens"].numpy() == np.asarray(jprep["tokens"])).all()
    assert teng.batch_decode(tprep) == jeng.batch_decode(jprep)


def test_build_engine_refuses_unknown_quant():
    from callireader_tpu_torch.runtime.engine import build_engine

    with pytest.raises(ValueError, match="quant"):
        build_engine("callireader-tiny", device="cpu", quant="int4")
