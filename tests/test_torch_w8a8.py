"""The W8A8 ViT of ``--quant int8-all`` and the int8 tree helpers against
the JAX package (CPU, the same parameters carried across with
from_jax_params).

- quantize_vit_int8 and dequantize_llm_int8: bit for bit.
- The W8A8 tower forward: the int8 activation codes of every layer linear
  are recorded on both sides (the JAX codes through a ``jax.debug.callback``
  on the int8 dot, the port's at ``internvit.int8_product``) and compared
  code for code. With fp32 activations at most 1 code in 1000 may round the
  other way, by one (measured: none); the hidden states agree to 1e-5. With
  bf16 activations the first layer's qkv and proj codes are equal (the same
  bf16 input); deeper inputs differ by bf16 ulps, and one bf16 ulp of a
  row's absmax is about half a code, so at most 30% of all codes may differ,
  each by at most 2 (measured: 14%, max 2); the hidden states agree to 5e-3
  relative L2 (measured: 8.4e-4).
- The int32 sums are exact on the CPU (torch._int_mm; an fp32 product of
  the tower's widths would not be).
- ``--quant int8-all`` runs through cli.inference on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from callireader_tpu.core import dtypes as jd
from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.models import internvit as jvit
from callireader_tpu.runtime import quantize as jq
from callireader_tpu.runtime.engine import init_all_params
from callireader_tpu_torch.cli import common as tcommon
from callireader_tpu_torch.cli import inference as tinf
from callireader_tpu_torch.core import dtypes as td
from callireader_tpu_torch.core.config import callireader_tiny as t_tiny
from callireader_tpu_torch.models import internvit as tvit
from callireader_tpu_torch.runtime import engine as tengine
from callireader_tpu_torch.runtime import quantize as tq
from callireader_tpu_torch.runtime.weights import from_jax_params


@pytest.fixture(scope="module")
def params():
    return init_all_params(jax.random.PRNGKey(0), callireader_tiny(), dtype=jnp.float32)


def _t(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _bits_equal(t_tree, j_tree):
    flat_t = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(t_tree)[0]}
    flat_j = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_flatten_with_path(j_tree)[0]}
    assert flat_t.keys() == flat_j.keys()
    for k, v in flat_t.items():
        j = np.asarray(flat_j[k])
        t = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        j = j.astype(np.float32) if j.dtype == jnp.bfloat16 else j
        assert t.dtype == j.dtype and t.shape == j.shape, k
        assert np.array_equal(t, j), k


def test_quantize_vit_int8_bit_identical(params):
    jv = jq.quantize_vit_int8(params["vision"])
    tv = tq.quantize_vit_int8(_t({"v": params["vision"]})["v"])
    _bits_equal(tv, jv)
    layers = tv["layers"]
    for name in tq.VIT_QUANT_TARGETS:
        assert f"{name}_kernel" not in layers
        assert layers[f"{name}_kernel_q"].dtype == torch.int8
        assert layers[f"{name}_kernel_scale"].shape[1] == 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_llm_int8_bit_identical(params, dtype):
    jq_llm = jq.quantize_llm_int8(params["llm"])
    jd_llm = jq.dequantize_llm_int8(jq_llm, dtype=getattr(jnp, dtype))
    td_llm = tq.dequantize_llm_int8(_t({"l": jq_llm})["l"], dtype=getattr(torch, dtype))
    _bits_equal(td_llm, jd_llm)
    assert "wq_q" not in td_llm["layers"] and "output_q" not in td_llm


def _codes_and_outputs(params, policy_name, monkeypatch):
    jpol = jd.FP32_POLICY if policy_name == "fp32" else jd.DEFAULT_POLICY
    tpol = td.FP32_POLICY if policy_name == "fp32" else td.DEFAULT_POLICY
    jv = jq.quantize_vit_int8(params["vision"])
    tv = _t({"v": jv})["v"]
    px = np.random.RandomState(0).randint(0, 256, (2, 56, 56, 3)).astype(np.uint8)

    jcodes, tcodes = [], []
    dot = jax.lax.dot_general

    def recorded_dot(lhs, rhs, dims, *a, preferred_element_type=None, **kw):
        if preferred_element_type == jnp.int32:
            jax.debug.callback(lambda c: jcodes.append(np.asarray(c)), lhs, ordered=True)
        return dot(lhs, rhs, dims, *a, preferred_element_type=preferred_element_type, **kw)

    with monkeypatch.context() as m:
        m.setattr(jax.lax, "dot_general", recorded_dot)
        jout = np.asarray(jvit.forward(jv, callireader_tiny().vision, jnp.asarray(px), policy=jpol,
                                       use_flash=False).astype(jnp.float32))
    product = tvit.int8_product
    with monkeypatch.context() as m:
        m.setattr(tvit, "int8_product", lambda hq, q: tcodes.append(hq.numpy().copy())
                  or product(hq, q))
        tout = tvit.forward(tv, t_tiny().vision, torch.from_numpy(px), policy=tpol).float().numpy()
    L = callireader_tiny().vision.num_hidden_layers
    assert len(jcodes) == len(tcodes) == 4 * L
    return [(j.reshape(t.shape), t) for j, t in zip(jcodes, tcodes)], jout, tout


def test_w8a8_vit_fp32_codes_equal_jax(params, monkeypatch):
    pairs, jout, tout = _codes_and_outputs(params, "fp32", monkeypatch)
    diffs = [np.abs(j.astype(np.int32) - t.astype(np.int32)) for j, t in pairs]
    n = sum(d.size for d in diffs)
    flips = sum(int((d > 0).sum()) for d in diffs)
    assert all(t.dtype == np.int8 for _, t in pairs)
    assert flips <= n // 1000 and max(int(d.max()) for d in diffs) <= 1
    np.testing.assert_allclose(tout, jout, atol=1e-5)


def test_w8a8_vit_bf16_codes_within_flip_bound(params, monkeypatch):
    pairs, jout, tout = _codes_and_outputs(params, "bf16", monkeypatch)
    for j, t in pairs[:2]:  # layer 0's qkv and proj: the same bf16 inputs
        assert np.array_equal(j, t)
    diffs = [np.abs(j.astype(np.int32) - t.astype(np.int32)) for j, t in pairs]
    n = sum(d.size for d in diffs)
    flips = sum(int((d > 0).sum()) for d in diffs)
    assert flips <= 0.3 * n and max(int(d.max()) for d in diffs) <= 2
    assert np.linalg.norm(tout - jout) <= 5e-3 * np.linalg.norm(jout)


def test_int8_product_is_exact_where_fp32_is_not():
    """Sums past 2^24 at the tower's depth of K: the int32 product equals the
    int64 one; the fp32 product of the same codes does not."""
    g = torch.Generator().manual_seed(0)
    K = 4096
    hq = torch.full((4, K), 127, dtype=torch.int8)
    hq[:, 0] = 1
    q = torch.randint(-127, 128, (K, 24), generator=g, dtype=torch.int8)
    q[:, 0] = 127
    q[0, 0] = 2
    exact = hq.long() @ q.long()
    got = tvit.int8_product(hq, q)
    assert got.dtype == torch.int32 and torch.equal(got.long(), exact)
    # column 0: 2 + 4095 * 127^2, odd and past 2^24, which no fp32 holds
    assert int(exact[0, 0]) == 2 + 4095 * 127 ** 2 > 2 ** 24
    assert (hq.float() @ q.float())[0, 0].double() != exact[0, 0].double()
    # rows through a leading batch shape
    assert torch.equal(tvit.int8_product(hq.reshape(2, 2, K), q).reshape(4, -1), got)


def test_quantize_rows_rounds_half_to_even():
    h = torch.tensor([[127.0, 63.5, -0.5, 1.5, 2.5, -127.0]])
    hq, hs = tvit.quantize_rows(h)
    assert hs.item() == 1.0
    assert hq.tolist() == [[127, 64, 0, 2, 2, -127]]
    zeros, zs = tvit.quantize_rows(torch.zeros((1, 4)))
    assert zeros.abs().sum() == 0 and zs.item() == pytest.approx(1e-6 / 127)


def test_int8_all_runs_through_the_inference_cli(tmp_path, monkeypatch, capsys):
    """cli.inference --quant int8-all on the tiny preset: the int8 LLM, the
    W8A8 tile tower, and a page read through chat_ocr on the CPU."""
    page = np.random.RandomState(1).randint(60, 255, (96, 72, 3)).astype(np.uint8)
    np.save(tmp_path / "page.npy", page)
    built, products = [], []
    build = tcommon.build_engine
    monkeypatch.setattr(tcommon, "build_engine", lambda **kw: built.append(build(**kw)) or built[-1])
    monkeypatch.setattr(tengine.CalliReaderEngine, "chat_ocr",
                        functools.partialmethod(tengine.CalliReaderEngine.chat_ocr, max_new_tokens=4))
    product = tvit.int8_product
    monkeypatch.setattr(tvit, "int8_product", lambda hq, q: products.append(hq.shape) or product(hq, q))
    tinf.main(["--tgt", str(tmp_path / "page.npy"), "--preset", "callireader-tiny", "--random-init",
               "--device", "cpu", "--quant", "int8-all"])
    assert "Assistant:" in capsys.readouterr().out
    (engine,) = built
    assert engine.device_tile_pages is True  # the CLI builder's default, as in JAX
    layers = engine.params["vision"]["layers"]
    assert layers["qkv_kernel_q"].dtype == torch.int8 and "qkv_kernel" not in layers
    assert "wqkv_q" in engine.params["llm"]["layers"]
    assert len(products) >= 4 * t_tiny().vision.num_hidden_layers


def test_quantized_codes_are_column_major_and_the_input_is_kept():
    """quantize_vit_int8 lays each layer's codes out column-major (the fast
    operand order of torch._int_mm on the card), with the same values;
    quantize_rows leaves its fp32 input as it was."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn((2, 8, 24), generator=g)
    tree = tq.quantize_vit_int8({"layers": {f"{n}_kernel": w for n in tq.VIT_QUANT_TARGETS}})
    q = tree["layers"]["fc1_kernel_q"]
    assert q.shape == (2, 8, 24) and q.stride() == (8 * 24, 1, 8)
    scale = torch.clamp(w.abs().amax(1, keepdim=True), min=1e-8) / 127.0
    want = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    assert torch.equal(q.contiguous(), want) and q[1].t().is_contiguous()
    assert torch.equal(tree["layers"]["fc1_kernel_scale"], scale)
    h = torch.randn((3, 8), generator=g)
    kept = h.clone()
    tvit.quantize_rows(h)
    assert torch.equal(h, kept)
