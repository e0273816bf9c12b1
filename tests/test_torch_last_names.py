"""The last JAX functions the port carries under their JAX names, held
against the JAX package on the CPU on the inputs of the JAX package's own
tests (tests/test_completeness.py, test_quantize.py, test_preprocess.py,
test_boxes_metrics.py).

Tolerance: exact (array equality) for the uint8 and integer routes and for
the elementwise float32 ones (``dequantize_weight``, ``to_tensor_normalized``:
the same IEEE operations in the same order); 1e-4 max abs for the float32
MLP resamplers, the tolerance of tests/test_torch_models.py (same math,
XLA and torch sum in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.models import resampler as jres
from callireader_tpu.runtime import quantize as jquant
from callireader_tpu.runtime import tokenizer as jtok
from callireader_tpu.vision import boxes as jboxes
from callireader_tpu.vision import preprocess as jpre
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.models import resampler as tres
from callireader_tpu_torch.runtime import quantize as tquant
from callireader_tpu_torch.runtime import tokenizer as ttok
from callireader_tpu_torch.runtime.weights import from_jax_params
from callireader_tpu_torch.vision import boxes as tboxes
from callireader_tpu_torch.vision import preprocess as tpre

ATOL = 1e-4


def _t(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _shapes(tree):
    return jax.tree_util.tree_map(lambda x: (tuple(x.shape), str(x.dtype).replace("torch.", "")),
                                  tree, is_leaf=lambda x: hasattr(x, "shape"))


def _img(w, h, seed=0):  # tests/test_preprocess.py's page
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8)


@pytest.mark.parametrize("variant", ["mlp_resampler", "mlp_6763"])
def test_mlp_resampler_variants_match_jax(variant):
    k = jax.random.PRNGKey(0)
    x = jax.random.normal(k, (2, 16, 8), jnp.float32)  # test_completeness.py's input
    if variant == "mlp_resampler":
        jp = jres.init_mlp_resampler(k, num_tokens=16, mult=2)
        want = jres.mlp_resampler(jp, x, policy=J_FP32)
        tp = tres.init_mlp_resampler(torch.Generator().manual_seed(0), num_tokens=16, mult=2)
        got = tres.mlp_resampler(_t(jp), torch.from_numpy(np.array(x)), policy=T_FP32)
        assert got.shape == (2, 3, 8)
    else:
        jp = jres.init_mlp_6763(k, input_dim=16 * 8, output_dim=10)
        want = jres.mlp_6763(jp, x, policy=J_FP32)
        tp = tres.init_mlp_6763(torch.Generator().manual_seed(0), input_dim=16 * 8, output_dim=10)
        got = tres.mlp_6763(_t(jp), torch.from_numpy(np.array(x)), policy=T_FP32)
        assert got.shape == (2, 10)
    # the port's own init has the JAX tree's leaves, shapes and dtypes
    assert _shapes(tp) == _shapes(jax.tree_util.tree_map(np.asarray, jp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dequantize_weight_matches_jax(dtype):
    w = jax.random.normal(jax.random.PRNGKey(0), (64, 128)) * 0.02  # test_quantize.py's
    q, scale = jquant.quantize_weight(w)
    want = jquant.dequantize_weight(q, scale, getattr(jnp, dtype))
    got = tquant.dequantize_weight(torch.from_numpy(np.array(q)),
                                   torch.from_numpy(np.array(scale)), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    # and the port's own quantizer round-trips as the JAX test asks
    tq, ts = tquant.quantize_weight(torch.from_numpy(np.array(w)))
    deq = tquant.dequantize_weight(tq, ts, torch.float32).numpy()
    assert np.abs(deq - np.asarray(w)).max() / np.abs(np.asarray(w)).max() < 0.01


def test_default_tokenizer_is_built_once_and_matches_jax():
    tok = ttok.default_tokenizer()
    assert ttok.default_tokenizer() is tok
    assert ttok.default_tokenizer("another/path.model") is tok  # the first one, as in JAX
    text = "读出图中所有文字。<IMG_CONTEXT> calligraphy 1234"
    assert tok.encode(text) == list(jtok.default_tokenizer().encode(text))


@pytest.mark.parametrize("wh", [(448, 448), (500, 300), (120, 700)])
def test_to_tensor_normalized_matches_jax(wh):
    img = _img(*wh, seed=3)
    want = jpre.to_tensor_normalized(Image.fromarray(img), 448)
    got = tpre.to_tensor_normalized(img, 448)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("as_uint8", [True, False])
@pytest.mark.parametrize("seed_wh", list(enumerate([(30, 80), (400, 120), (448, 448), (10, 10)])))
def test_load_char_slice_matches_jax(seed_wh, as_uint8):
    seed, (w, h) = seed_wh  # test_preprocess.py's crops
    img = _img(w, h, seed)
    want = jpre.load_char_slice(Image.fromarray(img), 448, as_uint8=as_uint8)
    got = tpre.load_char_slice(img, 448, as_uint8=as_uint8)
    assert got.dtype == want.dtype and got.shape == want.shape == (1, 448, 448, 3)
    np.testing.assert_array_equal(got, want)


def test_draw_boxes_matches_jax(tmp_path):
    img = np.full((50, 50, 3), 255, np.uint8)  # test_boxes_metrics.py's
    box_list = [[5, 5, 20, 20], [[25, 25], [40, 40]]]
    want = jboxes.draw_boxes(img, box_list, str(tmp_path / "j.png"), numbered=True)
    got = tboxes.draw_boxes(img, box_list, str(tmp_path / "t.png"), numbered=True)
    np.testing.assert_array_equal(got, want)
    assert (got != 255).any() and (img == 255).all()
    assert (tmp_path / "t.png").read_bytes() == (tmp_path / "j.png").read_bytes()
