"""Port models against the JAX package on the CPU, from the same parameters
(``from_jax_params``), in fp32 (FP32 policy, JAX reference attention).

Tolerance: 1e-4 max abs for fp32 module outputs (same math; XLA and torch
sum in different orders), relative to outputs of O(1)-O(10). Integer
outputs (VQ indices, uint8 canvases) must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from callireader_tpu.align import vq as jvq
from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.models import internlm2 as jllm
from callireader_tpu.models import internvit as jvit
from callireader_tpu.models import projector as jproj
from callireader_tpu.models import resampler as jres
from callireader_tpu.vision import device_resize as jdr
from callireader_tpu_torch.align import vq as tvq
from callireader_tpu_torch.core import config as tconfig
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.models import internlm2 as tllm
from callireader_tpu_torch.models import internvit as tvit
from callireader_tpu_torch.models import projector as tproj
from callireader_tpu_torch.models import resampler as tres
from callireader_tpu_torch.runtime.weights import from_jax_params
from callireader_tpu_torch.vision import device_resize as tdr

ATOL = 1e-4
JCFG = callireader_tiny()
TCFG = tconfig.callireader_tiny()
CHAR_V3 = dict(hidden_size=256, intermediate_size=1024, num_hidden_layers=2,
               num_attention_heads=8, image_size=224, patch_size=14)


def _t(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=atol, rtol=0)


@pytest.mark.parametrize("tower,hw", [("tile", (56, 56)), ("tile_interp", (70, 84)),
                                      ("char_v3", (224, 224))])
def test_internvit_forward(tower, hw):
    if tower == "char_v3":
        jc = dataclasses.replace(JCFG.vision, **CHAR_V3)
        tc = dataclasses.replace(TCFG.vision, **CHAR_V3)
    else:
        jc, tc = JCFG.vision, TCFG.vision
    params = jvit.init_params(jax.random.PRNGKey(1), jc, jnp.float32)
    px = np.random.default_rng(0).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = jvit.forward(params, jc, jnp.asarray(px), policy=J_FP32, use_flash=False)
    got = tvit.forward(_t(params), tc, torch.from_numpy(px), policy=T_FP32)
    _close(got, want)


@pytest.mark.parametrize("char", [False, True])
def test_projector_extract_feature(char):
    kw = dict(vit_hidden=256, out_dim=512) if char else {}
    params = jproj.init_params(jax.random.PRNGKey(2), JCFG, jnp.float32, **kw)
    E = kw.get("vit_hidden", JCFG.vision.hidden_size)
    hidden = np.random.default_rng(1).standard_normal((3, 1 + 64, E), dtype=np.float32)
    want = jproj.extract_feature(params, jnp.asarray(hidden), JCFG, policy=J_FP32)
    got = tproj.extract_feature(_t(params), torch.from_numpy(hidden), TCFG, policy=T_FP32)
    _close(got, want)


@pytest.mark.parametrize("out_dim", [None, 96])
def test_resampler_and_calli_align(out_dim):
    jrc = dataclasses.replace(JCFG.resampler, out_dim=out_dim)
    trc = dataclasses.replace(TCFG.resampler, out_dim=out_dim)
    params = jres.init_params(jax.random.PRNGKey(3), jrc, jnp.float32)
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((4, 16, jrc.dim), dtype=np.float32)
    want = jres.forward(params, jrc, jnp.asarray(feats), policy=J_FP32)
    got = tres.forward(_t(params), trc, torch.from_numpy(feats), policy=T_FP32)
    _close(got, want)

    E = got.shape[-1]
    table = rng.standard_normal((50, E), dtype=np.float32)
    mu = rng.standard_normal((50,), dtype=np.float32)
    sigma = rng.random((50,), dtype=np.float32) + 0.5
    for hard in (False, True):
        jp, ji = jvq.calli_align_embed(want, jnp.asarray(table), jnp.asarray(mu),
                                       jnp.asarray(sigma), hard_vq=hard, hard_vq_threshold=0.2)
        tp, ti = tvq.calli_align_embed(got, torch.from_numpy(table), torch.from_numpy(mu),
                                       torch.from_numpy(sigma), hard_vq=hard,
                                       hard_vq_threshold=0.2)
        assert (ti.numpy() == np.asarray(ji)).all()
        _close(tp, jp)


def test_splice_embeds():
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 4, (2, 12)).astype(np.int32)
    emb = rng.standard_normal((2, 12, 8), dtype=np.float32)
    rep = rng.standard_normal((30, 8), dtype=np.float32)
    want = jvq.splice_embeds(jnp.asarray(emb), jnp.asarray(ids), jnp.asarray(rep), 3)
    got = tvq.splice_embeds(torch.from_numpy(emb), torch.from_numpy(ids), torch.from_numpy(rep), 3)
    _close(got, want, atol=0)


def test_bicubic_canvas_matches_jax():
    rng = np.random.default_rng(4)
    N, R, out = 6, 96, 224
    raw = rng.integers(0, 256, (N, R, R), dtype=np.uint8)
    src = np.array([[40, 33], [96, 60], [17, 80], [55, 55], [1, 9], [90, 96]], np.int32)
    tgt = np.array([[100, 82], [175, 109], [21, 100], [100, 100], [11, 100], [164, 175]], np.int32)
    want = np.asarray(jdr.bicubic_canvas(jnp.asarray(raw), jnp.asarray(src), jnp.asarray(tgt), out))
    got = tdr.bicubic_canvas(torch.from_numpy(raw), torch.from_numpy(src), torch.from_numpy(tgt),
                             out).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    # fp32 matmul order may move a value across a .5 rounding boundary
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.fixture(scope="module")
def llm():
    jc = JCFG.llm
    params = jllm.init_params(jax.random.PRNGKey(4), jc, jnp.float32)
    return jc, params, _t(params)


def test_internlm2_prefill_and_decode(llm):
    jc, jp, tp = llm
    tc = TCFG.llm
    B, S, max_len = 2, 24, 32
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((B, S, jc.hidden_size), dtype=np.float32)
    mask = np.ones((B, S), np.int32)
    mask[1, :9] = 0  # left padding
    jl, jcache = jllm.prefill(jp, jc, inputs_embeds=jnp.asarray(emb),
                              attention_mask=jnp.asarray(mask), max_len=max_len,
                              cache_dtype=jnp.float32, policy=J_FP32, use_flash=False)
    tl, tcache = tllm.prefill(tp, tc, inputs_embeds=torch.from_numpy(emb),
                              attention_mask=torch.from_numpy(mask), max_len=max_len,
                              cache_dtype=torch.float32, policy=T_FP32)
    _close(tl, jl)
    _close(tcache.k, jcache.k)
    _close(tcache.v, jcache.v)
    assert tcache.length == int(jcache.length)

    valid = np.zeros((B, max_len), np.int32)
    valid[:, :S] = mask
    for step in range(3):
        ids = rng.integers(0, jc.vocab_size, (B, 1)).astype(np.int32)
        valid[:, S + step] = 1
        jl, jcache = jllm.decode_step(jp, jc, input_ids=jnp.asarray(ids), cache=jcache,
                                      kv_valid_mask=jnp.asarray(valid), policy=J_FP32,
                                      use_flash=False)
        tl, tcache = tllm.decode_step(tp, tc, input_ids=torch.from_numpy(ids), cache=tcache,
                                      kv_valid_mask=torch.from_numpy(valid), policy=T_FP32)
        _close(tl, jl)
    _close(tcache.k, jcache.k)
    assert tcache.length == int(jcache.length)


def test_rope_dynamic_ntk_matches_jax():
    jc = dataclasses.replace(JCFG.llm, max_position_embeddings=64)
    tc = dataclasses.replace(TCFG.llm, max_position_embeddings=64)
    for top in (40, 100):  # below and above the training window
        pos = np.arange(top, dtype=np.int32)[None]
        jcos, jsin = jllm.cos_sin_for(jc, jnp.asarray(pos), 128)
        tcos, tsin = tllm.cos_sin_for(tc, torch.from_numpy(pos), 128)
        _close(tcos, jcos, atol=1e-5)
        _close(tsin, jsin, atol=1e-5)
