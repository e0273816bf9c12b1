"""End to end: the port's batch_chat_ocr against the JAX engine on the tiny
preset (CPU, fp32), from the same parameters.

Two small numpy pages with fixed reading-order boxes (so the char path runs
without a trained detector). Generated token ids must be identical; the
spliced prompt embeddings agree to 1e-4 (fp32 through the ViT, the char
tower and the resampler; rounding order differs between XLA and torch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

QUESTIONS = ["读出图中所有文字。", "这幅书法作品内容是什么？"]


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


@pytest.fixture(scope="module")
def engines():
    cfg = callireader_tiny()
    params = init_all_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    jeng = JEngine(cfg, params, JTok("callireader_tpu/assets/tokenizer.model"),
                   policy=J_FP32, use_flash=False, device_tile_pages=True)
    np_params = jax.tree_util.tree_map(np.asarray, params)
    teng = TEngine(t_tiny(), from_jax_params(np_params, device="cpu"), TTok(),
                   device="cpu", policy=T_FP32, device_tile_pages=True)
    return jeng, teng


def test_batch_chat_ocr_tokens_match_jax(engines):
    jeng, teng = engines
    (p0, b0), (p1, b1) = _page(0, 70, 96), _page(1, 100, 90)
    pages, ordered = [p0, p1], [b0, b1]
    jrows = jeng.batch_build_rows(pages, QUESTIONS, ordered_lists=ordered)
    jprep = jeng.batch_prepare([], [], prepared_rows=jrows, max_new_tokens=6,
                               repetition_penalty=1.5)
    jtext = jeng.batch_decode(jprep)
    tprep = teng.batch_prepare(pages, QUESTIONS, ordered_lists=ordered, max_new_tokens=6,
                               repetition_penalty=1.5)
    ttext = teng.batch_decode(tprep)

    np.testing.assert_allclose(tprep["embeds"].numpy(), np.asarray(jrows["embeds"]), atol=1e-4)
    jt, jl = np.asarray(jprep["tokens"]), np.asarray(jprep["lengths"])
    tt, tl = tprep["tokens"].numpy(), tprep["lengths"].numpy()
    assert (tl == jl).all()
    assert (tt == jt).all()
    assert ttext == jtext


def test_batch_chat_ocr_runs_char_path(engines):
    _, teng = engines
    page, boxes = _page(2, 70, 96)
    out = teng.batch_calli_align([page], ordered_lists=[boxes])
    pseudo, idx = out[0]
    assert idx.shape == (len(boxes), 3)
    assert pseudo.shape == (3 * len(boxes), teng.cfg.llm.hidden_size)
    assert torch.isfinite(pseudo).all()
    resp = teng.batch_chat_ocr([page], QUESTIONS[:1], ordered_lists=[boxes], max_new_tokens=3)
    assert len(resp) == 1 and isinstance(resp[0], str)


def test_calli_align_and_build_row_embeds_match_jax(engines, monkeypatch):
    """The per-request pieces the servers call: single-page ``calli_align``
    (reading-order boxes given in place of the untrained detector's) and the
    left-padded prompt row of ``_build_row_embeds``, against the JAX engine."""
    jeng, teng = engines
    page, boxes = _page(3, 70, 96)
    monkeypatch.setattr(jeng, "sort_boxes", lambda image: boxes)
    monkeypatch.setattr(teng, "sort_boxes", lambda image: boxes)
    jps, jix = jeng.calli_align(page)
    tps, tix = teng.calli_align(page)
    assert (tix.numpy() == np.asarray(jix)).all()
    np.testing.assert_allclose(tps.numpy(), np.asarray(jps), atol=1e-4)
    monkeypatch.setattr(teng, "sort_boxes", lambda image: [])
    assert teng.calli_align(page) == (None, None)

    from callireader_tpu.vision import preprocess as jpre
    from callireader_tpu_torch.vision import preprocess as tpre

    cfg = teng.cfg
    tiles = tpre.load_image(page, cfg.force_image_size, cfg.max_dynamic_patch, cfg.use_thumbnail)
    assert (tiles == jpre.load_image(page, cfg.force_image_size, cfg.max_dynamic_patch,
                                     cfg.use_thumbnail, as_uint8=True)).all()
    jfeats = jeng.encode_image_tiles(tiles)
    tfeats = teng.encode_image_tiles(torch.from_numpy(tiles))
    query = teng._expand_image_tokens(
        "<image>\n" + QUESTIONS[0] + "[UNUSED_TOKEN_140]" * tps.shape[0], [tiles.shape[0]])
    ids = teng._tokenize_prompt(query)
    assert (ids == jeng._tokenize_prompt(query)).all()
    jemb, jmask = jeng._build_row_embeds(ids, jfeats, jps, 512)
    temb, tmask = teng._build_row_embeds(ids, tfeats, tps, 512)
    assert (tmask == jmask).all() and temb.shape == (1, 512, cfg.llm.hidden_size)
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), atol=1e-4)
