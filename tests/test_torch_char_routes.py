"""The engine's two char-route options against the JAX engine on the tiny
preset (CPU, fp32, the same parameters carried across with from_jax_params):
``gray_chars`` (luma or full-RGB crops) and ``device_resize_chars`` (raw
crops resized on the device, or every crop resized on the host).

The port's plain host canvases (numpy) are held to the JAX engine's PIL
route within 3/255 (the bound of tests/test_torch_vision.py); the device canvases to the JAX device
resize within the bound of tests/test_torch_models.py (at most 1 apart, on
fewer than 1e-3 of the values). Fed the JAX canvases, the port's char
pipeline gives the JAX pseudo embeddings within 1e-5 of their largest value
and the same VQ indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.runtime.engine import CHAR_BUCKETS
from callireader_tpu.runtime.engine import CalliReaderEngine as JEngine
from callireader_tpu.runtime.engine import init_all_params
from callireader_tpu.runtime.tokenizer import InternLM2Tokenizer as JTok
from callireader_tpu.vision import device_resize as jdr
from callireader_tpu.vision import native as jnative
from callireader_tpu.vision import preprocess as jpre
from callireader_tpu_torch.core.config import callireader_tiny as t_tiny
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.runtime.engine import CalliReaderEngine as TEngine
from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer as TTok
from callireader_tpu_torch.runtime.weights import from_jax_params
from callireader_tpu_torch.vision import device_resize as tdr
from callireader_tpu_torch.vision import native as tnative
from callireader_tpu_torch.vision import preprocess as tpre

OPTIONS = [(True, True), (True, False), (False, True), (False, False)]  # (gray, device resize)
REL = 1e-5


@pytest.fixture(scope="module")
def params():
    return init_all_params(jax.random.PRNGKey(0), callireader_tiny(), dtype=jnp.float32)


@pytest.fixture(scope="module")
def t_params(params):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu")


@pytest.fixture(scope="module")
def built():
    return {}


def _engines(params, t_params, built=None, **opts):
    """A JAX and a port engine with ``opts``; with ``built``, the pair is
    kept for the module (the JAX engine's compiled programs with it)."""
    key = tuple(sorted(opts.items()))
    if built is not None and key in built:
        return built[key]
    jeng = JEngine(callireader_tiny(), params, JTok("callireader_tpu/assets/tokenizer.model"),
                   policy=J_FP32, use_flash=False, **opts)
    teng = TEngine(t_tiny(), t_params, TTok(), device="cpu", policy=T_FP32, **opts)
    if built is not None:
        built[key] = (jeng, teng)
    return jeng, teng


def _crops(seed):
    """Six small glyph crops (the device resize route) and one that the
    [200, 350] rule downscales (the host route either way), of a noisy page."""
    rng = np.random.default_rng(seed)
    page = np.full((120, 90, 3), 236, np.uint8)
    page += rng.integers(0, 16, page.shape, dtype=np.uint8)
    boxes = []
    for c in range(2):
        for r in range(3):
            x0, y0 = 6 + c * 30, 6 + r * 28
            bw, bh = int(rng.integers(14, 24)), int(rng.integers(14, 24))
            page[y0:y0 + bh, x0:x0 + bw] = rng.integers(10, 70, (bh, bw, 3), dtype=np.uint8)
            boxes.append((x0, y0, x0 + bw, y0 + bh))
    page[88:118, 30:85] = rng.integers(10, 70, (30, 55, 3), dtype=np.uint8)
    boxes.append((30, 88, 85, 118))
    return [page[y1:y2, x1:x2] for x1, y1, x2, y2 in boxes]


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("gray", [True, False])
def test_host_canvases_match_the_jax_pil_route(params, t_params, monkeypatch, gray):
    """Both engines' plain host routes: JAX's PIL route (its native library
    switched off) and the port's numpy route (``load_char_content`` in place
    of its native library, which tests/test_torch_native_prep.py holds to
    JAX's byte for byte)."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    jeng, teng = _engines(params, t_params, gray_chars=gray, device_resize_chars=False)
    monkeypatch.setattr(tnative, "char_content_batch", lambda crops, canvas, lo, hi: np.stack(
        [tpre.load_char_content(c, teng.char_content_size, canvas=canvas) for c in crops]))
    crops = _crops(0)
    want = {tuple(i): jeng._to_luma(s) for i, s in jeng._prep_char_crop_groups(crops)}
    got = {tuple(i): s for i, s in teng._prep_char_crop_groups(crops)}
    assert set(got) == set(want)
    for idx, stack in got.items():
        assert stack.shape == want[idx].shape
        assert stack.ndim == (3 if gray else 4)
        assert np.abs(stack.astype(int) - want[idx].astype(int)).max() <= 3


@pytest.mark.parametrize("gray", [True, False])
def test_raw_device_canvases_match_jax(params, t_params, gray):
    jeng, teng = _engines(params, t_params, gray_chars=gray)
    crops = _crops(1)
    (jgroups, jhost), (tgroups, thost) = (e._prep_char_raw_groups(crops) for e in (jeng, teng))
    assert thost == jhost == [6]
    assert len(tgroups) == len(jgroups)
    for (ti, traw, tsrc, ttgt), (ji, jraw, jsrc, jtgt) in zip(tgroups, jgroups):
        assert traw.shape == ((len(ti),) + traw.shape[1:3] + (() if gray else (3,)))
        for a, b in ((ti, ji), (traw, jraw), (tsrc, jsrc), (ttgt, jtgt)):
            assert np.array_equal(a, b)
        want = np.asarray(jdr.bicubic_canvas(jnp.asarray(jraw), jnp.asarray(jsrc),
                                             jnp.asarray(jtgt), jeng.char_canvas))
        got = tdr.bicubic_canvas(*(torch.from_numpy(a) for a in (traw, tsrc, ttgt)),
                                 teng.char_canvas).numpy()
        diff = np.abs(got.astype(int) - want.astype(int))
        assert got.shape == want.shape and got.ndim == (3 if gray else 4)
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("gray,device_resize", OPTIONS)
def test_char_pipeline_fed_the_jax_canvases(params, t_params, built, gray, device_resize):
    """Each bucket group of the JAX engine's route: its canvases (the host
    stacks, or the device resize of the raw crops) through the port's
    _char_pipeline against the JAX char pipeline of that group."""
    jeng, teng = _engines(params, t_params, built, gray_chars=gray,
                          device_resize_chars=device_resize)
    crops = _crops(2)
    cases = []
    host = crops
    if device_resize:
        groups, host_idx = jeng._prep_char_raw_groups(crops)
        host = [crops[i] for i in host_idx]
        for _, raw, src, tgt in groups:
            raw_p, _ = jpre.pad_to_bucket(raw, CHAR_BUCKETS)
            pad = raw_p.shape[0] - raw.shape[0]
            src = np.concatenate([src, np.ones((pad, 2), np.int32)])
            tgt = np.concatenate([tgt, np.ones((pad, 2), np.int32)])
            args = (jnp.asarray(raw_p), jnp.asarray(src), jnp.asarray(tgt))
            canvas = np.asarray(jdr.bicubic_canvas(*args, jeng.char_canvas))
            cases.append((canvas, jeng._char_pipeline_raw(jeng.params, *args)))
    for _, stack in jeng._prep_char_crop_groups(host):
        padded, _ = jpre.pad_to_bucket(jeng._to_luma(stack), CHAR_BUCKETS)
        cases.append((padded, jeng._char_pipeline(jeng.params, jnp.asarray(padded))))
    assert len(cases) >= 2  # a raw group and the downscaled crop's host group, or host groups
    for canvas, (jps, jix) in cases:
        assert canvas.ndim == (3 if gray else 4)
        tps, tix = teng._char_pipeline(torch.from_numpy(np.array(canvas)))
        assert np.array_equal(tix.numpy(), np.asarray(jix))
        assert _rel(tps.numpy(), np.asarray(jps)) <= REL


@pytest.mark.parametrize("gray,device_resize", OPTIONS)
def test_char_parts_route_as_jax(params, t_params, built, monkeypatch, gray, device_resize):
    """What each option sends down which route: without device_resize_chars
    no raw group is built and every crop takes the host route; the host
    stacks and raw groups are luma or RGB by gray_chars. The pseudo rows and
    VQ indices of the whole window agree with the JAX engine's."""
    jeng, teng = _engines(params, t_params, built, gray_chars=gray,
                          device_resize_chars=device_resize)
    crops = _crops(2)
    seen = {"raw": [], "host": []}
    raw_fn, host_fn = teng._char_pipeline_raw, teng._char_pipeline
    monkeypatch.setattr(teng, "_char_pipeline_raw",
                        lambda raw, *a: seen["raw"].append(tuple(raw.shape)) or raw_fn(raw, *a))
    monkeypatch.setattr(teng, "_char_pipeline",
                        lambda c, *a: seen["host"].append(tuple(c.shape)) or host_fn(c, *a))
    tps, tix = teng._reorder(*teng._char_parts(teng._char_prep(crops)))
    jps, jix = jeng._encode_chars_fused(crops)
    if device_resize:
        assert len(seen["raw"]) >= 1 and len(seen["host"]) == 1
    else:
        assert seen["raw"] == [] and len(seen["host"]) >= 1
    for shape in seen["raw"] + seen["host"]:
        assert len(shape) == (3 if gray else 4)
    assert np.array_equal(tix.numpy(), np.asarray(jix))
    assert np.abs(tps.numpy() - np.asarray(jps)).max() <= 1e-4


def test_options_default_and_reach_the_entry_points(params, t_params, monkeypatch):
    """The JAX defaults (luma, device resize), and the RGB host route taken
    by calli_align, batch_calli_align, batch_build_rows and chat_ocr."""
    kw = TEngine.__init__.__kwdefaults__
    assert kw["gray_chars"] is True and kw["device_resize_chars"] is True
    _, teng = _engines(params, t_params, gray_chars=False, device_resize_chars=False)
    crop = _crops(4)[0]
    h, w = crop.shape[:2]
    page = np.full((120, 90, 3), 236, np.uint8)
    page[6:6 + h, 6:6 + w] = crop
    boxes = [[6.0, 6.0, 6.0 + w, 6.0 + h]]
    monkeypatch.setattr(teng, "sort_boxes", lambda image: boxes)
    seen = []
    host_fn = teng._char_pipeline
    monkeypatch.setattr(teng, "_char_pipeline",
                        lambda c, *a: seen.append(tuple(c.shape)) or host_fn(c, *a))
    monkeypatch.setattr(teng, "_char_pipeline_raw", lambda *a: 1 / 0)
    teng.calli_align(page)
    teng.batch_calli_align([page], ordered_lists=[boxes])
    teng.batch_build_rows([page], ["读出图中所有文字。"], ordered_lists=[boxes])
    teng.chat_ocr(page, "读出图中所有文字。", max_new_tokens=2)
    assert len(seen) == 4 and all(len(s) == 4 and s[-1] == 3 for s in seen)


def test_build_engine_and_serve_carry_the_char_flags(monkeypatch):
    """cli.common.build_engine passes both options to the engine; serve's
    --rgb-chars / --gray-chars reach it as the JAX CLI's do, and conflict."""
    from callireader_tpu_torch.cli import common as tcommon
    from callireader_tpu_torch.cli import serve as tserve

    eng = tcommon.build_engine(preset="callireader-tiny", random_init_ok=True, device="cpu",
                               gray_chars=False, device_resize_chars=False)
    assert eng.gray_chars is False and eng.device_resize_chars is False
    eng = tcommon.build_engine(preset="callireader-tiny", random_init_ok=True, device="cpu")
    assert eng.gray_chars is True and eng.device_resize_chars is True

    seen = []

    class Built(Exception):
        pass

    def record(**kw):
        seen.append(kw)
        raise Built

    monkeypatch.setattr(tcommon, "build_engine", record)
    base = ["--input", "in.jsonl", "--output", "out.jsonl", "--random-init", "--device", "cpu"]
    for flags, gray in (([], True), (["--gray-chars"], True), (["--rgb-chars"], False)):
        with pytest.raises(Built):
            tserve.main(base + flags)
        assert seen[-1]["gray_chars"] is gray
    with pytest.raises(SystemExit):
        tserve.main(base + ["--rgb-chars", "--gray-chars"])


def test_luma_is_the_jax_packages_uint16_sum(params, t_params):
    """The port's luma is the JAX package's, (299 R + 587 G + 114 B) // 1000
    summed in uint16, which wraps past 65535: white maps to 58 where PIL's
    convert("L") gives 255 (ROADMAP queue C, a known reference caveat). The
    committed CalliAlign tower was trained through the same sum
    (callireader_tpu/train/callialign_train.py::_to_luma), so the luma
    routes keep it."""
    from callireader_tpu.train import callialign_train
    from callireader_tpu_torch.runtime.engine import _luma

    levels = np.arange(256, dtype=np.uint8)
    rgb = np.stack(np.meshgrid(levels, levels[::15], levels[::51], indexing="ij"),
                   -1).reshape(-1, 1, 1, 3)
    jeng, teng = _engines(params, t_params)
    got = _luma(rgb)
    assert np.array_equal(got, jeng._to_luma(rgb))
    assert np.array_equal(got, callialign_train._to_luma(rgb))
    assert np.array_equal(teng._luma_if_gray(rgb), got)
    white = np.full((1, 1, 3), 255, np.uint8)
    assert _luma(white)[0, 0] == 58
    assert np.asarray(Image.fromarray(white).convert("L"))[0, 0] == 255
    # below the wrap (every channel under 66: the sum stays under 65536) it is
    # PIL's luma, within the rounding
    dark = rgb[(rgb < 66).all(-1)[:, 0, 0]]
    pil = np.asarray(Image.fromarray(dark[:, 0, 0][None]).convert("L"))[0]
    assert np.abs(_luma(dark)[:, 0, 0].astype(int) - pil.astype(int)).max() <= 1
