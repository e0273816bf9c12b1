"""The engine surface a pipelined caller drives, against the JAX engine on the
tiny preset (CPU, fp32, the same parameters carried across with
from_jax_params): the phased box stage (detect_dispatch / detect_fetch /
columns_stage / order_dispatch / order_fetch), ``device_tile_pages``,
``char_canvas`` and ``char_window``.

Box lists are compared box for box (the random-weight detector runs at a low
confidence so that it finds boxes); against JAX, both engines' phases start
from the same detections, since the two detectors' fp32 boxes differ in the
last bits (held to 1e-3 here) and a box edge near an integer truncates to
either side. Pseudo embeddings agree to 1e-4 (fp32
through the char tower and the resampler; XLA and torch sum in other
orders); VQ indices are equal. Host tiles are compared bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.models.detector import Detector as JDetector
from callireader_tpu.runtime.engine import CalliReaderEngine as JEngine
from callireader_tpu.runtime.engine import init_all_params
from callireader_tpu.runtime.tokenizer import InternLM2Tokenizer as JTok
from callireader_tpu.vision import preprocess as jpre
from callireader_tpu_torch.core.config import callireader_tiny as t_tiny
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.models.detector import Detector as TDetector
from callireader_tpu_torch.runtime.engine import CalliReaderEngine as TEngine
from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer as TTok
from callireader_tpu_torch.runtime.weights import from_jax_params

QUESTION = "读出图中所有文字。"
ATOL = 1e-4


@pytest.fixture(scope="module")
def params():
    return init_all_params(jax.random.PRNGKey(0), callireader_tiny(), dtype=jnp.float32)


def _engines(params, jcfg=None, tcfg=None, **opts):
    jcfg = jcfg or callireader_tiny()
    tcfg = tcfg or t_tiny()
    jeng = JEngine(jcfg, params, JTok("callireader_tpu/assets/tokenizer.model"), policy=J_FP32,
                   use_flash=False, **opts)
    teng = TEngine(tcfg, from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu"),
                   TTok(), device="cpu", policy=T_FP32, **opts)
    return jeng, teng


@pytest.fixture(scope="module")
def engines(params):
    """Both engines with the detector at a low confidence, so that the
    random-weight detector finds boxes."""
    jeng, teng = _engines(params)
    jeng.detector = JDetector(jeng.params["detector"], dataclasses.replace(
        jeng.cfg.detector, conf_threshold=1e-4, max_detections=40))
    teng.detector = TDetector(teng.params["detector"], dataclasses.replace(
        teng.cfg.detector, conf_threshold=1e-4, max_detections=40), "cpu")
    return jeng, teng


def _pages(seed, n=2):
    rng = np.random.RandomState(seed)
    return [rng.randint(60, 255, (96, 72, 3), np.uint8) for _ in range(n)]


def _phased(eng, imgs):
    dets = eng.detect_fetch(imgs, eng.detect_dispatch(imgs))
    return eng.order_fetch(eng.order_dispatch(eng.columns_stage(imgs, dets)))


@pytest.mark.parametrize("seed", [0, 1])
def test_phased_box_stages_match_batch_sort_boxes_and_jax(engines, seed):
    jeng, teng = engines
    imgs = _pages(seed)
    phased = _phased(teng, imgs)
    assert phased == teng.batch_sort_boxes(imgs)
    assert any(len(p) > 0 for p in phased)
    jdets = jeng.detect_fetch(imgs, jeng.detect_dispatch(imgs))
    tdets = teng.detect_fetch(imgs, teng.detect_dispatch(imgs))
    for j, t in zip(jdets, tdets):
        np.testing.assert_allclose(np.asarray(t).reshape(-1, 4), np.asarray(j).reshape(-1, 4),
                                   atol=1e-3)
    assert teng.order_fetch(teng.order_dispatch(teng.columns_stage(imgs, jdets))) \
        == jeng.order_fetch(jeng.order_dispatch(jeng.columns_stage(imgs, jdets)))
    # the dispatch phases hand back a handle, not boxes
    assert teng.detect_dispatch(imgs)[0] == "handle"
    assert teng.order_dispatch(teng.columns_stage(imgs, teng.batch_sort_boxes(imgs)))["handle"] \
        is not None


def test_phased_stages_interleaved_with_stale_handles(engines):
    """bench.py's order: a batch's detector handle stays out while other
    batches' fetch, columns and order phases run."""
    _, teng = engines
    chunks = [_pages(s) for s in (1, 2, 3)]
    want = [teng.batch_sort_boxes(c) for c in chunks]
    handles = {i: teng.detect_dispatch(c) for i, c in enumerate(chunks)}
    orders = {}
    for i in (2, 0, 1):
        dets = teng.detect_fetch(chunks[i], handles.pop(i))
        orders[i] = teng.order_dispatch(teng.columns_stage(chunks[i], dets))
    got = {i: teng.order_fetch(orders[i]) for i in (1, 2, 0)}
    assert [got[i] for i in range(3)] == want


class Saturating:
    """The real detector, but the batch path's first page holds 251 boxes:
    a detector without ``dispatch``, evaluated eagerly by detect_dispatch."""

    def __init__(self, real):
        self.real = real

    def __call__(self, img):
        return self.real(img)

    def batch(self, images):
        outs = self.real.batch(images)
        rng = np.random.RandomState(0)
        outs[0] = [[float(x), float(y), float(x + 6), float(y + 6)]
                   for x, y in rng.randint(0, 60, (251, 2))]
        return outs


def test_saturated_page_takes_the_serial_path_in_order_fetch(engines, monkeypatch):
    jeng, teng = engines
    imgs = _pages(5)
    out = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        monkeypatch.setattr(eng, "detector", Saturating(eng.detector))
        handle = eng.detect_dispatch(imgs)
        assert handle[0] == "dets"
        inter = eng.columns_stage(imgs, eng.detect_fetch(imgs, handle))
        assert [i for i, _ in inter["saturated"]] == [0] and inter["results"][0] is None
        out[name] = eng.order_fetch(eng.order_dispatch(inter))
        assert out[name] == eng.batch_sort_boxes(imgs)
    assert out["port"] == out["jax"]
    assert out["port"][0] is not None


@pytest.mark.parametrize("stub", ["callable", "batch"])
def test_stub_detector_without_dispatch(engines, monkeypatch, stub):
    jeng, teng = engines
    imgs = _pages(4)

    def boxes(img):
        return [[4.0, 4.0, 20.0, 20.0], [30.0, 6.0, 44.0, 22.0], [5.0, 40.0, 19.0, 60.0]]

    out = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        det = boxes if stub == "callable" else type(
            "BatchStub", (), {"batch": staticmethod(lambda ims: [boxes(i) for i in ims]),
                              "__call__": staticmethod(boxes)})()
        monkeypatch.setattr(eng, "detector", det)
        handle = eng.detect_dispatch(imgs)
        assert handle[0] == "dets"
        out[name] = eng.order_fetch(eng.order_dispatch(
            eng.columns_stage(imgs, eng.detect_fetch(imgs, handle))))
        assert out[name] == eng.batch_sort_boxes(imgs)
    assert out["port"] == out["jax"] and all(out["port"])


def _char_page(seed, w=90, h=120, big=False):
    """A page with six small glyph boxes (device resize route) and, with
    ``big``, one that the [200, 350] rule downscales (host route)."""
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
    if big:
        page[88:118, 30:85] = rng.integers(10, 70, (30, 55, 3), dtype=np.uint8)
        boxes.append([30.0, 88.0, 85.0, 118.0])
    return page, boxes


def _calli_align(eng, page, boxes, monkeypatch):
    monkeypatch.setattr(eng, "sort_boxes", lambda image: boxes)
    ps, ix = eng.calli_align(page)
    return np.asarray(ps), np.asarray(ix)


def test_device_tile_pages_routes(params):
    """False: host load_image tiles, bit-equal to the JAX host tiles; True:
    the device route (batch_tile_pages)."""
    page0, b0 = _char_page(0)
    page1, b1 = _char_page(1, w=100, h=90)
    pages, ordered = [page0, page1], [b0, b1]
    for device_tiles in (False, True):
        _, teng = _engines(params, device_tile_pages=device_tiles)
        assert teng.device_tile_pages is device_tiles
        seen = []
        encode = teng.encode_image_tiles
        teng.encode_image_tiles = lambda tiles: seen.append(tiles.clone()) or encode(tiles)
        teng.batch_build_rows(pages, [QUESTION] * 2, ordered_lists=ordered)
        (tiles,) = seen
        if device_tiles:
            want = teng.batch_tile_pages(pages)[0]
        else:
            cfg = teng.cfg
            want = torch.from_numpy(np.concatenate([jpre.load_image(
                p, cfg.force_image_size, cfg.max_dynamic_patch, cfg.use_thumbnail, as_uint8=True)
                for p in pages]))
        assert tiles.dtype == torch.uint8 and torch.equal(tiles, want)
    assert TEngine.__init__.__kwdefaults__["device_tile_pages"] is False  # JAX's default


@pytest.mark.parametrize("size,canvas", [(56, 84), (224, 196)])
def test_char_canvas_pseudo_matches_jax(params, monkeypatch, size, canvas):
    """The shared tower's canvas lever: a legal canvas other than the tile
    size (larger on the tiny preset, where no smaller one holds the content
    scale; smaller at a 224 tile size), device and host char routes."""
    jcfg = dataclasses.replace(callireader_tiny(), force_image_size=size)
    tcfg = dataclasses.replace(t_tiny(), force_image_size=size)
    jeng, teng = _engines(params, jcfg, tcfg, char_canvas=canvas)
    assert teng.char_canvas == jeng.char_canvas == canvas
    assert teng.char_content_size == jeng.char_content_size == size
    page, boxes = _char_page(2, big=size == 56)
    jps, jix = _calli_align(jeng, page, boxes, monkeypatch)
    tps, tix = _calli_align(teng, page, boxes, monkeypatch)
    assert (tix == jix).all()
    np.testing.assert_allclose(tps, jps, atol=ATOL)
    # the canvas reaches the tower: other pseudo rows than the default canvas
    _, tdef = _engines(params, jcfg, tcfg)
    dps, _ = _calli_align(tdef, page, boxes, monkeypatch)
    assert not np.allclose(dps, tps, atol=ATOL)


@pytest.mark.parametrize("canvas", [70, 28, 30])
def test_illegal_char_canvas_raises_as_in_jax(params, canvas):
    """70: an odd patch grid; 28: below the content scale (44 at 56); 30:
    not a multiple of the patch."""
    with pytest.raises(ValueError) as jerr:
        _engines(params, char_canvas=canvas)
    with pytest.raises(ValueError) as terr:
        TEngine(t_tiny(), {}, None, device="cpu", char_canvas=canvas)
    assert str(terr.value) == str(jerr.value)


def test_char_canvas_conflicts_with_the_compact_tower():
    from callireader_tpu_torch.core.config import VisionConfig

    cfg = dataclasses.replace(t_tiny(), char_vision=VisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=1, num_attention_heads=4,
        image_size=28, patch_size=14))
    assert TEngine(cfg, {}, None, device="cpu").char_canvas == 28
    assert TEngine(cfg, {}, None, device="cpu", char_canvas=28).char_canvas == 28
    with pytest.raises(ValueError, match="conflicts with the dedicated char tower"):
        TEngine(cfg, {}, None, device="cpu", char_canvas=56)


def test_char_window_gives_the_default_pseudo_tokens(params):
    """A window of 4 crops splits the batch's 13 crops into 4 dispatches; the
    pseudo rows equal the default window's and the JAX engine's."""
    page0, b0 = _char_page(3)
    page1, b1 = _char_page(4, big=True)
    pages, ordered = [page0, page1], [b0, b1]
    jeng, teng = _engines(params, char_window=4)
    assert teng.char_window == jeng.char_window == 4
    _, tdef = _engines(params)
    assert tdef.char_window == 256
    calls = []
    prep = teng._char_prep
    teng._char_prep = lambda crops: calls.append(len(crops)) or prep(crops)
    got = teng.batch_calli_align(pages, ordered_lists=ordered)
    assert calls == [4, 4, 4, 1]
    want = tdef.batch_calli_align(pages, ordered_lists=ordered)
    jwant = jeng.batch_calli_align(pages, ordered_lists=ordered)
    for (ps, ix), (dps, dix), (jps, jix) in zip(got, want, jwant):
        assert torch.equal(ix, dix) and (ix.numpy() == np.asarray(jix)).all()
        np.testing.assert_allclose(ps.numpy(), dps.numpy(), atol=1e-5)
        np.testing.assert_allclose(ps.numpy(), np.asarray(jps), atol=ATOL)


def test_cli_builder_and_serve_flags_reach_the_engine(monkeypatch):
    """cli/common's builder takes char_canvas and device_tile_pages (default
    on, as in the JAX builder); serve's --host-tile-pages / --char-canvas /
    --quant int8-all reach it."""
    from callireader_tpu_torch.cli import common as tcommon
    from callireader_tpu_torch.cli import serve as tserve

    eng = tcommon.build_engine(preset="callireader-tiny", random_init_ok=True, char_canvas=84,
                               device="cpu")
    assert eng.char_canvas == 84 and eng.char_content_size == 56 and eng.device_tile_pages
    with pytest.raises(ValueError, match="must be a multiple"):
        tcommon.build_engine(preset="callireader-tiny", random_init_ok=True, char_canvas=70,
                             device="cpu")

    seen = []

    class Built(Exception):
        pass

    def record(**kw):
        seen.append(kw)
        raise Built

    monkeypatch.setattr(tcommon, "build_engine", record)
    for flags, want in (([], (True, None, None)),
                        (["--host-tile-pages", "--char-canvas", "364", "--quant", "int8-all"],
                         (False, 364, "int8-all"))):
        with pytest.raises(Built):
            tserve.main(["--input", "in.jsonl", "--output", "out.jsonl", "--random-init",
                         "--device", "cpu", *flags])
        kw = seen[-1]
        assert (kw["device_tile_pages"], kw["char_canvas"], kw["quant"]) == want
