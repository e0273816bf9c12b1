"""Port vision and slicing-prior stages against the JAX package on the CPU.

- On-device page tiling (jax.image.resize "cubic") against
  CalliReaderEngine._page_tiles_impl: uint8 tiles equal except where a value
  sits on a .5 rounding boundary. XLA's fp32 resize is itself up to ~1e-3
  off the exact (float64) result, so about 3e-5 of the pixels round the
  other way; the tolerance is 1 level on at most 1e-4 of the pixels, and the
  port's float result must sit within 2e-4 of the float64 resize.
- Letterbox (PIL BILINEAR) and downscaled char crops (PIL BICUBIC) against
  PIL itself: within 3/255, the bound tests/test_native_prep.py allows a
  non-PIL resampler.
- Detector on the synthetic bench page with the committed detector_640.npz:
  the same boxes (integer-truncated exactly; float coordinates within
  1e-2 px of fp32 rounding), and OrderFormer with orderformer.npz: the same
  reading order.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from callireader_tpu.core.config import callireader_2b, callireader_tiny
from callireader_tpu.models import detector as jdet
from callireader_tpu.models import orderformer as jof
from callireader_tpu.runtime.engine import CalliReaderEngine as JEngine
from callireader_tpu.vision import boxes as jboxes
from callireader_tpu.vision import preprocess as jpre
from callireader_tpu_torch.core import config as tconfig
from callireader_tpu_torch.models import detector as tdet
from callireader_tpu_torch.models import orderformer as tof
from callireader_tpu_torch.runtime.engine import CalliReaderEngine as TEngine
from callireader_tpu_torch.runtime.weights import ASSETS_DIR
from callireader_tpu_torch.vision import boxes as tboxes
from callireader_tpu_torch.vision import preprocess as tpre
from callireader_tpu_torch.vision import resample


def make_page(seed=0, W=788, H=2000, n_cols=6, per_col=16):
    """The bench's synthetic calligraphy page generator (copied)."""
    rng = np.random.RandomState(seed)
    page = np.full((H, W, 3), 235, np.uint8)
    page += rng.randint(0, 18, page.shape).astype(np.uint8)
    boxes = []
    col_w = W // (n_cols + 1)
    for c in range(n_cols):
        x0 = W - (c + 1) * col_w - 20
        for r in range(per_col):
            y0 = 40 + r * (H - 80) // per_col
            w, h = rng.randint(55, 75), rng.randint(55, 75)
            glyph = np.full((h, w, 3), 245, np.uint8)
            for _ in range(6):
                sx, sy = rng.randint(0, w - 8), rng.randint(0, h - 8)
                glyph[sy:sy + rng.randint(4, h - sy), sx:sx + rng.randint(3, 8)] = rng.randint(10, 60)
                glyph[sy:sy + rng.randint(3, 8), sx:sx + rng.randint(4, w - sx)] = rng.randint(10, 60)
            page[y0:y0 + h, x0:x0 + w] = glyph
            boxes.append([float(x0), float(y0), float(x0 + w), float(y0 + h)])
    return page, boxes


@pytest.fixture(scope="module")
def page():
    return make_page(0)


@pytest.mark.parametrize("preset,hw", [("tiny", (131, 97)), ("2b", (230, 500))])
def test_page_tiles_match_jax(preset, hw):
    jcfg = callireader_tiny() if preset == "tiny" else callireader_2b()
    tcfg = tconfig.get_config(f"callireader-{preset}")
    H, W = hw
    pages = np.random.default_rng(6).integers(0, 256, (2, H, W, 3), dtype=np.uint8)
    c, r = tpre.tile_grid(W, H, max_num=tcfg.max_dynamic_patch, image_size=tcfg.force_image_size)
    assert (c, r) == jpre.tile_grid(W, H, max_num=jcfg.max_dynamic_patch,
                                    image_size=jcfg.force_image_size)
    thumb = c * r != 1
    want = np.asarray(JEngine._page_tiles_impl(types.SimpleNamespace(cfg=jcfg),
                                               jnp.asarray(pages), cols=c, rows=r, thumb=thumb))
    got = TEngine._page_tiles(types.SimpleNamespace(cfg=tcfg), torch.from_numpy(pages),
                              c, r, thumb).numpy()
    assert got.shape == want.shape
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    x = pages.astype(np.float64)
    S = tcfg.force_image_size
    wy = resample.jax_resize_weights_np(H, r * S).astype(np.float64)
    wx = resample.jax_resize_weights_np(W, c * S).astype(np.float64)
    exact = np.einsum("xw,bywc->byxc", wx, np.einsum("yh,bhwc->bywc", wy, x))
    port = resample.jax_resize_hw(torch.from_numpy(pages).float(), r * S, c * S).numpy()
    assert np.abs(port - exact).max() <= 2e-4


@pytest.mark.parametrize("method,pil", [("bilinear", Image.BILINEAR), ("bicubic", Image.BICUBIC)])
@pytest.mark.parametrize("src,dst", [((2000, 788), (252, 640)), ((97, 61), (200, 126)),
                                     ((400, 260), (175, 114)), ((50, 50), (50, 31))])
def test_pil_resize_matches_pil(method, pil, src, dst):
    h, w = src
    img = np.random.default_rng(h + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), pil))
    got = resample.pil_resize(img, (dst[1], dst[0]), method)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 3


def test_letterbox_matches_jax(page):
    img, _ = page
    want, ws, wp = jdet.letterbox(img, 640)
    got, gs, gp = tdet.letterbox(img, 640)
    assert (gs, gp) == (ws, wp)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 3


def test_downscaled_char_crops_match_pil():
    rng = np.random.default_rng(7)
    for h, w in ((400, 260), (190, 120), (520, 530)):  # max edge above the 175 cap at 224
        crop = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        want = jpre.load_char_content(Image.fromarray(crop), 224, canvas=176)
        got = tpre.load_char_content(crop, 224, canvas=176)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 3


def test_tile_and_char_helpers_match_jax():
    for size in (56, 224, 448):
        assert tpre.char_canvas_buckets(size) == jpre.char_canvas_buckets(size)
        assert tpre.char_content_canvas(size) == jpre.char_content_canvas(size)
        for w, h in ((30, 50), (120, 90), (400, 380)):
            assert tpre.char_content_dims(w, h, size) == jpre.char_content_dims(w, h, size)
    for ow, oh in ((788, 2000), (2000, 788), (448, 448), (1000, 90)):
        assert tpre.tile_grid(ow, oh) == jpre.tile_grid(ow, oh)
    stack = np.ones((6, 2, 2), np.uint8)
    for a, b in zip(tpre.pad_to_bucket(stack), jpre.pad_to_bucket(stack)):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def detections(page):
    img, _ = page
    jcfg = callireader_2b().detector
    tcfg = tconfig.callireader_2b().detector
    path = str(ASSETS_DIR / "detector_640.npz")
    want = jdet.Detector(jdet.load_npz(path), jcfg)(img)
    got = tdet.Detector(tdet.load_npz(path, "cpu"), tcfg, "cpu")(img)
    return want, got


def test_detector_boxes_match_jax(detections):
    want, got = detections
    assert len(got) == len(want) > 50
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-2)
    assert [[int(v) for v in b] for b in got] == [[int(v) for v in b] for b in want]


def test_box_pipeline_and_orderformer_match_jax(page, detections):
    img, _ = page
    want_det, got_det = detections
    h, w = img.shape[:2]

    def pairs(dets):
        return [[[max(int(b[0]), 0), max(int(b[1]), 0)], [min(int(b[2]), w), min(int(b[3]), h)]]
                for b in dets]

    jb = jboxes.dedup_boxes_iou(pairs(want_det), 0.8)
    tb = tboxes.dedup_boxes_iou(pairs(got_det), 0.8)
    assert tb == jb
    jcols = jboxes.char2col_with_kmeans(jb, w, h)
    tcols = tboxes.char2col_with_kmeans(tb, w, h)
    assert tcols["shapes"] == jcols["shapes"]

    path = str(ASSETS_DIR / "orderformer.npz")
    jorder = jof.predict(jdet.load_npz(path), callireader_2b().orderformer, jcols["shapes"], w, h)
    torder = tof.predict(tdet.load_npz(path, "cpu"), tconfig.callireader_2b().orderformer,
                         tcols["shapes"], w, h)
    assert torder == jorder


def test_kmeans_split_dependency_free_branch():
    boxes = [[[0, 0], [10, 10]]] * 3 + [[[0, 20], [60, 80]]] * 5 + [[[70, 0], [75, 4]]]
    labels = tboxes._area_kmeans_1d(
        np.array([(b[1][0] - b[0][0]) * (b[1][1] - b[0][1]) for b in boxes], np.float64))
    assert labels.tolist() == [0, 0, 0, 1, 1, 1, 1, 1, 0]
