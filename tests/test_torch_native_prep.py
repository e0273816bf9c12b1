"""The port's native char-prep library (vision/native.py, csrc/charprep.cpp)
against the JAX package's build of the same source, and against the plain
numpy route (vision/preprocess.load_char_content, vision/resample).

Bounds: byte-equal to the JAX library at any thread count; within 2/255 of
the PIL-compatible bicubic resize and 3/255 of the plain char route, with
white padding in exactly the same cells (tests/test_native_prep.py's
bounds). The engine's default host char route gives the JAX engine's
default canvases byte for byte.
"""

import numpy as np
import pytest

from callireader_tpu.runtime.engine import CalliReaderEngine as JEngine
from callireader_tpu.vision import native as jnative
from callireader_tpu_torch.kernels import _build
from callireader_tpu_torch.runtime.engine import CalliReaderEngine as TEngine
from callireader_tpu_torch.vision import native as tnative
from callireader_tpu_torch.vision import preprocess as tpre
from callireader_tpu_torch.vision import resample

SHAPES = [(30, 80), (400, 120), (448, 448), (12, 9), (1, 1), (199, 201), (350, 20), (64, 48),
          (700, 350), (5, 300)]


@pytest.fixture(scope="module")
def jlib():
    if not jnative.available():
        pytest.skip("g++ unavailable: the JAX package's library did not build")
    return jnative.get_lib()


def _crops(seed, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3)).astype(np.uint8) for h, w in shapes]


@pytest.mark.parametrize("nthreads", [1, 8])
@pytest.mark.parametrize("size", [448, 224])
def test_char_content_batch_equals_the_jax_library(jlib, size, nthreads):
    """Every crop a bucket holds, byte for byte; a crop whose content is
    larger than the bucket is refused (the shared library would write past
    its canvas: into the next crop's at a place that depends on the
    threads' order, or before the array)."""
    crops = _crops(size + nthreads)
    lo, hi = max(1, round(200 * size / 448)), tpre.char_content_canvas(size)
    refused = 0
    for bucket in tpre.char_canvas_buckets(size):
        fits = [c for c in crops if max(tnative.content_dims(*c.shape[:2], lo, hi)) <= bucket]
        want = jnative.char_content_batch(fits, bucket, lo, hi, nthreads=nthreads)
        got = tnative.char_content_batch(fits, bucket, lo, hi, nthreads=nthreads)
        assert got.shape == (len(fits), bucket, bucket, 3)
        np.testing.assert_array_equal(got, want)
        for c in crops:
            if max(tnative.content_dims(*c.shape[:2], lo, hi)) > bucket:
                refused += 1
                with pytest.raises(ValueError, match="cannot hold"):
                    tnative.char_content_batch([c], bucket, lo, hi, nthreads=nthreads)
    assert refused > 0


def test_thread_count_changes_no_byte():
    crops = _crops(3) * 3
    one = tnative.char_content_batch(crops, 350, 200, 350, nthreads=1)
    for n in (2, 8, 64):
        np.testing.assert_array_equal(tnative.char_content_batch(crops, 350, 200, 350, nthreads=n), one)


def test_resize_equals_the_jax_library_and_holds_the_plain_bound(jlib):
    rng = np.random.RandomState(0)
    for sh, sw, dh, dw in [(100, 80, 350, 280), (500, 300, 200, 120), (64, 64, 64, 64),
                           (13, 211, 7, 350)]:
        src = rng.randint(0, 256, (sh, sw, 3)).astype(np.uint8)
        got = tnative.resize_bicubic(src, dh, dw)
        np.testing.assert_array_equal(got, jnative.resize_bicubic(src, dh, dw))
        plain = resample.pil_resize(src, (dw, dh), "bicubic")
        assert np.abs(plain.astype(np.int16) - got.astype(np.int16)).max() <= 2, (sh, sw, dh, dw)


@pytest.mark.parametrize("size", [448, 224])
def test_char_content_batch_holds_the_plain_route(size):
    crops = _crops(7)
    lo, hi = max(1, round(200 * size / 448)), tpre.char_content_canvas(size)
    canvas = tpre.char_canvas_buckets(size)[-1]
    out = tnative.char_content_batch(crops, canvas, lo, hi)
    for i, crop in enumerate(crops):
        ref = tpre.load_char_content(crop, size, canvas=canvas)
        np.testing.assert_array_equal(ref == 255, out[i] == 255)
        assert np.abs(ref.astype(np.int16) - out[i].astype(np.int16)).max() <= 3, i


def _route_engines(size, gray):
    """The JAX and the port engine as far as their host char route reads
    them: the content size and the luma option."""
    jeng, teng = JEngine.__new__(JEngine), TEngine.__new__(TEngine)
    for e in (jeng, teng):
        e.char_content_size, e.gray_chars = size, gray
    return jeng, teng


@pytest.mark.parametrize("gray", [True, False])
@pytest.mark.parametrize("size", [448, 224])
def test_engine_default_host_groups_equal_jax(jlib, size, gray):
    jeng, teng = _route_engines(size, gray)
    crops = _crops(11 + size)
    want = {tuple(i): jeng._to_luma(s) for i, s in jeng._prep_char_crop_groups(crops)}
    got = {tuple(i): s for i, s in teng._prep_char_crop_groups(crops)}
    assert set(got) == set(want) and len(want) > 1
    for idx, stack in got.items():
        assert stack.ndim == (3 if gray else 4)
        np.testing.assert_array_equal(stack, want[idx])


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "charprep.cpp").write_text("int main( {\n")
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(RuntimeError, match="(?s)charprep.*error"):
        tnative.char_content_batch(_crops(0)[:1], 350, 200, 350)
    assert not list((tmp_path / "_build").glob("*.so"))
