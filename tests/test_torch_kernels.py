"""Port kernels: plain PyTorch versions against the JAX kernels (CPU), and the
CUDA kernels against their plain versions (card only, marked ``cuda``).

Inputs come from numpy seeds and go to both frameworks as float32. Tolerances:
- 1e-5 max abs against fp32 JAX paths (same math, fp32 rounding order only);
- 2e-2 against ``vit_attention_nomax``, which rounds its scores to bf16
  inside the kernel even for fp32 inputs;
- on the card, bf16 kernel output against the fp32 plain version on the same
  bf16 inputs: elementwise within the output's own bf16 rounding plus the
  kernel's ATOL for fp32 summation order (kernels/tolerance.py, the same
  check chip_smoke.py applies).
"""

import types

import numpy as np
import pytest
import torch

from callireader_tpu_torch.kernels import attention as tattn
from callireader_tpu_torch.core.dtypes import exact_fp32
from callireader_tpu_torch.kernels import decode_attention as tdec
from callireader_tpu_torch.kernels import int8_matmul as ti8
from callireader_tpu_torch.kernels import tolerance
from callireader_tpu_torch.kernels import vit_attention as tvit


@pytest.fixture(scope="module")
def jx():
    """The JAX kernels (imported here so the card-only cases of this file run
    where JAX is absent: ``pytest --noconftest -m cuda``)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from callireader_tpu.kernels import attention, decode_attention
    from callireader_tpu.kernels import packed_qkv_attention, vit_attention

    return types.SimpleNamespace(jnp=jnp, attn=attention, dec=decode_attention,
                                 packed=packed_qkv_attention, vit=vit_attention)


def _np(t):
    return t.detach().float().cpu().numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ---------------------------------------------------------------- ViT packed


@pytest.mark.parametrize("S,H,D", [(37, 2, 32), (70, 4, 64), (257, 2, 32)])
def test_vit_plain_matches_jax(jx, S, H, D):
    jnp, jattn, jvit, jpacked = jx.jnp, jx.attn, jx.vit, jx.packed
    rng = np.random.default_rng(S + D)
    qkv = rng.standard_normal((2, S, 3 * H * D), dtype=np.float32)
    got = _np(tvit.attention_from_packed_qkv(torch.from_numpy(qkv), H))
    precise = np.asarray(jvit.attention_from_packed_qkv(jnp.asarray(qkv), H, interpret=True))
    packed = np.asarray(jpacked.flash_attention_packed_qkv(jnp.asarray(qkv), H, interpret=True))
    nomax = np.asarray(jvit.attention_from_packed_qkv_nomax(jnp.asarray(qkv), H, interpret=True))
    x = jnp.asarray(qkv).reshape(2, S, 3, H, D)
    ref = jattn.attention_reference(
        *(x[:, :, i].transpose(0, 2, 1, 3) for i in range(3)), causal=False
    ).transpose(0, 2, 1, 3).reshape(2, S, H * D)
    np.testing.assert_allclose(got, precise, atol=1e-5)
    np.testing.assert_allclose(got, packed, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(got, nomax, atol=2e-2)


def test_vit_aliases_are_one_function():
    assert tvit.attention_from_packed_qkv is tvit.attention_from_packed_qkv_nomax
    assert tvit.flash_attention_packed_qkv is tvit.attention_from_packed_qkv_nomax


# ------------------------------------------------------------ flash (prefill)


def _qkv(rng, B, Hq, Hkv, Sq, Sk, D):
    q = rng.standard_normal((B, Hq, Sq, D), dtype=np.float32)
    k = rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32)
    return q, k, v


def _left_pad_segments(B, S, pads):
    seg = np.zeros((B, S), np.int32)
    for b, p in enumerate(pads):
        seg[b, :p] = -1
    return seg


FLASH_CASES = {
    # name: (B, Hq, Hkv, Sq, Sk, D, causal, pads, q_offset)
    "causal_left_pad": (2, 4, 2, 40, 40, 16, True, (0, 13), 0),
    "causal_q_offset": (1, 4, 4, 24, 56, 16, True, None, 32),
    "gqa_g4_noncausal": (2, 8, 2, 33, 33, 16, False, None, 0),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax(jx, case):
    jnp, jattn = jx.jnp, jx.attn
    B, Hq, Hkv, Sq, Sk, D, causal, pads, q_off = FLASH_CASES[case]
    rng = np.random.default_rng(len(case))
    q, k, v = _qkv(rng, B, Hq, Hkv, Sq, Sk, D)
    seg_kw_j, seg_kw_t = {}, {}
    if pads is not None:
        seg = _left_pad_segments(B, Sq, pads)
        seg_kw_j = dict(q_segment_ids=jnp.asarray(seg), kv_segment_ids=jnp.asarray(seg))
        seg_kw_t = dict(q_segment_ids=torch.from_numpy(seg), kv_segment_ids=torch.from_numpy(seg))
    got = _np(tattn.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=q_off, **seg_kw_t))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want_flash = np.asarray(jattn.flash_attention(
        jq, jk, jv, causal=causal, interpret=True, q_offset=q_off, **seg_kw_j))
    want_ref = np.asarray(jattn.attention_reference(
        jq, jk, jv, causal=causal, q_offset=q_off, **seg_kw_j))
    np.testing.assert_allclose(got, want_flash, atol=1e-5)
    np.testing.assert_allclose(got, want_ref, atol=1e-5)


def test_flash_plain_fully_masked_rows_are_zero():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 2, 2, 6, 6, 8)
    qs = torch.tensor([[0, 0, 5, 0, 0, 0]], dtype=torch.int32)  # row 2 matches no key
    ks = torch.zeros((1, 6), dtype=torch.int32)
    out = _np(tattn.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, q_segment_ids=qs, kv_segment_ids=ks))
    assert np.all(out[:, :, 2] == 0) and np.all(np.abs(out[:, :, 3]) > 0)


# --------------------------------------------------------------- flash decode


@pytest.mark.parametrize("layer", [1, 2])
def test_decode_plain_matches_jax(jx, layer):
    jnp, jdec = jx.jnp, jx.dec
    rng = np.random.default_rng(layer)
    L, B, Hq, Hkv, S, D = 3, 2, 8, 2, 48, 16
    q = rng.standard_normal((B, Hq, 1, D), dtype=np.float32)
    ck = rng.standard_normal((L, B, Hkv, S, D), dtype=np.float32)
    cv = rng.standard_normal((L, B, Hkv, S, D), dtype=np.float32)
    valid = np.zeros((B, S), np.int32)
    valid[0, 5:30] = 1  # ragged: left pad + unwritten tail
    valid[1, 17:41] = 1
    got = _np(tdec.flash_decode(
        torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv), layer,
        torch.from_numpy(valid)))
    want = np.asarray(jdec.flash_decode(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(layer),
        jnp.asarray(valid), interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-5)


# ------------------------------------------------ card tolerance (CPU check)


@pytest.mark.parametrize("name", ["flash_attention", "flash_decode"])
def test_tolerance_passes_rounding_and_fails_dropped_keys(name):
    """The card's check passes the plain output's own bf16 rounding and fails
    an output that lost the last 64 keys (one dropped key tile or chunk)."""
    rng = np.random.default_rng(21)
    B, Hq, Hkv, S, D = 2, 8, 2, 1024, 128
    q, k, v = (torch.from_numpy(x).bfloat16().float() for x in _qkv(rng, B, Hq, Hkv, S, S, D))
    keep = torch.ones((B, S), dtype=torch.int32)
    cut = keep.clone()
    cut[:, -64:] = 0
    if name == "flash_decode":
        run = lambda valid: tdec.flash_decode_reference(q[:, :, -1:], k[None], v[None], 0, valid)
    else:
        run = lambda kseg: tattn.attention_reference(q, k, v, causal=True, q_segment_ids=keep,
                                                     kv_segment_ids=kseg)
    want = run(keep)
    assert tolerance.excess_error(want.bfloat16(), want) <= tolerance.ATOL[name]
    assert tolerance.excess_error(run(cut).bfloat16(), want) > 10 * tolerance.ATOL[name]


# ------------------------------------------------------------ CUDA kernels


def _bf16(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,D", [(1025, 16, 64), (257, 8, 32), (70, 4, 64)])
def test_cuda_vit_matches_plain(cuda, S, H, D):
    rng = np.random.default_rng(7)
    qkv = _bf16(rng, (3, S, 3 * H * D), cuda)
    got = tvit.attention_from_packed_qkv_nomax(qkv, H)
    torch.cuda.synchronize()
    want = tvit.vit_attention_reference(qkv.float(), H)
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["vit_attention"]


@pytest.mark.cuda
@pytest.mark.parametrize("causal,pad,q_off,G,D", [
    (True, True, 0, 4, 128), (True, False, 64, 4, 128), (False, False, 0, 1, 64),
    (True, True, 0, 1, 64),
])
def test_cuda_flash_matches_plain(cuda, causal, pad, q_off, G, D):
    rng = np.random.default_rng(11)
    B, Hkv, Sq = 2, 2, 300
    Sk = Sq + q_off
    q = _bf16(rng, (B, Hkv * G, Sq, D), cuda)
    k = _bf16(rng, (B, Hkv, Sk, D), cuda)
    v = _bf16(rng, (B, Hkv, Sk, D), cuda)
    kw = {}
    if pad:
        seg = torch.from_numpy(_left_pad_segments(B, Sq, (0, 77))).to(cuda)
        kw = dict(q_segment_ids=seg, kv_segment_ids=seg)
    got = tattn.flash_attention(q, k, v, causal=causal, q_offset=q_off, **kw)
    torch.cuda.synchronize()
    want = tattn.attention_reference(q.float(), k.float(), v.float(), causal=causal,
                                     q_offset=q_off, **kw)
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["flash_attention"]


@pytest.mark.cuda
def test_cuda_flash_fully_masked_rows_are_zero(cuda):
    rng = np.random.default_rng(12)
    q, k, v = (_bf16(rng, (1, 4, 70, 64), cuda) for _ in range(3))
    qs = torch.zeros((1, 70), dtype=torch.int32, device=cuda)
    qs[0, 10] = 9
    ks = torch.zeros((1, 70), dtype=torch.int32, device=cuda)
    got = tattn.flash_attention(q, k, v, causal=True, q_segment_ids=qs, kv_segment_ids=ks)
    want = tattn.attention_reference(q.float(), k.float(), v.float(), causal=True,
                                     q_segment_ids=qs, kv_segment_ids=ks)
    assert got[:, :, 10].abs().max().item() == 0
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["flash_attention"]


@pytest.mark.cuda
@pytest.mark.parametrize("S,layer", [(3648, 5), (300, 0)])
def test_cuda_decode_matches_plain(cuda, S, layer):
    rng = np.random.default_rng(13)
    L, B, Hq, Hkv, D = 8, 3, 32, 8, 128
    q = _bf16(rng, (B, Hq, 1, D), cuda)
    ck = _bf16(rng, (L, B, Hkv, S, D), cuda)
    cv = _bf16(rng, (L, B, Hkv, S, D), cuda)
    valid = torch.zeros((B, S), dtype=torch.int32, device=cuda)
    valid[0, 10:S - 40] = 1
    valid[1, :] = 1
    valid[2, S // 2:S // 2 + 3] = 1
    got = tdec.flash_decode(q, ck, cv, layer, valid)
    torch.cuda.synchronize()
    want = tdec.flash_decode_reference(q.float(), ck.float(), cv.float(), layer, valid)
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["flash_decode"]


@pytest.mark.cuda
def test_cuda_wrappers_refuse_bad_input(cuda):
    qkv = torch.zeros((1, 10, 3 * 2 * 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        tvit.attention_from_packed_qkv(qkv, 2)  # D=16 has no kernel
    with pytest.raises(ValueError):
        tvit.attention_from_packed_qkv(qkv.float(), 2)
    q = torch.zeros((1, 4, 8, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        tattn.flash_attention(q, q[:, :2], q[:, :2])  # G=2 is not instantiated
    cache = torch.zeros((1, 1, 2, 8, 128), dtype=torch.bfloat16, device=cuda)
    valid = torch.ones((1, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tdec.flash_decode(q[:, :, :1].contiguous(), cache, cache, 0, valid)


# ------------------------------------------------------- int8 products (card)


def _int8(rng, shape, device):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(device)


def _scales(rng, n, device):
    return torch.from_numpy((rng.random(n) * 1e-3 + 1e-4).astype(np.float32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 32])
@pytest.mark.parametrize("K,N", [(4096, 6144), (14336, 4096), (256, 128)])
def test_cuda_int8_matmul_matches_plain(cuda, M, K, N):
    rng = np.random.default_rng(M + K)
    h, q, s = _bf16(rng, (M, K), cuda), _int8(rng, (K, N), cuda), _scales(rng, N, cuda)
    got = ti8.int8_matmul(h, q, s)
    torch.cuda.synchronize()
    with exact_fp32():
        want = ti8.int8_matmul_reference(h.float(), q, s)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["int8_matmul"]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 4, 32])
@pytest.mark.parametrize("K,N", [(4096, 92672), (128, 256)])
def test_cuda_int8_matmul_nt_matches_plain(cuda, M, K, N):
    rng = np.random.default_rng(M + N)
    h, q, s = _bf16(rng, (M, K), cuda), _int8(rng, (N, K), cuda), _scales(rng, N, cuda)
    got = ti8.int8_matmul_nt(h, q, s)
    torch.cuda.synchronize()
    with exact_fp32():
        want = ti8.int8_matmul_nt_reference(h.float(), q, s)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["int8_matmul_nt"]


@pytest.mark.cuda
def test_cuda_int8_stacked_reads_the_layer_in_place(cuda):
    """The model's route for JAX's stacked kernel: layer ``i`` of the
    (L, K, N) stack sliced as a view goes to the one (K, N) kernel, and gives
    what a copy of that layer gives."""
    from callireader_tpu_torch.models import internlm2 as tllm

    rng = np.random.default_rng(5)
    L, M, K, N = 4, 4, 1024, 768
    h, q, s = _bf16(rng, (M, K), cuda), _int8(rng, (L, K, N), cuda), _scales(rng, L * N, cuda)
    stack = {"layers": {"w_q": q, "w_scale": s.reshape(L, 1, N)}}
    before = ti8.KERNEL.launches
    for layer in range(L):
        got = tllm._proj(tllm._layer(stack, layer), h, "w")
        assert torch.equal(got, ti8.int8_matmul(h, q[layer].clone(), s.reshape(L, N)[layer].clone()))
    assert ti8.KERNEL.launches == before + 2 * L


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [(4096, 1024, 1024), (14336, 14336)])
def test_cuda_int8_fused_equals_unfused_bitwise(cuda, parts):
    """The fused wqkv / w13 product, split, equals the separate products bit
    for bit: each column's summation order depends on K alone."""
    rng = np.random.default_rng(len(parts))
    M, K = 4, 4096
    h = _bf16(rng, (M, K), cuda)
    qs = [_int8(rng, (K, n), cuda) for n in parts]
    ss = [_scales(rng, n, cuda) for n in parts]
    fused = ti8.int8_matmul(h, torch.cat(qs, dim=1), torch.cat(ss))
    for got, q, s in zip(torch.split(fused, list(parts), dim=1), qs, ss):
        assert torch.equal(got, ti8.int8_matmul(h, q, s))


@pytest.mark.cuda
def test_cuda_int8_wrappers_refuse_bad_input(cuda):
    rng = np.random.default_rng(6)
    q, s = _int8(rng, (512, 256), cuda), _scales(rng, 256, cuda)
    qt, st = _int8(rng, (256, 512), cuda), _scales(rng, 256, cuda)
    for fn, w, sc in ((ti8.int8_matmul, q, s), (ti8.int8_matmul_nt, qt, st)):
        with pytest.raises(ValueError):
            fn(_bf16(rng, (33, 512), cuda), w, sc)  # M = 33
        with pytest.raises(ValueError):
            fn(_bf16(rng, (4, 512), cuda).float(), w, sc)  # fp32 rows
        with pytest.raises(ValueError):
            fn(_bf16(rng, (4, 512), cuda), w.T.contiguous().T, sc)  # non-contiguous weight
    with pytest.raises(ValueError):  # K = 192 is no multiple of 128
        ti8.int8_matmul(_bf16(rng, (4, 192), cuda), _int8(rng, (192, 256), cuda), s)
    with pytest.raises(ValueError):
        ti8.int8_matmul_nt(_bf16(rng, (4, 192), cuda), _int8(rng, (256, 192), cuda), st)
