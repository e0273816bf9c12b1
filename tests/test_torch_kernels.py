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
Plain-torch emulations of the int8 kernels' fixed chunked summation orders
(the LM head's, and the (K, N) product's split of K into ranges summed in
rank order) stand within their ATOL on the CPU and give a row the same bits
whatever M is; on the card the kernels themselves do, and their SASS holds
HMMA and UTMALDG. Emulations of the decode kernels' merge orders (runs of
64-key chunks, of table entries for the paged kernel, four warps' online
softmaxes a run) stand within their ATOL, and dead entries, wherever they
point, change no bit of the paged one; both kernels' SASS holds bulk copies
(UBLKCP), and on the card the contiguous kernel gives the same bits in 20
launches and stands within ATOL of the CUDA-core kernel it replaced.
"""

import types

import numpy as np
import pytest
import torch

from callireader_tpu_torch.kernels import attention as tattn
from callireader_tpu_torch.core.dtypes import exact_fp32
from callireader_tpu_torch.kernels import decode_attention as tdec
from callireader_tpu_torch.kernels import int8_matmul as ti8
from callireader_tpu_torch.kernels import paged_decode as tpaged
from callireader_tpu_torch.kernels import tolerance
from callireader_tpu_torch.kernels import vit_attention as tvit
from callireader_tpu_torch.tools.attention_arith import tensor_core_loop


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


# ------------------------------- the tensor-core loop's arithmetic (CPU check)


def _main_path_case(case):
    """(kernel name, loop output with a split P, with a single bf16 P, fp32
    plain version) at a main-path head dim and sequence length."""
    rng = np.random.default_rng(31)

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16().float()

    if case in ("vit_d64", "char_d32"):
        S, H, D = (1025, 2, 64) if case == "vit_d64" else (257, 4, 32)
        qkv = bf16((1, S, 3 * H * D))
        x = qkv.reshape(1, S, 3, H, D).transpose(1, 3)  # (1, H, 3, S, D)
        q, k, v = x[:, :, 0], x[:, :, 1], x[:, :, 2]
        want = tvit.vit_attention_reference(qkv, H)
        runs = [tensor_core_loop(q, k, v, D**-0.5, None, split).transpose(1, 2).reshape(1, S, H * D)
                for split in (True, False)]
        return "vit_attention", runs[0], runs[1], want
    B, Hq, Hkv, S, D = 2, 4, 1, 1024, 128  # the prefill: G = 4, causal, left padding
    q, k, v = bf16((B, Hq, S, D)), bf16((B, Hkv, S, D)), bf16((B, Hkv, S, D))
    seg = torch.from_numpy(_left_pad_segments(B, S, (0, 77)))
    want = tattn.attention_reference(q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    mask = (seg[:, :, None] == seg[:, None, :]) & torch.ones((S, S), dtype=torch.bool).tril()
    kr, vr = k.repeat_interleave(Hq // Hkv, 1), v.repeat_interleave(Hq // Hkv, 1)
    runs = [tensor_core_loop(q, kr, vr, D**-0.5, mask[:, None], split) for split in (True, False)]
    return "flash_attention", runs[0], runs[1], want


@pytest.mark.parametrize("split", [True, False], ids=["split_p", "single_bf16_p"])
@pytest.mark.parametrize("case", ["vit_d64", "char_d32", "prefill_d128"])
def test_tensor_core_loop_needs_split_p(case, split):
    """A tensor-core P V takes bf16 operands: with P split into two bf16
    parts the loop's output stands within the card's tolerance of the fp32
    plain version; with P rounded to bf16 once it misses by more than 10x."""
    name, out_split, out_single, want = _main_path_case(case)
    if split:
        assert tolerance.excess_error(out_split, want) <= tolerance.ATOL[name]
    else:
        assert tolerance.excess_error(out_single, want) > 10 * tolerance.ATOL[name]


# ---------------------------- the int8 LM head's summation order (CPU check)


def nt_chunked(h, q, scale):
    """Plain-torch emulation of csrc/int8_matmul.cu's nt kernel order: K in
    stages of 256 (zero-padded), each stage four groups of 64 whose sums
    (exact, in fp64: bf16 x int8 products have 15 significant bits) are
    rounded to fp32 and added in order into the stage's fp32 sum, the stages
    added in order into the row's fp32 total, then the fp32 scale and one
    rounding to bf16. h (M, K) bf16, q (N, K) int8, scale (N,) fp32."""
    K = h.shape[1]
    pad = -K % 256
    hd = torch.nn.functional.pad(h.double(), (0, pad))
    qd = torch.nn.functional.pad(q.double(), (0, pad))
    total = torch.zeros((h.shape[0], q.shape[0]), dtype=torch.float32)
    for k0 in range(0, K + pad, 256):
        part = torch.zeros_like(total)
        for g0 in range(k0, k0 + 256, 64):
            part = part + (hd[:, g0:g0 + 64] @ qd[:, g0:g0 + 64].T).float()
        total = total + part
    return (total * scale.float()).to(h.dtype)


def _nt_case(M, K, N=256, seed=0):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).bfloat16()
    q = torch.from_numpy(rng.integers(-127, 128, (N, K), dtype=np.int8))
    s = torch.from_numpy((rng.random(N) * 1e-3 + 1e-4).astype(np.float32))
    return h, q, s


@pytest.mark.parametrize("M", [1, 5, 8, 32])
@pytest.mark.parametrize("K", [128, 4096])
def test_nt_chunked_order_matches_plain(M, K):
    """The LM head's fixed chunked fp32 order stands within the card's ATOL
    of the fp32 plain version."""
    h, q, s = _nt_case(M, K, seed=M + K)
    with exact_fp32():
        want = ti8.int8_matmul_nt_reference(h.float(), q, s)
    assert tolerance.excess_error(nt_chunked(h, q, s), want) <= tolerance.ATOL["int8_matmul_nt"]


@pytest.mark.parametrize("M", [8, 32])
def test_nt_chunked_order_row_bits_do_not_depend_on_m(M):
    """Under that order a row's output is the same bits whether it is
    computed alone or among M rows."""
    h, q, s = _nt_case(M, 4096, seed=M)
    together = nt_chunked(h, q, s)
    for m in range(M):
        assert torch.equal(together[m:m + 1], nt_chunked(h[m:m + 1], q, s)), m


# ------------------- the (K, N) int8 product's summation order (CPU check)


def kn_chunked(h, q, scale, drop=None):
    """Plain-torch emulation of csrc/int8_matmul.cu's kn kernel order: K in
    ``kn_splits(K)`` ranges of whole 64-row groups; each group's sum from
    zero (exact, in fp64: bf16 x int8 products have 15 significant bits)
    rounded to fp32; four consecutive groups from a range's first added in
    order into a stage's fp32 sum, the stages in order into the range's fp32
    total, the ranges in rank order; then the fp32 scale and one rounding to
    bf16. h (M, K) bf16, q (K, N) int8, scale (N,) fp32. ``drop``: a group
    left out (to show that the check sees it)."""
    K, G = h.shape[1], h.shape[1] // ti8.GROUP
    S = ti8.kn_splits(K)
    hd = h.double()
    out = None
    for s in range(S):
        g0, g1 = G * s // S, G * (s + 1) // S
        total = torch.zeros((h.shape[0], q.shape[1]), dtype=torch.float32)
        for st in range(g0, g1, 4):
            part = torch.zeros_like(total)
            for g in range(st, min(st + 4, g1)):
                if g != drop:
                    k = slice(g * ti8.GROUP, (g + 1) * ti8.GROUP)
                    part = part + (hd[:, k] @ q[k].double()).float()
            total = total + part
        out = total if out is None else out + total
    return (out * scale.float()).to(h.dtype)


# the main path's (K, N) projections of callireader-8b; the CPU checks take
# their first 256 columns (a column's order depends on K alone)
KN_PROJECTIONS = {"wqkv": (4096, 6144), "wo": (4096, 4096), "w13": (4096, 28672),
                  "w2": (14336, 4096)}


def _kn_case(M, K, N=256, seed=0):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((M, K), dtype=np.float32)).bfloat16()
    q = torch.from_numpy(rng.integers(-127, 128, (K, N), dtype=np.int8))
    s = torch.from_numpy((rng.random(N) * 1e-3 + 1e-4).astype(np.float32))
    return h, q, s


@pytest.mark.parametrize("K,want", [(128, 1), (1024, 1), (2048, 2), (4096, 4), (8192, 8),
                                    (14336, 7), (28672, 8)])
def test_kn_splits_depend_on_k_and_hold_whole_groups(K, want):
    S, G = ti8.kn_splits(K), K // ti8.GROUP
    assert S == want
    bounds = [G * s // S for s in range(S + 1)]
    assert bounds[0] == 0 and bounds[-1] == G and all(b1 > b0 for b0, b1 in zip(bounds, bounds[1:]))


@pytest.mark.parametrize("M", [1, 5, 8, 32])
@pytest.mark.parametrize("proj", sorted(KN_PROJECTIONS))
def test_kn_chunked_order_matches_plain(proj, M):
    """The (K, N) kernel's fixed split order stands within the card's ATOL
    of the fp32 plain version at each main-path K."""
    K, _ = KN_PROJECTIONS[proj]
    h, q, s = _kn_case(M, K, seed=M + K + len(proj))
    with exact_fp32():
        want = ti8.int8_matmul_reference(h.float(), q, s)
    assert tolerance.excess_error(kn_chunked(h, q, s), want) <= tolerance.ATOL["int8_matmul"]


@pytest.mark.parametrize("M", [8, 32])
@pytest.mark.parametrize("K", [4096, 14336])
def test_kn_chunked_order_row_bits_do_not_depend_on_m(M, K):
    h, q, s = _kn_case(M, K, seed=M)
    together = kn_chunked(h, q, s)
    for m in range(M):
        assert torch.equal(together[m:m + 1], kn_chunked(h[m:m + 1], q, s)), m


@pytest.mark.parametrize("parts", [(128, 64, 64), (192, 192)], ids=["wqkv", "w13"])
def test_kn_chunked_fused_columns_equal_separate_products(parts):
    """Fused columns, split apart, equal the separate products bit for bit:
    nothing in the order depends on N or on a column's place."""
    h, q, s = _kn_case(4, 4096, N=sum(parts), seed=len(parts))
    fused = kn_chunked(h, q, s)
    for got, qp, sp in zip(fused.split(parts, 1), q.split(parts, 1), s.split(parts)):
        assert torch.equal(got, kn_chunked(h, qp, sp))


@pytest.mark.parametrize("K,drop", [(4096, 0), (4096, 37), (14336, 127), (14336, 223)])
def test_kn_chunked_dropped_group_fails_the_check(K, drop):
    h, q, s = _kn_case(8, K, seed=K)
    with exact_fp32():
        want = ti8.int8_matmul_reference(h.float(), q, s)
    got = kn_chunked(h, q, s, drop=drop)
    assert tolerance.excess_error(got, want) > 10 * tolerance.ATOL["int8_matmul"]


# ------------------ the decode kernels' merge orders (CPU checks)


NINF = float("-inf")


def _merge_states(states):
    """Online-softmax states (max (..., G), sum (..., G), weighted V
    (..., G, D)) merged in list order, as the kernels' warp merge and
    decode_combine do; a state whose max is -inf adds nothing."""
    mx = torch.stack([m for m, _, _ in states]).max(0).values
    L, acc = torch.zeros_like(states[0][1]), torch.zeros_like(states[0][2])
    for m, l, a in states:
        c = torch.where(m == NINF, 0.0, torch.exp2(m - mx))
        L = L + l * c
        acc = acc + a * c[..., None]
    return mx, L, acc


def _warp_step(state, qs, k, v, ok):
    """One warp's online-softmax step over its keys: qs (..., G, D) prescaled
    by scale * log2(e), k and v (..., n, D), ok (..., 1, n) or (n,)."""
    m, l, a = state
    sc = torch.where(ok, qs @ k.transpose(-1, -2), NINF)
    mn = torch.maximum(m, sc.max(-1).values)
    alpha = torch.where(mn == NINF, 1.0, torch.exp2(m - mn))
    p = torch.where(ok, torch.exp2(sc - mn[..., None]), 0.0)
    return mn, l * alpha + p.sum(-1), a * alpha[..., None] + p @ v


def _finish(state):
    _, L, acc = state
    return torch.where(L[..., None] > 0, acc / L[..., None], 0.0)


def paged_runs(q, kpool, vpool, layer, table, valid, drop=None):
    """Plain-torch (fp32) emulation of csrc/paged_decode.cu's order: per
    (slot, KV head) runs of RUN table entries; in a run, the live 64-key
    chunks (entry in the pool, a valid key) in table order, each split over
    four warps of 16 keys that keep their own online softmax (max, sum,
    weighted V) across the run's chunks; the warps merged in order into the
    run's partial, the runs merged in order (decode_combine); a slot with no
    valid key gives zeros. ``drop``: a (slot, entry) left out."""
    B, Hq, _, D = q.shape
    _, NP, Hkv, page, _ = kpool.shape
    P, G = table.shape[1], Hq // Hkv
    scale_log2 = torch.tensor(D**-0.5 * 1.4426950408889634, dtype=torch.float32)
    empty = (torch.full((G,), NINF), torch.zeros(G), torch.zeros(G, D))

    out = torch.zeros(B, Hq, 1, D)
    for b in range(B):
        for hkv in range(Hkv):
            qs = q[b, hkv * G:(hkv + 1) * G, 0].float() * scale_log2
            runs = []
            for r0 in range(0, P, tpaged.RUN):
                warps = [empty] * 4
                for j in range(r0, min(P, r0 + tpaged.RUN)):
                    pid = int(table[b, j])
                    if not 0 <= pid < NP or (b, j) == drop:
                        continue
                    for c0 in range(0, page, 64):
                        n = min(64, page - c0)
                        ok = valid[b, j, c0:c0 + n] != 0
                        if not ok.any():
                            continue
                        k = kpool[layer, pid, hkv, c0:c0 + n].float()
                        v = vpool[layer, pid, hkv, c0:c0 + n].float()
                        for w in range(4):
                            ks = slice(16 * w, min(16 * w + 16, n))
                            if ks.start < n:
                                warps[w] = _warp_step(warps[w], qs, k[ks], v[ks], ok[ks])
                runs.append(_merge_states(warps))
            out[b, hkv * G:(hkv + 1) * G, 0] = _finish(_merge_states(runs))
    return out.to(q.dtype)


def decode_runs(q, cache_k, cache_v, layer, valid):
    """Plain-torch (fp32) emulation of csrc/flash_decode.cu's order: per (row,
    KV head) runs of ``run_chunks(B, Hkv, S)`` chunks of 64 keys, each chunk
    split over four warps of 16 keys that keep their own online softmax
    across the run's chunks; the warps merged in order into the run's
    partial, the runs merged in order (decode_combine). The kernel skips a
    chunk, or a warp's 16 keys, with no valid key; here they are a step of
    the state with every key masked, which leaves each of its bits as it was,
    so all (row, KV head) pairs step together."""
    B, Hq, _, D = q.shape
    _, _, Hkv, S, _ = cache_k.shape
    G = Hq // Hkv
    R, n_chunks = tdec.run_chunks(B, Hkv, S), tdec.n_chunks(S)
    scale_log2 = torch.tensor(D**-0.5 * 1.4426950408889634, dtype=torch.float32)
    qs = q[:, :, 0].float().reshape(B, Hkv, G, D) * scale_log2
    k, v = cache_k[layer].float(), cache_v[layer].float()  # (B, Hkv, S, D)
    ok = (valid != 0)[:, None, None, :]
    empty = (torch.full((B, Hkv, G), NINF), torch.zeros(B, Hkv, G), torch.zeros(B, Hkv, G, D))
    runs = []
    for c0 in range(0, n_chunks, R):
        warps = [empty] * 4
        for c in range(c0, min(n_chunks, c0 + R)):
            for w in range(4):
                ks = slice(tdec.CHUNK * c + 16 * w, min(tdec.CHUNK * c + 16 * w + 16, S))
                if ks.start < S:
                    warps[w] = _warp_step(warps[w], qs, k[:, :, ks], v[:, :, ks], ok[..., ks])
        runs.append(_merge_states(warps))
    return _finish(_merge_states(runs)).reshape(B, Hq, 1, D).to(q.dtype)


def _decode_mask(B, S, rng):
    """Validity rows cycling through a full row, a ragged one (left padding
    and an unwritten tail), a single key, an empty row, random flags, and
    valid keys only between dead 64-key chunks at the head and the tail."""
    valid = np.zeros((B, S), np.int32)
    for b in range(B):
        kind = b % 6
        if kind == 0:
            valid[b] = 1
        elif kind == 1:
            valid[b, S // 7:S - S // 9] = 1
        elif kind == 2:
            valid[b, S // 2] = 1
        elif kind == 4:
            valid[b] = rng.integers(0, 2, S)
        elif kind == 5:
            valid[b, min(130, S // 3):max(S - 140, S // 3 + 1)] = 1
    return valid


DECODE_CPU_CASES = {
    # name: (B, Hkv, S): the CLI (runs of 2), the 8b batch (runs of 8), a
    # long row at batch 1 (runs of 4), ragged S (runs of 1)
    "cli_b1_s4608": (1, 8, 4608),
    "8b_b4_s3840": (4, 8, 3840),
    "long_b1_s8192": (1, 8, 8192),
    "s300_b6": (6, 2, 300),
    "s3_b3": (3, 2, 3),
}


def _decode_cpu_case(case):
    B, Hkv, S = DECODE_CPU_CASES[case]
    rng = np.random.default_rng(S + B)
    D = 128
    q = rng.standard_normal((B, 4 * Hkv, 1, D), dtype=np.float32)
    ck = rng.standard_normal((1, B, Hkv, S, D), dtype=np.float32)
    cv = rng.standard_normal((1, B, Hkv, S, D), dtype=np.float32)
    valid = _decode_mask(B, S, rng)
    if B == 1:  # a page row mid-decode: left padding and the unwritten tail
        valid[0] = 0
        valid[0, 414:S - 512] = 1
    return q, ck, cv, valid


@pytest.mark.parametrize("case", sorted(DECODE_CPU_CASES))
def test_decode_runs_order_matches_jax(jx, case):
    """The new kernel's summation order (runs of chunks, four warps' online
    softmaxes) against JAX flash_decode run as its own tests run it on the
    CPU, and against the plain version. A row with no valid key gives zeros,
    as the plain version and every kernel of the port do; the JAX kernel's
    finite -1e30 mask gives such a row the mean of all its values, so it is
    compared on the rows that hold a valid key."""
    q, ck, cv, valid = _decode_cpu_case(case)
    got = decode_runs(*(torch.from_numpy(a) for a in (q, ck, cv)), 0, torch.from_numpy(valid))
    want = np.asarray(jx.dec.flash_decode(
        jx.jnp.asarray(q), jx.jnp.asarray(ck), jx.jnp.asarray(cv), jx.jnp.int32(0),
        jx.jnp.asarray(valid), interpret=True))
    empty = valid.sum(-1) == 0
    np.testing.assert_allclose(_np(got)[~empty], want[~empty], atol=1e-5)
    plain = tdec.flash_decode_reference(*(torch.from_numpy(a) for a in (q, ck, cv)), 0,
                                        torch.from_numpy(valid))
    np.testing.assert_allclose(_np(got), _np(plain), atol=1e-5)
    assert empty.any() == (q.shape[0] > 3) and not _np(got)[empty].any()


@pytest.mark.parametrize("B,S,want", [(4, 3840, 8), (4, 3648, 8), (1, 4608, 2), (1, 3712, 2),
                                      (1, 8192, 4), (2, 512, 1), (8, 4096, 8), (3, 300, 1),
                                      (1, 3, 1), (1, 32768, 8)])
def test_decode_run_rule_covers_every_chunk_once(B, S, want):
    """The run length is a power of two up to MAX_RUN, a function of (B, Hkv,
    S) alone; the runs cover every chunk of a row exactly once, and a shorter
    run is taken only while the grid still holds TARGET_BLOCKS blocks."""
    Hkv = 8
    R = tdec.run_chunks(B, Hkv, S)
    assert R == want and R & (R - 1) == 0 and 1 <= R <= tdec.MAX_RUN
    n = tdec.n_chunks(S)
    runs = [list(range(c0, min(n, c0 + R))) for c0 in range(0, n, R)]
    assert sorted(c for run in runs for c in run) == list(range(n))
    assert R == 1 or B * Hkv * len(runs) >= tdec.TARGET_BLOCKS
    assert R == tdec.MAX_RUN or B * Hkv * -(-n // (2 * R)) < tdec.TARGET_BLOCKS


PAGED_CPU_CASES = {
    # name: (page, P, spans); dead entries point outside the pool in the "wild" ones
    "partial_dead_empty": (128, 8, [(17, 300), (0, 0), (0, 1), (127, 129)]),
    "runs_end_mid_table_wild": (128, 7, [(0, 896), (130, 700), (0, 0)]),
    "page_16_wild": (16, 9, [(3, 50), (0, 144), (15, 17)]),
    "page_64": (64, 6, [(0, 384), (70, 200), (0, 0), (63, 65)]),
}


def _paged_cpu_case(case, L=2):
    page, P, spans = PAGED_CPU_CASES[case]
    q, kpool, vpool, table, valid = _paged_case(np.random.default_rng(len(case)), "cpu", page, P,
                                                spans, L=L)
    q, kpool, vpool = q[:, :8], kpool[:, :, :2], vpool[:, :, :2]  # Hkv = 2, G = 4
    if case.endswith("wild"):
        table = _out_of_pool(table, valid, kpool.shape[1])
    return q.contiguous(), kpool.contiguous(), vpool.contiguous(), table, valid


@pytest.mark.parametrize("case", sorted(PAGED_CPU_CASES))
def test_paged_runs_order_matches_plain(case):
    q, kpool, vpool, table, valid = _paged_cpu_case(case)
    got = paged_runs(q, kpool, vpool, 1, table, valid)
    want = tpaged.paged_flash_decode_reference(q.float(), kpool, vpool, 1, table, valid)
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["paged_flash_decode"]
    for b, (lo, hi) in enumerate(PAGED_CPU_CASES[case][2]):
        if hi == lo:
            assert got[b].abs().max().item() == 0  # an empty slot gives zeros


def test_paged_runs_dead_entries_change_no_bit():
    q, kpool, vpool, table, valid = _paged_cpu_case("partial_dead_empty")
    base = paged_runs(q, kpool, vpool, 0, table, valid)
    assert torch.equal(paged_runs(q, kpool, vpool, 0, _out_of_pool(table, valid, 10**6), valid),
                       base)
    moved = table.clone()
    moved[valid.sum(-1) == 0] = table[0, 0]  # every dead entry onto one live page
    assert torch.equal(paged_runs(q, kpool, vpool, 0, moved, valid), base)


@pytest.mark.parametrize("case,drop", [("partial_dead_empty", (0, 1)),
                                       ("runs_end_mid_table_wild", (1, 5))])
def test_paged_runs_dropped_live_page_fails_the_check(case, drop):
    q, kpool, vpool, table, valid = _paged_cpu_case(case)
    want = tpaged.paged_flash_decode_reference(q.float(), kpool, vpool, 1, table, valid)
    got = paged_runs(q, kpool, vpool, 1, table, valid, drop=drop)
    assert tolerance.excess_error(got, want) > 10 * tolerance.ATOL["paged_flash_decode"]


# ------------------------------------------------------------ CUDA kernels


def _bf16(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("S,H,D", [(1025, 16, 64), (257, 8, 32), (70, 4, 64)] + [
    (S, 4, D) for D in (32, 64) for S in (1, 15, 63, 65, 129)  # around the 64-row tiles
])
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
@pytest.mark.parametrize("Sq,q_off,pad", [(37, 29, False), (37, 29, True), (1, 100, False),
                                         (203, 53, True)])
def test_cuda_flash_ragged_gqa_q_offset(cuda, Sq, q_off, pad):
    """G = 4 with Sq not a multiple of the 16 positions a warp holds, keys
    past the queries (Sk = Sq + q_offset), with and without left padding."""
    rng = np.random.default_rng(Sq + q_off)
    B, Hkv, G, D = 2, 2, 4, 128
    Sk = Sq + q_off
    q = _bf16(rng, (B, Hkv * G, Sq, D), cuda)
    k = _bf16(rng, (B, Hkv, Sk, D), cuda)
    v = _bf16(rng, (B, Hkv, Sk, D), cuda)
    kw = {}
    if pad:
        ks = torch.from_numpy(_left_pad_segments(B, Sk, (0, Sk // 3))).to(cuda)
        kw = dict(q_segment_ids=ks[:, q_off:].contiguous(), kv_segment_ids=ks)
    got = tattn.flash_attention(q, k, v, causal=True, q_offset=q_off, **kw)
    torch.cuda.synchronize()
    want = tattn.attention_reference(q.float(), k.float(), v.float(), causal=True,
                                     q_offset=q_off, **kw)
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["flash_attention"]


@pytest.mark.cuda
@pytest.mark.parametrize("G,D", [(4, 128), (1, 64)])
def test_cuda_flash_batch_of_padding_rows(cuda, G, D):
    """Every row of the batch is padding (segment -1 throughout) but one."""
    rng = np.random.default_rng(G + D)
    B, Hkv, S = 3, 2, 150
    q = _bf16(rng, (B, Hkv * G, S, D), cuda)
    k = _bf16(rng, (B, Hkv, S, D), cuda)
    v = _bf16(rng, (B, Hkv, S, D), cuda)
    seg = torch.full((B, S), -1, dtype=torch.int32, device=cuda)
    seg[1, 40:] = 0
    got = tattn.flash_attention(q, k, v, causal=True, q_segment_ids=seg, kv_segment_ids=seg)
    torch.cuda.synchronize()
    want = tattn.attention_reference(q.float(), k.float(), v.float(), causal=True,
                                     q_segment_ids=seg, kv_segment_ids=seg)
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["flash_attention"]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["vit_d64", "vit_d32", "prefill"])
def test_cuda_forward_attention_bits_repeat(cuda, kernel):
    """Two runs of a kernel on the same inputs give the same bits."""
    rng = np.random.default_rng(5)
    if kernel == "prefill":
        q = _bf16(rng, (2, 8, 300, 128), cuda)
        k, v = (_bf16(rng, (2, 2, 300, 128), cuda) for _ in range(2))
        seg = torch.from_numpy(_left_pad_segments(2, 300, (0, 77))).to(cuda)
        run = lambda: tattn.flash_attention(q, k, v, causal=True, q_segment_ids=seg,
                                            kv_segment_ids=seg)
    else:
        H, D = (16, 64) if kernel == "vit_d64" else (8, 32)
        qkv = _bf16(rng, (3, 257, 3 * H * D), cuda)
        run = lambda: tvit.attention_from_packed_qkv_nomax(qkv, H)
    first = run()
    second = run()
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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


# (B, S, L, layer): the shapes the CUDA-core kernel was held to, the 8b batch,
# the CLI's batch 1 over 4,608 slots, and a row of 3 keys
DECODE_CASES = [(4, 3840, 8, 7), (4, 3648, 8, 0), (2, 512, 4, 3), (3, 300, 2, 1), (8, 4096, 2, 1),
                (4, 3840, 32, 31), (1, 4608, 2, 1), (6, 3, 2, 0)]


def _decode_inputs(B, S, L, device):
    rng = np.random.default_rng(B * S + L)
    Hq, Hkv, D = 32, 8, 128
    q = _bf16(rng, (B, Hq, 1, D), device)
    ck = _bf16(rng, (L, B, Hkv, S, D), device)
    cv = _bf16(rng, (L, B, Hkv, S, D), device)
    valid = _decode_mask(B, S, rng)
    if B == 1:  # the CLI row mid-page: left padding, the unwritten tail
        valid[0] = 0
        valid[0, 414:4096] = 1
    return q, ck, cv, torch.from_numpy(valid).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,L,layer", DECODE_CASES)
def test_cuda_decode_matches_plain(cuda, B, S, L, layer):
    """Full, ragged, single-key, empty and random rows, and rows whose head
    and tail chunks are dead, within ATOL of the plain version; an empty row
    is zeros; 20 launches on the same inputs give the same bits (the ring's
    stages are refilled only after their reads: the proxy fence)."""
    q, ck, cv, valid = _decode_inputs(B, S, L, cuda)
    before = tdec.KERNEL.launches
    got = tdec.flash_decode(q, ck, cv, layer, valid)
    torch.cuda.synchronize()
    want = tdec.flash_decode_reference(q.float(), ck.float(), cv.float(), layer, valid)
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["flash_decode"]
    assert not got[valid.sum(-1) == 0].any() and got[0].abs().max().item() > 0
    for _ in range(19):
        assert torch.equal(tdec.flash_decode(q, ck, cv, layer, valid), got)
    assert tdec.KERNEL.launches == before + 20


@pytest.fixture(scope="module")
def single_file_decode(tmp_path_factory):
    """The CUDA-core decode kernel of PRs 1-9, built from
    tests/data/flash_decode_single_file.cu -> launch(q, ck, cv, layer, valid)."""
    import ctypes
    import subprocess
    from pathlib import Path

    from callireader_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    src = Path(__file__).parent / "data" / "flash_decode_single_file.cu"
    so = tmp_path_factory.mktemp("single_file_decode") / "flash_decode_single_file.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).flash_decode_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    chunk = 128  # keys a block of that kernel's first pass

    def launch(q, ck, cv, layer, valid):
        B, Hq, _, D = q.shape
        _, _, Hkv, S, _ = ck.shape
        nc = -(-S // chunk)
        part_acc = torch.empty((B, Hq, nc, D), dtype=torch.float32, device=q.device)
        part_ml = torch.empty((B, Hq, nc, 2), dtype=torch.float32, device=q.device)
        out = torch.empty_like(q)
        rc = fn(q.data_ptr(), ck.data_ptr(), cv.data_ptr(), valid.data_ptr(), part_acc.data_ptr(),
                part_ml.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, D, layer, nc, D ** -0.5,
                torch.cuda.current_stream().cuda_stream)
        assert rc == 0
        return out

    return launch


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,L,layer", DECODE_CASES)
def test_cuda_decode_bitwise_equals_single_file_source(cuda, single_file_decode, B, S, L, layer):
    """The run kernel sums in another order than the CUDA-core kernel it
    replaced (kept as tests/data/flash_decode_single_file.cu), so the two are
    no longer bit-equal: each output is its fp32 value rounded to bf16 once,
    so they stand within both roundings plus ATOL of each other, and both
    are zeros on the same empty rows."""
    q, ck, cv, valid = _decode_inputs(B, S, L, cuda)
    got = tdec.flash_decode(q, ck, cv, layer, valid).float()
    old = single_file_decode(q, ck, cv, layer, valid).float()
    torch.cuda.synchronize()
    excess = (got - old).abs() - tolerance.BF16_ROUNDING * (got.abs() + old.abs())
    assert excess.max().item() <= tolerance.ATOL["flash_decode"]
    assert torch.equal(got[valid.sum(-1) == 0], old[valid.sum(-1) == 0])


def _paged_case(rng, device, page, P, spans, L=3):
    """Pools, a scattered page table (dead entries point at page 0 or at
    another slot's live page) and the validity of ``spans`` = per-slot
    (start, end) token ranges; an empty range is an empty slot."""
    B, Hq, Hkv, D = len(spans), 32, 8, 128
    NP = 3 + sum(-(-hi // page) for _, hi in spans)
    q = _bf16(rng, (B, Hq, 1, D), device)
    kpool = _bf16(rng, (L, NP, Hkv, page, D), device)
    vpool = _bf16(rng, (L, NP, Hkv, page, D), device)
    perm = rng.permutation(np.arange(1, NP))
    table = np.zeros((B, P), np.int32)
    valid = np.zeros((B, P * page), np.int32)
    used = 0
    for b, (lo, hi) in enumerate(spans):
        n = -(-hi // page)
        table[b, :n] = perm[used:used + n]
        table[b, n:] = perm[0] if b % 2 else 0
        used += n
        valid[b, lo:hi] = 1
    valid = valid.reshape(B, P, page)
    return q, kpool, vpool, torch.from_numpy(table).to(device), torch.from_numpy(valid).to(device)


def _out_of_pool(table, valid, NP):
    """``table`` with every entry that holds no valid key pointing outside a
    pool of NP pages: past its end, or below 0."""
    far = torch.full_like(table, NP + 7)
    far[:, 1::2] = -1
    return torch.where(valid.sum(-1) == 0, far, table)


PAGED_CASES = {
    # name: (page, P, spans); the dead entries of a "wild" case point outside the pool
    "path_shape": (128, 32, [(0, 3585), (100, 3700), (0, 3840), (3583, 3584), (5, 129), (0, 128),
                             (0, 4096), (2000, 2300)]),
    "partial_dead_empty": (128, 8, [(17, 300), (0, 0), (0, 1), (127, 129)]),
    "page_64": (64, 6, [(0, 384), (70, 200), (0, 0), (63, 65)]),
    "page_16": (16, 5, [(3, 50), (0, 80), (15, 17)]),
    "runs_end_mid_table_wild": (128, 7, [(0, 896), (130, 700), (0, 0), (5, 6)]),
    "page_16_wild": (16, 9, [(3, 50), (0, 144), (15, 17), (0, 0)]),
    "path_shape_wild": (128, 30, [(0, 3585), (100, 3700), (0, 0), (3583, 3584), (1, 2)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PAGED_CASES))
def test_cuda_paged_decode_matches_plain(cuda, case):
    page, P, spans = PAGED_CASES[case]
    rng = np.random.default_rng(len(case))
    q, kpool, vpool, table, valid = _paged_case(rng, cuda, page, P, spans)
    if case.endswith("wild"):
        table = _out_of_pool(table, valid, kpool.shape[1])
    before = tpaged.KERNEL.launches
    for layer in (0, 2):
        got = tpaged.paged_flash_decode(q, kpool, vpool, layer, table, valid)
        torch.cuda.synchronize()
        want = tpaged.paged_flash_decode_reference(q.float(), kpool, vpool, layer, table, valid)
        assert tolerance.excess_error(got, want) <= tolerance.ATOL["paged_flash_decode"]
        for b, (lo, hi) in enumerate(spans):
            if hi == lo:
                assert got[b].abs().max().item() == 0  # an empty slot gives zeros
    assert tpaged.KERNEL.launches == before + 2


@pytest.mark.cuda
def test_cuda_paged_decode_never_reads_dead_entries(cuda):
    """Dead table entries may point anywhere, outside the pool too."""
    page, P, spans = PAGED_CASES["partial_dead_empty"]
    rng = np.random.default_rng(3)
    q, kpool, vpool, table, valid = _paged_case(rng, cuda, page, P, spans)
    base = tpaged.paged_flash_decode(q, kpool, vpool, 1, table, valid)
    wild = table.clone()
    wild[(valid.sum(-1) == 0)] = 10**6
    assert torch.equal(tpaged.paged_flash_decode(q, kpool, vpool, 1, wild, valid), base)


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
    q1 = torch.zeros((1, 32, 1, 128), dtype=torch.bfloat16, device=cuda)
    table = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    for page in (24, 256):  # no multiple of 16; more than one thread per key allows
        pool = torch.zeros((1, 3, 8, page, 128), dtype=torch.bfloat16, device=cuda)
        ok = torch.ones((1, 2, page), dtype=torch.int32, device=cuda)
        with pytest.raises(ValueError, match="page size"):
            tpaged.paged_flash_decode(q1, pool, pool, 0, table, ok)
    pool = torch.zeros((1, 3, 8, 128, 128), dtype=torch.bfloat16, device=cuda)
    ok = torch.ones((1, 2, 128), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        tpaged.paged_flash_decode(q1, pool, pool, 1, table, ok)  # layer out of range
    with pytest.raises(ValueError):
        tpaged.paged_flash_decode(q1, pool, pool, 0, table.cpu(), ok)
    with pytest.raises(ValueError):
        tpaged.paged_flash_decode(q1.float(), pool, pool, 0, table, ok)


# ------------------------------------------------------- int8 products (card)


def _int8(rng, shape, device):
    return torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8)).to(device)


def _scales(rng, n, device):
    return torch.from_numpy((rng.random(n) * 1e-3 + 1e-4).astype(np.float32)).to(device)


_KN_WEIGHTS = {}


def _kn_weight(K, N, device):
    """One seeded (K, N) weight and its scales per shape, kept for the module
    (the largest, 14336 x 28672, is 411 MB)."""
    if (K, N) not in _KN_WEIGHTS:
        rng = np.random.default_rng(K + N)
        _KN_WEIGHTS[K, N] = (_int8(rng, (K, N), device), _scales(rng, N, device))
    return _KN_WEIGHTS[K, N]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 9, 17, 32])
@pytest.mark.parametrize("K,N", [(K, N) for K in (4096, 14336) for N in (1024, 4096, 28672)]
                         + [(4096, 6144), (256, 128), (1024, 768)])
def test_cuda_int8_matmul_matches_plain(cuda, M, K, N):
    rng = np.random.default_rng(M + K)
    q, s = _kn_weight(K, N, cuda)
    h = _bf16(rng, (M, K), cuda)
    got = ti8.int8_matmul(h, q, s)
    torch.cuda.synchronize()
    with exact_fp32():
        want = ti8.int8_matmul_reference(h.float(), q, s)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["int8_matmul"]


_NT_WEIGHTS = {}


def _nt_weight(K, N, device):
    """One seeded (N, K) weight and its scales per shape, kept for the
    module (the LM head's is 380 MB)."""
    if (K, N) not in _NT_WEIGHTS:
        _NT_WEIGHTS.clear()
        rng = np.random.default_rng(K + N)
        _NT_WEIGHTS[K, N] = (_int8(rng, (N, K), device), _scales(rng, N, device))
    return _NT_WEIGHTS[K, N]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 3, 5, 8, 9, 17, 32])
@pytest.mark.parametrize("K", [128, 4096])
@pytest.mark.parametrize("N", [128, 92672])
def test_cuda_int8_matmul_nt_matches_plain(cuda, M, K, N):
    rng = np.random.default_rng(M + N)
    q, s = _nt_weight(K, N, cuda)
    h = _bf16(rng, (M, K), cuda)
    got = ti8.int8_matmul_nt(h, q, s)
    torch.cuda.synchronize()
    with exact_fp32():
        want = ti8.int8_matmul_nt_reference(h.float(), q, s)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert tolerance.excess_error(got, want) <= tolerance.ATOL["int8_matmul_nt"]


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 32])
def test_cuda_int8_matmul_nt_rows_do_not_depend_on_m(cuda, M):
    """Each row of an M-row launch equals, bit for bit, the same row launched
    alone: a request's logits do not depend on its batch."""
    rng = np.random.default_rng(M)
    q, s = _nt_weight(4096, 92672, cuda)
    h = _bf16(rng, (M, 4096), cuda)
    together = ti8.int8_matmul_nt(h, q, s)
    for m in range(M):
        assert torch.equal(together[m:m + 1], ti8.int8_matmul_nt(h[m:m + 1].contiguous(), q, s)), m


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 32])
@pytest.mark.parametrize("K,N", [(4096, 28672), (14336, 4096)], ids=["w13", "w2"])
def test_cuda_int8_matmul_rows_do_not_depend_on_m(cuda, M, K, N):
    """Each row of an M-row (K, N) launch equals, bit for bit, the same row
    launched alone."""
    rng = np.random.default_rng(M + K)
    q, s = _kn_weight(K, N, cuda)
    h = _bf16(rng, (M, K), cuda)
    together = ti8.int8_matmul(h, q, s)
    for m in range(M):
        assert torch.equal(together[m:m + 1], ti8.int8_matmul(h[m:m + 1].contiguous(), q, s)), m


@pytest.mark.cuda
def test_cuda_kn_and_paged_kernels_use_tensor_cores_and_copy_engines(cuda):
    """The (K, N) kernel's SASS, for each of its three row counts, holds
    tensor-core products (HMMA) and TMA loads (UTMALDG); the paged kernel's
    holds bulk copies (UBLKCP). The wrappers' split rule and run length,
    which the CPU emulations follow, are the kernels'."""
    from callireader_tpu_torch.kernels import _build

    kn = [body for name, body in _build.sass_functions("int8_matmul").items()
          if "kn_kernel" in name]
    assert len(kn) == 3, "one instantiation for each of 8, 16 and 32 rows of h"
    assert all("HMMA" in body and "UTMALDG" in body for body in kn)
    paged = [body for name, body in _build.sass_functions("paged_decode").items()
             if "paged_kernel" in name]
    assert len(paged) == 1 and "UBLKCP" in paged[0]
    assert _build.load_library("paged_decode").paged_decode_run() == tpaged.RUN
    splits = _build.load_library("int8_matmul").int8_matmul_kn_splits
    for K in (128, 1024, 2048, 4096, 8192, 8320, 14336, 28672):
        assert splits(K) == ti8.kn_splits(K), K


@pytest.mark.cuda
def test_cuda_decode_kernel_uses_bulk_copies(cuda):
    """The contiguous decode kernel's SASS holds bulk copies (UBLKCP); its
    chunk and longest run, which the wrapper's run rule and the CPU
    emulation follow, are the kernel's."""
    from callireader_tpu_torch.kernels import _build

    bodies = [body for name, body in _build.sass_functions("flash_decode").items()
              if "decode_kernel" in name]
    assert len(bodies) == 1 and "UBLKCP" in bodies[0]
    lib = _build.load_library("flash_decode")
    assert (lib.flash_decode_chunk(), lib.flash_decode_max_run()) == (tdec.CHUNK, tdec.MAX_RUN)


@pytest.mark.cuda
def test_cuda_int8_matmul_nt_runs_on_tensor_cores(cuda):
    """The built library's SASS for every instantiation of the LM-head
    kernel holds tensor-core products (HMMA) and TMA loads (UTMALDG)."""
    from callireader_tpu_torch.kernels import _build

    bodies = [body for name, body in _build.sass_functions("int8_matmul").items()
              if "nt_kernel" in name]
    assert len(bodies) == 4, "one instantiation for each of 1-4 products of 8 rows"
    assert all("HMMA" in body and "UTMALDG" in body for body in bodies)


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


# ------------------------------------------------------- forward-only wrappers


def _no_backward_calls(device):
    """{wrapper: (call(inputs), inputs)} with valid kernel shapes for every
    wrapper whose kernel has no backward."""
    from callireader_tpu_torch.kernels import rmsnorm as trms

    rng = np.random.default_rng(9)
    z = lambda *shape: _bf16(rng, shape, device)  # noqa: E731
    valid = torch.ones((1, 64), dtype=torch.int32, device=device)
    table = torch.zeros((1, 1), dtype=torch.int32, device=device)
    ok = torch.ones((1, 1, 64), dtype=torch.int32, device=device)
    q8, s8 = _int8(rng, (256, 128), device), _scales(rng, 128, device)
    q8t, s8t = _int8(rng, (128, 256), device), _scales(rng, 128, device)
    return {
        "vit_attention": (lambda t: tvit.attention_from_packed_qkv_nomax(t[0], 2),
                          [z(1, 33, 3 * 2 * 32)]),
        "flash_attention": (lambda t: tattn.flash_attention(*t, causal=True),
                            [z(1, 4, 64, 128), z(1, 1, 64, 128), z(1, 1, 64, 128)]),
        "flash_decode": (lambda t: tdec.flash_decode(t[0], t[1], t[2], 0, valid),
                         [z(1, 4, 1, 128), z(1, 1, 1, 64, 128), z(1, 1, 1, 64, 128)]),
        "paged_flash_decode": (lambda t: tpaged.paged_flash_decode(t[0], t[1], t[2], 0, table, ok),
                               [z(1, 4, 1, 128), z(1, 2, 1, 64, 128), z(1, 2, 1, 64, 128)]),
        "int8_matmul": (lambda t: ti8.int8_matmul(t[0], q8, s8), [z(4, 256)]),
        "int8_matmul_nt": (lambda t: ti8.int8_matmul_nt(t[0], q8t, s8t), [z(4, 256)]),
        "rms_norm": (lambda t: trms.rms_norm(t[0], t[1], 1e-6), [z(4, 256), z(256)]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vit_attention", "flash_attention", "flash_decode",
                                  "paged_flash_decode", "int8_matmul", "int8_matmul_nt",
                                  "rms_norm"])
def test_cuda_forward_only_wrappers_refuse_inputs_that_require_grad(cuda, name):
    """A wrapper whose kernel has no backward raises on a CUDA input that
    requires grad while grad is enabled (launched, the kernel's output would
    carry no gradient); under no_grad, and on inputs that need none, it
    launches."""
    call, inputs = _no_backward_calls(cuda)[name]
    for i in range(len(inputs)):
        tracked = [t.clone().requires_grad_(j == i) for j, t in enumerate(inputs)]
        with pytest.raises(RuntimeError, match="no backward"):
            call(tracked)
        with torch.no_grad():
            assert torch.isfinite(call(tracked).float()).all()
    assert not call(inputs).requires_grad
