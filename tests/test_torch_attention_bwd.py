"""Trainable flash attention of the port (kernels/attention_bwd.py).

CPU: the autograd Function (its plain forward and FlashAttention-2 backward)
against the JAX ``flash_attention_trainable`` in interpret mode at blocks of
32, outputs and ``jax.grad`` dq / dk / dv, with the bars of
tests/test_flash_bwd.py: 2e-5 for outputs, 5e-4 for grads (fp32, summation
order only). The plain backward against torch autograd through the port's
``attention_reference``: 1e-5 (same math, fp32). The kernels' ATOLs
(kernels/tolerance.py) against what dropping one 64-key or 64-query tile
costs. A plain-torch emulation of the tensor-core backward's arithmetic
against the fp32 plain version: within ATOL with P and dS split into two
bf16 parts, more than 10x over it with each rounded once. The same for the
tensor-core forward (tools/attention_arith.py::tensor_core_loop with its lse
and its tile skip): the skip is exact (the bits of the loop that runs every
tile), the loop stands within ATOL of the plain forward, and a skip rule that
drops an attended tile fails the check.

Card (marked ``cuda``): each kernel against its plain version on the same
bf16 inputs (lengths around the 64-row tiles, right padding, packed
segments), elementwise within the output's bf16 rounding plus the kernel's
ATOL; lse (fp32 output) within 1e-4; rows that attend to nothing; rows of
many short segments (tiles skipped); packed SFT rows at B=2 S=2048 with the
8b's heads; equal bits run to run; HGMMA and UTMALDG
in the three kernels' SASS; launch counts of the LLM forward and backward with
and without remat.
"""

import types

import numpy as np
import pytest
import torch

from callireader_tpu_torch.kernels import _build
from callireader_tpu_torch.kernels import attention as tattn
from callireader_tpu_torch.kernels import attention_bwd as tbwd
from callireader_tpu_torch.kernels import tolerance
from callireader_tpu_torch.tools.attention_arith import disjoint_ids, tensor_core_loop

OUT_TOL, GRAD_TOL = 2e-5, 5e-4


@pytest.fixture(scope="module")
def jx():
    """The JAX kernel (imported here so the card-only cases of this file run
    where JAX is absent: ``pytest --noconftest -m cuda``)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from callireader_tpu.kernels.attention_bwd import flash_attention_trainable

    return types.SimpleNamespace(jax=jax, jnp=jnp, fat=flash_attention_trainable)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _weights(shape):
    """The cotangent of tests/test_flash_bwd.py: loss = sum(out * cos(i))."""
    return np.cos(np.arange(int(np.prod(shape)), dtype=np.float32)).reshape(shape)


def _jax_out_grads(jx, q, k, v, qseg, kseg, causal):
    jnp = jx.jnp
    segs = (None, None) if qseg is None else (jnp.asarray(qseg), jnp.asarray(kseg))

    def run(q, k, v):
        return jx.fat(q, k, v, *segs, causal, None, 32, 32, True)

    w = jnp.asarray(_weights(q.shape))
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    out = run(*args)
    grads = jx.jax.grad(lambda *a: jnp.sum(run(*a) * w), argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_out_grads(q, k, v, qseg, kseg, causal):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    segs = (None, None) if qseg is None else (torch.from_numpy(qseg), torch.from_numpy(kseg))
    out = tbwd.flash_attention_trainable(*ts, *segs, causal)
    (out * torch.from_numpy(_weights(q.shape))).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _qkv(seed, B, Hq, Hkv, S, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, S, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, S, D), dtype=np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (4, 2)])
def test_trainable_matches_jax(jx, causal, Hq, Hkv):
    q, k, v = _qkv(0, 2, Hq, Hkv, 64, 32)
    want, jgrads = _jax_out_grads(jx, q, k, v, None, None, causal)
    got, tgrads = _torch_out_grads(q, k, v, None, None, causal)
    np.testing.assert_allclose(got, want, atol=OUT_TOL, rtol=OUT_TOL)
    for a, b, name in zip(tgrads, jgrads, "qkv"):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"d{name}")


def test_trainable_segments_padding_and_empty_row_match_jax(jx):
    """Ragged right padding (-1 on both sides, as the collator pads), two
    packed segments, S = 48 (not a multiple of the JAX blocks), and one query
    whose segment id no key has. The JAX kernel writes that row's output as
    an average of V (its online softmax saw only masked keys); the port
    writes zeros and lse = -1e30. Both give the row no gradient."""
    B, Hq, Hkv, S, D = 2, 4, 2, 48, 16
    q, k, v = _qkv(1, B, Hq, Hkv, S, D)
    seg = np.full((B, S), -1, np.int32)
    seg[0, :30] = 0
    seg[1, :20], seg[1, 20:44] = 0, 1
    qseg, kseg = seg.copy(), seg.copy()
    qseg[1, 25] = 7  # attends to nothing
    want, jgrads = _jax_out_grads(jx, q, k, v, qseg, kseg, True)
    got, tgrads = _torch_out_grads(q, k, v, qseg, kseg, True)
    keep = np.ones((B, S), bool)
    keep[1, 25] = False
    np.testing.assert_allclose(got[keep[:, None, :].repeat(Hq, 1)],
                               want[keep[:, None, :].repeat(Hq, 1)], atol=OUT_TOL, rtol=OUT_TOL)
    assert np.all(got[1, :, 25] == 0)
    _, lse = tbwd.attention_fwd_lse_reference(*(torch.from_numpy(a) for a in (q, k, v)),
                                              torch.from_numpy(qseg), torch.from_numpy(kseg))
    assert torch.all(lse[1, :, 25] == tbwd.NEG_INF) and torch.all(lse[keep[:, None].repeat(Hq, 1)] > -1e3)
    for a, b, name in zip(tgrads, jgrads, "qkv"):
        np.testing.assert_allclose(a, b, atol=GRAD_TOL, rtol=GRAD_TOL, err_msg=f"d{name}")
    assert np.all(tgrads[0][1, :, 25] == 0)


@pytest.mark.parametrize("causal,G", [(True, 2), (False, 1)])
def test_plain_backward_matches_autograd(causal, G):
    """attention_bwd_reference (P recomputed from lse) against torch autograd
    through the prefill kernel's plain version, with left-padded segments."""
    B, Hkv, S, D = 2, 2, 40, 32
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv(2, B, Hkv * G, Hkv, S, D))
    seg = torch.zeros((B, S), dtype=torch.int32)
    seg[0, :9] = -1
    out = tattn.attention_reference(q, k, v, causal=causal, q_segment_ids=seg, kv_segment_ids=seg)
    do = torch.from_numpy(_weights(out.shape))
    (out * do).sum().backward()
    o, lse = tbwd.attention_fwd_lse_reference(q.detach(), k.detach(), v.detach(), seg, seg, causal)
    torch.testing.assert_close(o, out.detach(), atol=1e-5, rtol=1e-5)
    grads = tbwd.attention_bwd_reference(q.detach(), k.detach(), v.detach(), seg, seg, o, lse, do,
                                         causal)
    for got, t, name in zip(grads, (q, k, v), "qkv"):
        torch.testing.assert_close(got, t.grad, atol=1e-5, rtol=1e-5, msg=f"d{name}")


def test_tolerance_passes_rounding_and_fails_dropped_tiles():
    """Each training kernel's ATOL admits the bf16 rounding of its plain
    output but not the loss of one 64-key tile (forward, dq) or one 64-query
    tile (dk/dv), on bf16 inputs at the path's D=128, G=4."""
    B, Hq, Hkv, S, D = 1, 8, 2, 256, 128
    q, k, v = (torch.from_numpy(a).bfloat16().float() for a in _qkv(3, B, Hq, Hkv, S, D))
    do = torch.from_numpy(np.random.default_rng(4).standard_normal((B, Hq, S, D),
                                                                    dtype=np.float32))
    full = torch.zeros((B, S), dtype=torch.int32)
    cut = full.clone()
    cut[:, 64:128] = 5  # as keys: dropped for every query; as queries: see no key

    def run(qseg, kseg):
        o, lse = tbwd.attention_fwd_lse_reference(q, k, v, qseg, kseg, True)
        return (o, *tbwd.attention_bwd_reference(q, k, v, qseg, kseg, o, lse, do, True))

    want = run(full, full)
    no_keys, no_queries = run(full, cut), run(cut, full)
    for i, name, dropped in ((0, "attn_train_fwd", no_keys), (1, "attn_train_dq", no_keys),
                             (2, "attn_train_dkv", no_queries), (3, "attn_train_dkv", no_queries)):
        atol = tolerance.ATOL[name]
        assert tolerance.excess_error(want[i].bfloat16(), want[i]) <= atol
        # rows 128.. are the ones whose keys were cut (forward, dq) or the
        # keys < 128 that lost a query tile (dk, dv)
        assert tolerance.excess_error(dropped[i].bfloat16(), want[i]) > 10 * atol, name


# ------------------------------- the tensor-core backward's arithmetic (CPU check)

LOG2E = 1.4426950408889634


def _split(x, split):
    """x as the kernel feeds it to the tensor cores: bf16(x), plus
    bf16(x - bf16(x)) when ``split``; each part is its own product."""
    hi = x.bfloat16().float()
    return (hi, (x - hi).bfloat16().float()) if split else (hi,)


def tensor_core_backward(q, k, v, do, o, lse, allowed, scale, split):
    """Plain-torch emulation of the dq and dk/dv loops of
    csrc/flash_attention_bwd.cu for one KV head: 64 x 64 tiles, fp32 scores,
    P = 2^(S scale log2(e) - lse log2(e)) (0 where masked),
    dS = P (dP - rowsum(dO O)), P and dS fed to the products in bf16 (split
    into two parts or rounded once), every sum in fp32, outputs rounded to
    bf16. q/do/o (G, S, D), k/v (S, D) fp32 holding bf16 values; lse (G, S);
    allowed (S, S) bool. -> (dq, dk, dv) bf16."""
    G, S, D = q.shape
    dsum = (do * o).sum(-1)
    lse2 = torch.where(lse > tbwd.NEG_INF / 2, lse * LOG2E, torch.full_like(lse, float("inf")))
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    for q0 in range(0, S, 64):
        for k0 in range(0, S, 64):
            qs, ks = slice(q0, q0 + 64), slice(k0, k0 + 64)
            s = q[:, qs] @ k[ks].T
            p = torch.exp2(s * (scale * LOG2E) - lse2[:, qs, None])
            p = torch.where(allowed[qs, ks], p, torch.zeros_like(p))
            ds = p * (do[:, qs] @ v[ks].T - dsum[:, qs, None])
            for part in _split(ds, split):
                dq[:, qs] += part @ k[ks]
                dk[ks] += torch.einsum("gqk,gqd->kd", part, q[:, qs])
            for part in _split(p, split):
                dv[ks] += torch.einsum("gqk,gqd->kd", part, do[:, qs])
    return (dq * scale).bfloat16(), (dk * scale).bfloat16(), dv.bfloat16()


@pytest.fixture(scope="module")
def backward_loop_case():
    """G = 4, D = 128, S = 256, causal, two segments: the fp32 plain
    backward and the loop's outputs with P and dS split or rounded once."""
    rng = np.random.default_rng(41)
    G, S, D = 4, 256, 128

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16().float()

    q, do = bf16((1, G, S, D)), bf16((1, G, S, D))
    k, v = bf16((1, 1, S, D)), bf16((1, 1, S, D))
    seg = torch.zeros((1, S), dtype=torch.int32)
    seg[0, 150:] = 1
    scale = D ** -0.5
    o, lse = tbwd.attention_fwd_lse_reference(q, k, v, seg, seg, True, scale)
    o = o.bfloat16().float()  # the forward kernel's output, as the backward reads it
    want = tbwd.attention_bwd_reference(q, k, v, seg, seg, o, lse, do, True, scale)
    allowed = (seg[0, :, None] == seg[0, None, :]) & torch.ones((S, S), dtype=torch.bool).tril()
    loops = {split: tensor_core_backward(q[0], k[0, 0], v[0, 0], do[0], o[0], lse[0], allowed,
                                         scale, split) for split in (True, False)}
    return want, loops


@pytest.mark.parametrize("split", [True, False], ids=["split_p_ds", "single_bf16"])
@pytest.mark.parametrize("i,name", [(0, "attn_train_dq"), (1, "attn_train_dkv"),
                                    (2, "attn_train_dkv")], ids=["dq", "dk", "dv"])
def test_tensor_core_backward_needs_split_p_and_ds(backward_loop_case, split, i, name):
    """The backward's products take bf16 operands: with P and dS each split
    into two bf16 parts, dq, dk and dv stand within the card's tolerance of
    the fp32 plain version; with each rounded to bf16 once, every output
    misses by more than 10x."""
    want, loops = backward_loop_case
    got = loops[split][i]
    ref = want[i][0, 0] if i else want[i][0]  # (S, D) for dk, dv; (G, S, D) for dq
    excess = tolerance.excess_error(got, ref)
    if split:
        assert excess <= tolerance.ATOL[name]
    else:
        assert excess > 10 * tolerance.ATOL[name]


# ------------------------------- the tensor-core training forward (CPU check)


def _forward_loop_case(kind):
    """G = 4, D = 128, S = 320, causal: bf16 inputs, segment ids (``packed``:
    three segments a row and a -1 tail; ``right_pad``: -1 padding), the mask,
    and the fp32 plain forward (o, lse)."""
    rng = np.random.default_rng(43)
    B, G, S, D = 2, 4, 320, 128

    def bf16(shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16().float()

    q, k, v = bf16((B, G, S, D)), bf16((B, 1, S, D)), bf16((B, 1, S, D))
    seg = torch.from_numpy(_packed_segments(B, S) if kind == "packed"
                           else _right_pad_segments(B, S, (0, 150)))
    mask = (seg[:, :, None] == seg[:, None, :]) & torch.ones((S, S), dtype=torch.bool).tril()
    want = tbwd.attention_fwd_lse_reference(q, k, v, seg, seg, True, D ** -0.5)
    return q, k.expand(B, G, S, D), v.expand(B, G, S, D), seg, mask[:, None], want


@pytest.mark.parametrize("kind", ["packed", "right_pad"])
def test_training_forward_loop_skip_is_exact(kind):
    """The forward loop that skips key tiles whose id range is disjoint from
    the query tile's (the producer's rule) gives the bits of the loop that
    runs every tile, output and lse; and it skips some."""
    q, k, v, seg, mask, _ = _forward_loop_case(kind)
    scale = q.shape[-1] ** -0.5
    every = tensor_core_loop(q, k, v, scale, mask, True, with_lse=True)
    skipping = tensor_core_loop(q, k, v, scale, mask, True, ids=(seg, seg), with_lse=True)
    assert torch.equal(every[0], skipping[0]) and torch.equal(every[1], skipping[1])
    q_ids = seg.reshape(seg.shape[0], -1, 16)[:, :, None]  # (B, query tile, 1, 16)
    k_ids = seg.reshape(seg.shape[0], -1, 64)[:, None]  # (B, 1, key tile, 64)
    causal = torch.arange(0, seg.shape[1], 16)[:, None] + 16 > torch.arange(0, seg.shape[1], 64)
    skipped = disjoint_ids(q_ids.amin(-1), q_ids.amax(-1), k_ids.amin(-1), k_ids.amax(-1))
    assert (skipped & causal).any()


@pytest.mark.parametrize("kind", ["packed", "right_pad"])
def test_training_forward_loop_matches_plain(kind):
    """The tensor-core forward's arithmetic (split P, 64-key tiles, the tile
    skip) stands within the card's ATOL of the fp32 plain forward, and its
    lse within 1e-4; a row that attends to nothing gets lse -1e30."""
    q, k, v, seg, mask, (want_o, want_lse) = _forward_loop_case(kind)
    o, lse = tensor_core_loop(q, k, v, q.shape[-1] ** -0.5, mask, True, ids=(seg, seg),
                              with_lse=True)
    assert tolerance.excess_error(o, want_o) <= tolerance.ATOL["attn_train_fwd"]
    assert tolerance.max_abs_error(lse, want_lse) <= 1e-4


def test_training_forward_loop_fails_a_wrong_skip():
    """A skip rule that also drops tiles whose id range only touches the
    query tile's (a key tile ending in the queries' first id) drops attended
    pairs: the check catches it."""
    q, k, v, seg, mask, (want_o, _) = _forward_loop_case("packed")

    def touching(qmin, qmax, kmin, kmax):
        return (kmax <= qmin) | (kmin > qmax)

    o = tensor_core_loop(q, k, v, q.shape[-1] ** -0.5, mask, True, ids=(seg, seg), skip=touching)
    assert tolerance.excess_error(o, want_o) > 10 * tolerance.ATOL["attn_train_fwd"]


# ------------------------------------------------------------ CUDA kernels


def _bf16(rng, shape, device):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(device, torch.bfloat16)


def _right_pad_segments(B, S, pads):
    seg = np.zeros((B, S), np.int32)
    for b, n in enumerate(pads):
        if n:
            seg[b, S - n:] = -1
    return seg


def _kernels_vs_plain(q, k, v, do, seg, causal):
    o, lse = tbwd._launch_fwd(q, k, v, seg, seg, causal, q.shape[-1] ** -0.5)
    dq, dk, dv = tbwd._bwd(q, k, v, seg, seg, o, lse, do, causal, q.shape[-1] ** -0.5)
    torch.cuda.synchronize()
    po, plse = tbwd.attention_fwd_lse_reference(q, k, v, seg, seg, causal)
    # the plain backward from the kernel's own forward: same inputs to both
    pdq, pdk, pdv = tbwd.attention_bwd_reference(q, k, v, seg, seg, o, lse, do, causal)
    return (o, lse, dq, dk, dv), (po, plse, pdq, pdk, pdv)


def _packed_segments(B, S):
    """Rows of three packed segments (ids 0, 1, 2) and a -1 padded tail, cut
    at other fractions of S in each row, so that some 64 x 64 tiles pair
    disjoint ids (skipped whole) and others mix ids (masked)."""
    seg = np.full((B, S), -1, np.int32)
    for b, cuts in zip(range(B), ((0.3, 0.55, 0.9), (0.125, 0.5, 0.97))):
        edges = [0] + [int(f * S) for f in cuts]
        for i in range(3):
            seg[b, edges[i]:edges[i + 1]] = i
    return seg


@pytest.mark.cuda
@pytest.mark.parametrize("causal,pads,S", [
    (True, (0, 77), 300), (True, (0, 0), 128), (False, (13, 0), 200), (True, (0, 0), 1),
    # around the 64-row tiles, with the run's right padding
    (True, (0, 0), 63), (True, (0, 1), 65), (True, (0, 50), 129), (True, (7, 0), 200),
    # several segments a row and a -1 padded tail
    (True, "packed", 129), (True, "packed", 200), (True, "packed", 700), (False, "packed", 333),
])
def test_cuda_trainable_kernels_match_plain(cuda, causal, pads, S):
    rng = np.random.default_rng(S)
    B, Hkv, G, D = 2, 2, 4, 128
    q, do = _bf16(rng, (B, Hkv * G, S, D), cuda), _bf16(rng, (B, Hkv * G, S, D), cuda)
    k, v = _bf16(rng, (B, Hkv, S, D), cuda), _bf16(rng, (B, Hkv, S, D), cuda)
    if pads == "packed":
        seg = torch.from_numpy(_packed_segments(B, S)).to(cuda)
    else:
        seg = torch.from_numpy(_right_pad_segments(B, S, pads)).to(cuda) if any(pads) else None
    got, want = _kernels_vs_plain(q, k, v, do, seg, causal)
    assert tolerance.excess_error(got[0], want[0]) <= tolerance.ATOL["attn_train_fwd"]
    assert tolerance.max_abs_error(got[1], want[1]) <= 1e-4
    assert tolerance.excess_error(got[2], want[2]) <= tolerance.ATOL["attn_train_dq"]
    for i in (3, 4):
        assert tolerance.excess_error(got[i], want[i]) <= tolerance.ATOL["attn_train_dkv"]


def _sft_rows(S):
    """Two rows packed as train/sft_data.PackedTextDataset packs documents:
    seven and five documents of uneven length (1 to 1000 tokens), whose
    edges fall inside 64-key tiles, then a -1 padded tail."""
    seg = np.full((2, S), -1, np.int32)
    for b, lengths in enumerate(((150, 1, 333, 64, 700, 511, 200), (1000, 63, 65, 129, 700))):
        edges = np.cumsum((0,) + lengths)
        for i in range(len(lengths)):
            seg[b, edges[i]:edges[i + 1]] = i
    return seg


@pytest.mark.cuda
def test_cuda_trainable_kernels_on_packed_sft_rows(cuda):
    """The three training kernels at the 8b's heads (Hq 32, Hkv 8) on packed
    SFT rows at the zoo's 2k packing, B=2 S=2048: a tile that straddles two
    documents is masked (not skipped, not taken whole), a tile of one
    document that no query of the block shares is skipped."""
    S = 2048
    seg_np = _sft_rows(S)
    tiles = seg_np.reshape(2, S // 64, 64)
    assert sum(len(set(t.tolist())) > 1 for row in tiles for t in row) >= 8  # straddling tiles
    rng = np.random.default_rng(S)
    B, Hkv, G, D = 2, 8, 4, 128
    q, do = _bf16(rng, (B, Hkv * G, S, D), cuda), _bf16(rng, (B, Hkv * G, S, D), cuda)
    k, v = _bf16(rng, (B, Hkv, S, D), cuda), _bf16(rng, (B, Hkv, S, D), cuda)
    got, want = _kernels_vs_plain(q, k, v, do, torch.from_numpy(seg_np).to(cuda), True)
    assert tolerance.excess_error(got[0], want[0]) <= tolerance.ATOL["attn_train_fwd"]
    assert tolerance.max_abs_error(got[1], want[1]) <= 1e-4
    assert tolerance.excess_error(got[2], want[2]) <= tolerance.ATOL["attn_train_dq"]
    for i in (3, 4):
        assert tolerance.excess_error(got[i], want[i]) <= tolerance.ATOL["attn_train_dkv"]


@pytest.mark.cuda
def test_cuda_rows_without_keys_are_zero(cuda):
    rng = np.random.default_rng(5)
    B, Hkv, G, S, D = 1, 2, 4, 150, 128
    q, do = _bf16(rng, (B, Hkv * G, S, D), cuda), _bf16(rng, (B, Hkv * G, S, D), cuda)
    k, v = _bf16(rng, (B, Hkv, S, D), cuda), _bf16(rng, (B, Hkv, S, D), cuda)
    qs = torch.zeros((B, S), dtype=torch.int32, device=cuda)
    qs[0, 10] = qs[0, 140] = 9
    ks = torch.zeros((B, S), dtype=torch.int32, device=cuda)
    o, lse = tbwd._launch_fwd(q, k, v, qs, ks, True, D ** -0.5)
    dq, dk, dv = tbwd._bwd(q, k, v, qs, ks, o, lse, do, True, D ** -0.5)
    assert o[:, :, [10, 140]].abs().max().item() == 0
    assert torch.all(lse[:, :, [10, 140]] == tbwd.NEG_INF)
    assert dq[:, :, [10, 140]].abs().max().item() == 0
    pdq, pdk, pdv = tbwd.attention_bwd_reference(q, k, v, qs, ks, o, lse, do, True)
    assert tolerance.excess_error(dk, pdk) <= tolerance.ATOL["attn_train_dkv"]
    assert tolerance.excess_error(dv, pdv) <= tolerance.ATOL["attn_train_dkv"]


@pytest.mark.cuda
def test_cuda_backward_is_the_same_every_run(cuda):
    rng = np.random.default_rng(6)
    B, Hkv, G, S, D = 2, 2, 4, 333, 128
    q, do = _bf16(rng, (B, Hkv * G, S, D), cuda), _bf16(rng, (B, Hkv * G, S, D), cuda)
    k, v = _bf16(rng, (B, Hkv, S, D), cuda), _bf16(rng, (B, Hkv, S, D), cuda)
    o, lse = tbwd._launch_fwd(q, k, v, None, None, True, D ** -0.5)
    first = tbwd._bwd(q, k, v, None, None, o, lse, do, True, D ** -0.5)
    second = tbwd._bwd(q, k, v, None, None, o, lse, do, True, D ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_cuda_backward_kernels_run_on_tensor_cores(cuda):
    """The built library's SASS for the forward (the shared loop's LSE build,
    flash_fwd_kernel), dq_kernel and dkdv_kernel holds HGMMA (wgmma) and
    UTMALDG (TMA load) instructions."""
    functions = _build.sass_functions(tbwd.SOURCE)
    for kernel in ("flash_fwd_kernel", "dq_kernel", "dkdv_kernel"):
        bodies = [body for name, body in functions.items() if kernel in name]
        assert bodies, f"{kernel} is not in the library"
        for op in ("HGMMA", "UTMALDG"):
            assert all(op in body for body in bodies), f"{kernel} has no {op}"


@pytest.mark.cuda
def test_cuda_forward_skips_disjoint_tiles_exactly(cuda):
    """Rows packed with many short segments (20-150 tokens) and a -1 tail:
    most causal key tiles share no id with the query tile and the producer
    skips them. The kernel stands within ATOL of the plain version, lse
    within 1e-4, and two runs give the same bits."""
    rng = np.random.default_rng(9)
    B, Hkv, G, S, D = 2, 2, 4, 1024, 128
    q = _bf16(rng, (B, Hkv * G, S, D), cuda)
    k, v = _bf16(rng, (B, Hkv, S, D), cuda), _bf16(rng, (B, Hkv, S, D), cuda)
    seg = np.full((B, S), -1, np.int32)
    for b in range(B):
        pos, sid = 0, 0
        while pos < S - 100:
            n = int(rng.integers(20, 151))
            seg[b, pos:pos + n] = sid
            pos, sid = pos + n, sid + 1
    seg = torch.from_numpy(seg).to(cuda)
    o, lse = tbwd._launch_fwd(q, k, v, seg, seg, True, D ** -0.5)
    o2, lse2 = tbwd._launch_fwd(q, k, v, seg, seg, True, D ** -0.5)
    torch.cuda.synchronize()
    po, plse = tbwd.attention_fwd_lse_reference(q, k, v, seg, seg, True)
    assert tolerance.excess_error(o, po) <= tolerance.ATOL["attn_train_fwd"]
    assert tolerance.max_abs_error(lse, plse) <= 1e-4
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


@pytest.mark.cuda
def test_cuda_trainable_refuses_bad_input(cuda):
    q = torch.zeros((1, 4, 8, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        tbwd.flash_attention_trainable(q, q[:, :1], q[:, :1])  # D=64 is not instantiated
    q = torch.zeros((1, 8, 8, 128), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        tbwd.flash_attention_trainable(q, q[:, :4], q[:, :4])  # G=2 is not instantiated
    with pytest.raises(ValueError):
        tbwd.flash_attention_trainable(q.float(), q[:, :2].float(), q[:, :2].float())
    seg = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tbwd.flash_attention_trainable(q, q[:, :2].contiguous(), q[:, :2].contiguous(), seg, seg)


@pytest.mark.cuda
@pytest.mark.parametrize("remat", [True, False])
def test_cuda_launch_counts_of_the_llm_forward_and_backward(cuda, remat):
    """An LLM of the path's head shape (D=128, G=4): each layer launches the
    forward kernel once (twice under remat: the backward recomputes it) and
    dq and dk/dv once each in the backward."""
    import dataclasses

    from callireader_tpu_torch.core.config import callireader_tiny
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime.weights import _Init, init_llm

    cfg = dataclasses.replace(callireader_tiny().llm, hidden_size=512, num_attention_heads=4,
                              num_key_value_heads=1, num_hidden_layers=3)
    params = init_llm(_Init(torch.Generator(device=cuda).manual_seed(0), cuda, torch.bfloat16), cfg)
    wq = params["layers"]["wq"].requires_grad_(True)
    ids = torch.randint(0, cfg.vocab_size, (2, 96), device=cuda)
    seg = torch.zeros((2, 96), dtype=torch.int32, device=cuda)
    seg[1, 70:] = -1
    for kern in (tbwd.KERNEL_FWD, tbwd.KERNEL_DQ, tbwd.KERNEL_DKV):
        kern.launches = 0
    logits = internlm2.forward(params, cfg, input_ids=ids, segment_ids=seg, remat=remat)
    logits.float().square().mean().backward()
    torch.cuda.synchronize()
    L = cfg.num_hidden_layers
    assert (tbwd.KERNEL_FWD.launches, tbwd.KERNEL_DQ.launches, tbwd.KERNEL_DKV.launches) == \
        ((2 if remat else 1) * L, L, L)
    assert torch.isfinite(wq.grad.float()).all() and wq.grad.abs().sum() > 0
