"""The decode token's RoPE and KV-cache write (kernels/rope_kv.py).

CPU: the wrapper's plain form against the decode step's earlier sixteen-op
form (fp32 rotate-half RoPE of q and k, then the indexed cache writes each
decode route made: ``index_copy_`` at one slot, per-row lengths, page id and
offset), bit for bit, over fused and separate q/k/v views, the whole model's
heads and a tensor-parallel rank's, and bf16 / fp32 activations and caches;
then the three decode routes (``decode_step_at``, ``decode_step_multislot``,
the paged ``_decode``) pass each layer one destination the kernel takes and
give the logits and caches of that earlier form. The routes' agreement with
the JAX package stays with their own tests (test_torch_decode_graph.py,
test_torch_serving.py, test_torch_paged.py).

Card (marked ``cuda``; ``pytest --noconftest -m cuda tests/test_torch_rope_kv.py``):
the CUDA kernel against the plain form, bitwise, at the 8b decode shape
(B=8, Hq=32, Hkv=8, D=128, a 3840-slot cache written near its end), at the
contiguous server's per-row lengths and at the serve shape's page pools,
eager and inside a CUDA graph; its refusals.
"""

import functools
import types

import pytest
import torch

from callireader_tpu_torch.core.config import LLMConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY
from callireader_tpu_torch.kernels import rope_kv as k
from callireader_tpu_torch.models import internlm2


def _rope_before(x, cos, sin):
    """The model's RoPE as the decode step ran it before the kernel."""
    cos = cos[:, None].float()
    sin = sin[:, None].float()
    xf = x.float()
    half = x.shape[-1] // 2
    rotated = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rotated * sin).to(x.dtype)


def _write_before(dest, cache_k, cache_v, k_, v_, rows, pos):
    """The three routes' earlier cache writes of k_, v_ (B, Hkv, D)."""
    if dest == "slot":  # decode_step_at: every row at one slot
        cache_k.index_copy_(2, pos[:1], k_[:, :, None].to(cache_k.dtype))
        cache_v.index_copy_(2, pos[:1], v_[:, :, None].to(cache_v.dtype))
    else:  # decode_step_multislot (rows 0..B-1), the paged pools (page ids)
        cache_k[rows, :, pos] = k_.to(cache_k.dtype)
        cache_v[rows, :, pos] = v_.to(cache_v.dtype)


def _destination(dest, B, T, gen):
    """-> (N rows of the cache, rows, pos, RoPE positions (B, 1)) as the
    route makes them."""
    if dest == "slot":
        slot = torch.tensor([T - 2])
        return B, torch.arange(B), slot.expand(B), slot.view(1, 1).expand(B, 1)
    if dest == "lengths":
        lengths = torch.randint(0, T, (B,), generator=gen)
        starts = torch.minimum(lengths, torch.randint(0, 4, (B,), generator=gen))
        return B, torch.arange(B), lengths, (lengths - starts)[:, None]
    # paged: 5 pages of T slots, the inactive rows 2 and 3 on the trash page 0
    page = torch.randint(1, 5, (B,), generator=gen)
    off = torch.randint(0, T, (B,), generator=gen)
    page[2:4], off[2:4] = 0, 0
    return 5, page, off, (page * T + off)[:, None]


def _qkv(fused, B, Hq, Hkv, D, dtype, gen):
    """q (B, Hq, 1, D), k, v (B, Hkv, 1, D) laid out as internlm2._qkv
    leaves them: views of one fused product, or three separate products."""
    def proj(n):
        return torch.randn((B, 1, n), generator=gen).mul(3).to(dtype)

    if fused:
        q, k_, v = torch.split(proj((Hq + 2 * Hkv) * D), [Hq * D, Hkv * D, Hkv * D], dim=-1)
    else:
        q, k_, v = proj(Hq * D), proj(Hkv * D), proj(Hkv * D)
    return [t.reshape(B, 1, -1, D).transpose(1, 2) for t in (q, k_, v)]


DTYPE_PAIRS = [(torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
               (torch.float32, torch.bfloat16), (torch.float32, torch.float32)]


@pytest.mark.parametrize("heads", ["model", "tp_rank"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "separate"])
@pytest.mark.parametrize("dest", ["slot", "lengths", "paged"])
def test_plain_form_equals_the_earlier_writes(dest, fused, heads):
    """q and both caches bit for bit as the earlier apply_rope + write_kv
    left them, for every activation / cache dtype pair; the arguments pass
    the kernel's checks."""
    gen = torch.Generator().manual_seed(7)
    cfg = LLMConfig(hidden_size=256, num_attention_heads=8, num_key_value_heads=2)
    t = 2 if heads == "tp_rank" else 1  # a rank of tensor=2 holds half the heads
    B, Hq, Hkv, D, T = 6, cfg.num_attention_heads // t, cfg.num_key_value_heads // t, 32, 16
    for x_dtype, c_dtype in DTYPE_PAIRS:
        q, k_, v = _qkv(fused, B, Hq, Hkv, D, x_dtype, gen)
        N, rows, pos, positions = _destination(dest, B, T, gen)
        cos, sin = internlm2.cos_sin_for(cfg, positions, T * N)
        caches = torch.randn((2, N, Hkv, T, D), generator=gen).to(c_dtype)
        before = caches.clone()
        assert k._check(q, k_, v, cos, sin, caches[0], caches[1], rows, pos) == (
            k.DTYPES[x_dtype], k.DTYPES[c_dtype])
        q_out = k.rope_kv(q, k_, v, cos, sin, caches[0], caches[1], rows, pos)
        q_before = _rope_before(q, cos, sin).contiguous()
        _write_before(dest, before[0], before[1], _rope_before(k_, cos, sin)[:, :, 0],
                      v[:, :, 0], rows, pos)
        assert q_out.is_contiguous() and q_out.dtype == x_dtype
        assert torch.equal(q_out, q_before)
        assert torch.equal(caches, before)


TINY = dict(vocab_size=512, hidden_size=256, intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=8, num_key_value_heads=2)


def _params(fused):
    from callireader_tpu_torch.runtime.quantize import dequantize_llm_int8, init_llm_int8, \
        unfuse_llm_int8

    cfg = LLMConfig(**TINY)
    p = init_llm_int8(cfg, torch.Generator().manual_seed(3), device="cpu")
    return cfg, p if fused else dequantize_llm_int8(unfuse_llm_int8(p, cfg))


def _route(dest, params, cfg, caches, gen_seed):
    """One decode step of ``dest``'s entry point on ``caches`` (2, L, N,
    Hkv, T, D) -> its logits."""
    gen = torch.Generator().manual_seed(gen_seed)
    _, N, _, T, _ = caches.shape[1:]
    B = 4
    ids = torch.randint(3, cfg.vocab_size, (B, 1), generator=gen)
    if dest == "slot":
        kv_valid = torch.zeros((B, T), dtype=torch.int32)
        kv_valid[:, :T - 3] = 1
        cache = internlm2.KVCache(caches[0], caches[1], T - 3)
        return internlm2.decode_step_at(params, cfg, input_ids=ids, cache=cache, kv_valid=kv_valid,
                                        slot=torch.tensor([T - 3]))
    if dest == "lengths":
        return internlm2.decode_step_multislot(
            params, cfg, input_ids=ids, cache_k=caches[0], cache_v=caches[1],
            lengths=torch.tensor([5, 9, 1, 12]), starts=torch.tensor([0, 2, 0, 4]))
    from callireader_tpu_torch.runtime.paged_cache import PagedBatcher

    page, P = T, 3  # 4 slots of 3 pages over a pool of N pages
    batcher = types.SimpleNamespace(
        params=params, cfg=cfg, kpool=caches[0], vpool=caches[1], P=P, page=page,
        policy=DEFAULT_POLICY, mesh=None, device=torch.device("cpu"))
    table = torch.tensor([[1, 2, 3], [4, 5, 0], [6, 7, 8], [0, 0, 0]], dtype=torch.int32)
    lengths = torch.tensor([page + 3, 2, 2 * page + 1, 0])
    active = torch.tensor([1, 1, 1, 0])
    arrays = PagedBatcher._derive_step_arrays(batcher, table, lengths, torch.tensor([0, 0, 1, 0]),
                                              active)
    return PagedBatcher._decode(batcher, ids, table, *arrays)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "separate"])
@pytest.mark.parametrize("dest", ["slot", "lengths", "paged"])
def test_decode_routes_write_through_rope_kv(monkeypatch, dest, fused):
    """Each route makes one rope_kv call a layer with arguments the kernel
    takes (int64 rows and positions, contiguous fp32 tables, the layer's
    views), and gives the logits and caches of the earlier form."""
    cfg, params = _params(fused)
    L, Hkv, D = cfg.num_hidden_layers, cfg.num_key_value_heads, cfg.head_dim
    N, T = (4, 16) if dest != "paged" else (9, 16)
    caches = torch.randn((2, L, N, Hkv, T, D), generator=torch.Generator().manual_seed(1))
    caches = caches.to(torch.bfloat16)
    before = caches.clone()
    calls = []
    plain = k.rope_kv

    def recording(q, k_, v, cos, sin, cache_k, cache_v, rows, pos):
        k._check(q, k_, v, cos, sin, cache_k, cache_v, rows, pos)
        calls.append((cache_k.data_ptr(), rows.clone(), pos.clone()))
        return plain(q, k_, v, cos, sin, cache_k, cache_v, rows, pos)

    def earlier(q, k_, v, cos, sin, cache_k, cache_v, rows, pos):
        _write_before(dest, cache_k, cache_v, _rope_before(k_, cos, sin)[:, :, 0], v[:, :, 0],
                      rows, pos)
        return _rope_before(q, cos, sin).contiguous()

    monkeypatch.setattr(internlm2, "rope_kv", recording)
    logits = _route(dest, params, cfg, caches, 5)
    monkeypatch.setattr(internlm2, "rope_kv", earlier)
    logits_before = _route(dest, params, cfg, before, 5)
    assert torch.equal(logits, logits_before) and torch.equal(caches, before)
    assert [c[0] for c in calls] == [caches[0, i].data_ptr() for i in range(L)]
    rows, pos = calls[0][1:]
    want = {"slot": ([0, 1, 2, 3], [T - 3] * 4), "lengths": ([0, 1, 2, 3], [5, 9, 1, 12]),
            "paged": ([2, 4, 8, 0], [3, 2, 1, 0])}[dest]
    assert (rows.tolist(), pos.tolist()) == want


def test_refusals():
    """What the kernel does not take raises before any launch."""
    B, Hq, Hkv, D = 2, 4, 2, 8
    q, k_, v = (torch.zeros((B, h, 1, D)) for h in (Hq, Hkv, Hkv))
    cos = sin = torch.zeros((B, 1, D))
    ck = cv = torch.zeros((3, Hkv, 5, D))
    rows = pos = torch.zeros((B,), dtype=torch.int64)
    args = [q, k_, v, cos, sin, ck, cv, rows, pos]
    assert k._check(*args) == (1, 1)
    for i, bad in ((7, rows.int()), (8, pos[:1]), (3, torch.zeros((B, 1, D), dtype=torch.float64)),
                   (3, torch.zeros((B, 1, 2 * D))[..., ::2]), (5, ck.half()),
                   (0, q.double()), (1, torch.zeros((B, Hkv, 1, D + 2)))):
        with pytest.raises(ValueError, match="rope_kv"):
            k._check(*(args[:i] + [bad] + args[i + 1:]))
    with pytest.raises(ValueError, match="CUDA"):
        k._launch(*args)


def test_counters_report_lists_the_launch_counts():
    """``cli.evaluate --verbose``'s counters name the kernel's launches and
    the decode steps, which they are held against."""
    from callireader_tpu_torch.utils import profiling

    names = {line.split()[0] for line in profiling.counters_report().splitlines()}
    assert {"rope_kv_launch", "decode_step", "kernel_builds"} <= names
    assert not any(n.startswith("span.") for n in names)


# ---------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _card_case(case, x_dtype, c_dtype, dev, seed):
    """Inputs at a main path's decode shape -> namespace of q, k, v, cos,
    sin, caches (2, N, Hkv, T, D), rows, pos and the tensors they are views
    of (``bases``, which a graph's inputs are copied into)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B, Hq, Hkv, D = 8, 32, 8, 128
    qkv = torch.randn((B, 1, (Hq + 2 * Hkv) * D), generator=g, device=dev).mul(3).to(x_dtype)
    q, k_, v = (t.reshape(B, 1, -1, D).transpose(1, 2)
                for t in torch.split(qkv, [Hq * D, Hkv * D, Hkv * D], dim=-1))
    rows = torch.arange(B, device=dev)
    if case == "slot":  # the 8b interpretation batch: a 3840-slot cache, near its end
        N, T = B, 3840
        slot = torch.tensor([T - 5 - seed], device=dev)
        pos, positions, index = slot.expand(B), slot.view(1, 1).expand(B, 1), slot
    elif case == "lengths":  # the contiguous server's slots at their own lengths
        N, T = B, 4096
        pos = index = torch.randint(3000, T, (B,), generator=g, device=dev)
        positions = (pos - 7)[:, None]
    else:  # the serve shape's pools: 257 pages of 128, rows 5 and 6 on the trash page
        N, T = 257, 128
        rows = torch.randint(1, N, (B,), generator=g, device=dev)
        pos = torch.randint(0, T, (B,), generator=g, device=dev)
        rows[5:7], pos[5:7] = 0, 0
        index, positions = pos, (pos + 3000)[:, None]
    cos, sin = internlm2.cos_sin_for(LLMConfig(), positions, 4096)
    caches = torch.randn((2, N, Hkv, T, D), generator=g, device=dev).to(c_dtype)
    return types.SimpleNamespace(q=q, k=k_, v=v, cos=cos, sin=sin, caches=caches, rows=rows,
                                 pos=pos, bases=(qkv, cos, sin, caches, rows, index))


def _run(c, fn=None):
    """``fn`` (default: the wrapper) on ``c`` -> the rotated q; the caches
    are written in place."""
    return (fn or k.rope_kv)(c.q, c.k, c.v, c.cos, c.sin, c.caches[0], c.caches[1], c.rows, c.pos)


def _plain(c):
    """The plain form on a copy of the caches -> (q, caches)."""
    mine = types.SimpleNamespace(**{**vars(c), "caches": c.caches.clone()})
    return _run(mine, k.rope_kv_reference), mine.caches


def _held_to_plain(c, q_out, trash_rows=()):
    """q and the caches equal the plain form's bits; where ``trash_rows``
    all write (page 0, offset 0), each element is one of those rows'."""
    q_want, want = _plain(c)
    assert torch.equal(q_out, q_want)
    if not trash_rows:
        assert torch.equal(c.caches, want)
        return
    keep = torch.ones(c.caches.shape[1:2] + c.caches.shape[3:4], dtype=torch.bool,
                      device=c.caches.device)
    keep[0, 0] = False
    by_slot = lambda t: t.permute(0, 1, 3, 2, 4)  # noqa: E731  (2, N, T, Hkv, D)
    assert torch.equal(by_slot(c.caches)[:, keep], by_slot(want)[:, keep])
    trash = c.caches[:, 0, :, 0]
    alone = []
    for b in trash_rows:
        one = types.SimpleNamespace(**{n: getattr(c, n)[b:b + 1] for n in
                                       ("q", "k", "v", "cos", "sin", "rows", "pos")},
                                    caches=c.caches)
        alone.append(_plain(one)[1][:, 0, :, 0])
    assert functools.reduce(torch.logical_or, [trash == a for a in alone]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,c_dtype", DTYPE_PAIRS)
@pytest.mark.parametrize("case", ["slot", "lengths", "paged"])
def test_cuda_matches_plain(cuda, case, x_dtype, c_dtype):
    c = _card_case(case, x_dtype, c_dtype, cuda, 11)
    launches = k.KERNEL.launches
    q_out = _run(c)
    torch.cuda.synchronize()
    assert k.KERNEL.launches == launches + 1
    _held_to_plain(c, q_out, (5, 6) if case == "paged" else ())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["slot", "lengths", "paged"])
def test_cuda_graph_replays_match_plain(cuda, case):
    """Captured once, replayed on new inputs copied into the same buffers
    (rows and positions among them): each replay equals the plain form."""
    c = _card_case(case, torch.bfloat16, torch.bfloat16, cuda, 1)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):  # the first call outside any capture
        _run(c)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        q_out = _run(c)
    for seed in (2, 3):
        new = _card_case(case, torch.bfloat16, torch.bfloat16, cuda, seed)
        for buf, t in zip(c.bases, new.bases):
            buf.copy_(t)
        graph.replay()
        torch.cuda.synchronize()
        _held_to_plain(c, q_out, (5, 6) if case == "paged" else ())


@pytest.mark.cuda
def test_cuda_refusals(cuda):
    c = _card_case("slot", torch.bfloat16, torch.bfloat16, cuda, 4)
    with pytest.raises(ValueError, match="int64"):
        k.rope_kv(c.q, c.k, c.v, c.cos, c.sin, c.caches[0], c.caches[1], c.rows.int(), c.pos)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        k.rope_kv(c.q.half(), c.k.half(), c.v.half(), c.cos, c.sin, c.caches[0], c.caches[1],
                  c.rows, c.pos)
    with pytest.raises(ValueError, match="CUDA"):
        k.rope_kv(c.q, c.k, c.v, c.cos.cpu(), c.sin, c.caches[0], c.caches[1], c.rows, c.pos)
