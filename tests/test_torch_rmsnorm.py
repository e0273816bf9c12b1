"""RMSNorm forward and backward (kernels/rmsnorm.py) against the JAX package.

CPU: the plain versions of both modes against ``rms_norm_pallas`` (interpret
mode, forward and its custom-VJP backward) and against the model's
``internlm2.rms_norm`` and its autodiff; gradcheck of ``RMSNormFn`` in fp64;
the number of forward and backward calls a remat training step makes.
Card (marked ``cuda``): the CUDA kernels against the plain versions at the
main paths' shapes, equal bits across runs, refusals.

Tolerances: fp32, 1e-6 absolute for y and dx (the same arithmetic, sums in
another order). bf16, one bf16 ulp of the output plus that 1e-6: the fp32
values agree to ~1e-7, which can move a value across a bf16 rounding
boundary (and dx, a difference of two terms, can be far smaller than
either). dw sums over the rows, so its error scales with the sum of its
terms' sizes S = sum_rows |dy x r|: fp32 sums in another order, 1e-6 S. The
JAX autodiff of the model's bf16 rms_norm reduces its bf16 products in bf16
(each addition rounds to 8 bits; it reads up to 1.06 x 2^-8 S off the exact
sum here), so against it bf16 dw is held to 2^-6 S, and the plain version
to an fp64 sum at 1e-6 S.
"""

import numpy as np
import pytest
import torch

from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.kernels import rmsnorm as k
from callireader_tpu_torch.kernels import tolerance

EPS = 1e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX side, imported here so that the card-only cases run where JAX
    is absent (``pytest --noconftest -m cuda``)."""
    pytest.importorskip("jax")
    import types

    import jax
    import jax.numpy as jnp

    from callireader_tpu.core import dtypes as jdtypes
    from callireader_tpu.kernels.rmsnorm import rms_norm_pallas
    from callireader_tpu.models import internlm2

    return types.SimpleNamespace(jax=jax, jnp=jnp, pallas=rms_norm_pallas,
                                 model=internlm2.rms_norm, dtypes=jdtypes)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _inputs(rows, E, seed=0):
    rng = np.random.default_rng(seed + rows + E)
    x = rng.standard_normal((rows, E)).astype(np.float32) * 2
    w = (rng.standard_normal(E) * 0.1 + 1).astype(np.float32)
    dy = rng.standard_normal((rows, E)).astype(np.float32)
    return x, w, dy


def _torch(a, dtype):
    return torch.from_numpy(a).to(dtype)


def _jax(jx, a, dtype):
    return jx.jnp.asarray(a).astype(jx.jnp.bfloat16 if dtype == torch.bfloat16 else jx.jnp.float32)


def _bf16_ulp(a):
    """The spacing of bf16 values at |a| (8 significant bits)."""
    a = np.maximum(np.abs(a), np.float32(2.0**-126))
    return np.exp2(np.floor(np.log2(a)) - 7)


def _close(got, want, dtype, atol=1e-6):
    """fp32: within ``atol``; bf16: within one bf16 ulp of the larger, plus ``atol``."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == torch.bfloat16:
        bad = np.abs(got - want) > _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + atol
        assert not bad.any(), (got[bad][:8], want[bad][:8])
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _close_dw(got, want, terms, rel):
    """dw within ``rel`` times the sum of its terms' sizes, elementwise."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_array_less(np.abs(got - want), rel * terms + 1e-30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,E", [(1, 128), (7, 128), (512, 128), (1, 4096), (7, 4096),
                                    (512, 4096)])
def test_fused_plain_matches_rms_norm_pallas(jx, rows, E, dtype):
    """Forward, dx and dw of the fused mode against the Pallas kernel pair
    (7 rows: one ragged block in JAX)."""
    x, w, dy = _inputs(rows, E)
    jxx, jw, jdy = _jax(jx, x, dtype), _jax(jx, w, dtype), _jax(jx, dy, dtype)
    y_j, vjp = jx.jax.vjp(lambda a, b: jx.pallas(a, b, EPS, True), jxx, jw)
    dx_j, dw_j = vjp(jdy)
    xt, wt, dyt = _torch(x, dtype), _torch(w, dtype), _torch(dy, dtype)
    y, r = k.rms_norm_fused_reference(xt, wt, EPS, "fused")
    dx, dw = k.rms_norm_bwd_reference(xt, wt, r, dyt, "fused")
    assert y.dtype == dtype and dx.dtype == dtype and dw.dtype == torch.float32
    _close(y, y_j, dtype)
    _close(dx, dx_j, dtype)
    # dw: the JAX rule sums fp32 partials per row block, then casts to w's dtype
    if dtype == torch.bfloat16:
        _close(dw.to(dtype), dw_j, dtype)
    else:
        terms = (dyt.abs() * xt.abs() * r[:, None]).sum(0).numpy()
        _close_dw(dw, dw_j, terms, 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_plain_is_the_old_rms_norm_and_matches_jax(jx, dtype):
    """The model mode's plain forward equals the port's earlier rms_norm body
    bit for bit, and matches the JAX internlm2.rms_norm and its autodiff."""
    x, w, dy = _inputs(96, 64, seed=3)
    xt, wt, dyt = _torch(x, dtype), _torch(w, dtype), _torch(dy, dtype)
    xf = xt.to(torch.float32)
    old = (xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + EPS)).to(dtype) * wt.to(dtype)
    y, r = k.rms_norm_fused_reference(xt, wt, EPS, "model")
    assert torch.equal(y, old)

    policy = jx.dtypes.FP32_POLICY if dtype == torch.float32 else jx.dtypes.DEFAULT_POLICY
    jxx, jw, jdy = _jax(jx, x, dtype), _jax(jx, w, dtype), _jax(jx, dy, dtype)
    y_j, vjp = jx.jax.vjp(lambda a, b: jx.model(a, b, EPS, policy), jxx, jw)
    dx_j, dw_j = vjp(jdy)
    _close(y, y_j, dtype)
    dx, dw = k.rms_norm_bwd_reference(xt, wt, r, dyt, "model")
    _close(dx, dx_j, dtype)
    u = (xt.double() * r.double()[:, None]).to(dtype).double()
    terms = (dyt.double().abs() * u.abs()).sum(0).numpy()
    _close_dw(dw, (dyt.double() * u).sum(0).numpy(), terms, 1e-6)
    _close_dw(dw, dw_j, terms, 1e-6 if dtype == torch.float32 else 2.0**-6)


@pytest.mark.parametrize("mode", ["fused", "model"])
def test_rmsnormfn_gradcheck(mode):
    g = torch.Generator().manual_seed(0)
    x = torch.randn((5, 32), generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn((32,), generator=g, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda a, b: k.RMSNormFn.apply(a, b, EPS, mode), (x, w))


def test_backward_computes_dw_only_when_asked(monkeypatch):
    asked = []
    bwd = k._bwd
    monkeypatch.setattr(k, "_bwd", lambda *a: asked.append(a[-1]) or bwd(*a))
    x = torch.randn((3, 64), requires_grad=True)
    w = torch.randn((64,))
    k.rms_norm_trainable(x, w, EPS).sum().backward()
    w.requires_grad_(True)
    k.rms_norm_trainable(x, w, EPS).sum().backward()
    assert asked == [False, True] and w.grad is not None


def test_training_step_launch_counts(monkeypatch):
    """Under remat a training step runs the forward 4L+1 times (each layer's
    two norms, again in the recompute, and the final norm) and the backward
    2L+1 times; a prefill and a decode step run the forward 2L+1 times and
    the backward never (what chip_smoke.py asserts on the card)."""
    from callireader_tpu_torch.core.config import callireader_tiny
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import weights

    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = k._fwd, k._bwd

    def count(name, fn):
        def wrapped(*a):
            calls[name] += 1
            return fn(*a)
        return wrapped

    monkeypatch.setattr(k, "_fwd", count("fwd", fwd))
    monkeypatch.setattr(k, "_bwd", count("bwd", bwd))
    cfg = callireader_tiny().llm
    params = weights.init_params(callireader_tiny(), 0,
                                 dtype=torch.float32, device="cpu")["llm"]
    L = cfg.num_hidden_layers
    emb = torch.randn((2, 16, cfg.hidden_size), requires_grad=True)
    logits = internlm2.forward(params, cfg, inputs_embeds=emb, policy=T_FP32, remat=True)
    logits.float().logsumexp(-1).sum().backward()
    assert calls == {"fwd": 4 * L + 1, "bwd": 2 * L + 1}
    calls.update(fwd=0, bwd=0)
    with torch.inference_mode():
        lg, cache = internlm2.prefill(params, cfg, inputs_embeds=emb.detach(),
                                      attention_mask=torch.ones((2, 16), dtype=torch.int32),
                                      max_len=20, policy=T_FP32)
        internlm2.decode_step(params, cfg, input_ids=lg.argmax(-1)[:, None], cache=cache,
                              policy=T_FP32)
    assert calls == {"fwd": 2 * (2 * L + 1), "bwd": 0}


def test_launch_path_reads_the_weight_as_it_stands():
    """The kernels' weight is the norm weight itself when its dtype is x's
    (the port makes its norm weights so): an update in place,
    as the adapter merge and the training step make, is what the next call
    reads. A weight of another dtype is cast afresh on every call, never
    kept."""
    x = torch.randn((2, 1, 64)).bfloat16()
    w = torch.randn((64,)).bfloat16()
    assert k._weight_for(x, w, "model") is w and k._weight_for(x, w, "fused") is w
    w32 = torch.randn((64,))
    first = k._weight_for(x, w32, "model")
    w32.mul_(3)
    assert torch.equal(k._weight_for(x, w32, "model"), w32.bfloat16())
    assert not torch.equal(first, w32.bfloat16())
    with pytest.raises(ValueError, match="fused"):
        k._weight_for(x, w32, "fused")


def test_launch_path_refuses_what_the_kernels_do_not_take(monkeypatch):
    """The launch path's checks, which guard the kernels' memory accesses:
    dtype, width, layout, 16-byte alignment, the weight's shape and dtype,
    and the device (no CPU address ever reaches a kernel)."""
    launched = []
    monkeypatch.setattr(k, "KERNELS_FWD", {m: lambda *a: launched.append(a) for m in k.KERNELS_FWD})
    x = torch.randn((3, 2, 64)).bfloat16()
    w = torch.randn((64,)).bfloat16()
    px, pw, rows, E, code = k._row_args(x, w)
    assert (px, pw, rows, E, code) == (x.data_ptr(), w.data_ptr(), 6, 64, 0)
    assert k._row_args(x.float(), w.float())[2:] == (6, 64, 1)
    for bad_x, bad_w, match in (
            (x.half(), w.half(), "bf16 or fp32"),
            (x[..., :60], w[:60], "width"),
            (torch.zeros((1, 2 * k.MAX_WIDTH)).bfloat16(), torch.zeros(2 * k.MAX_WIDTH).bfloat16(),
             "width"),
            (x, w[:32], "width"),
            (x, w.float(), "must be"),
            (x.transpose(0, 1), w, "contiguous"),
            (torch.zeros(6 * 64 + 1).bfloat16()[1:].view(6, 64), w, "aligned")):
        with pytest.raises(ValueError, match=match):
            k._row_args(bad_x, bad_w)
    with pytest.raises(ValueError, match="CUDA"):
        k._launch_fwd(x, w, EPS, "model", False)
    assert not launched


@pytest.mark.parametrize("want_dw", [False, True])
def test_backward_launch_path_refuses_and_allocates(monkeypatch, want_dw):
    """The backward's launch path with the device check and the kernels
    stood in for (CPU tensors on a card of 132 SMs): it refuses dy of
    another shape, dtype or alignment, r of another shape or dtype and rows
    the kernels do not take; it hands the one launch dx, and with dw the
    (E,) fp32 dw and the blocks' (blocks, E) fp32 partials, blocks being the
    balanced grid; ``_bwd`` returns the launch's dw with no sum after it."""
    launched, made = [], []
    monkeypatch.setattr(k, "_require_cuda", lambda *t: None)
    monkeypatch.setattr(k, "_sm_count", lambda index: 132)
    monkeypatch.setattr(k, "KERNELS_BWD", {m: lambda *a: launched.append(a) for m in k.KERNELS_BWD})
    buffers = k._bwd_buffers
    monkeypatch.setattr(k, "_bwd_buffers", lambda *a: made.append(buffers(*a)) or made[-1])
    rows, E = 2560, 64
    x, w, dy = (torch.randn(s).bfloat16() for s in ((rows, E), (E,), (rows, E)))
    r = torch.rand(rows) + 0.5
    dx, dw = k._launch_bwd(x, w, r, dy, "model", want_dw)
    (b_dx, b_dw, part, blocks), = made
    (args,) = launched
    # 2560 rows over at most 2 x 132 blocks: 10 strides of 256 blocks
    assert blocks == 256 and k._bwd_blocks(7, x.device) == 7 and k._bwd_blocks(4099, x.device) == 257
    assert b_dx is dx and dx.shape == x.shape and dx.dtype == x.dtype
    assert args[:5] == (x.data_ptr(), w.data_ptr(), r.data_ptr(), dy.data_ptr(), dx.data_ptr())
    assert args[7:] == (rows, E, blocks, 0)
    if want_dw:
        assert b_dw is dw and dw.shape == (E,) and dw.dtype == torch.float32
        assert part.shape == (blocks, E) and part.dtype == torch.float32
        assert args[5:7] == (part.data_ptr(), dw.data_ptr())
    else:
        assert dw is None and part is None and args[5:7] == (None, None)
    misaligned = torch.zeros(rows * E + 1).bfloat16()[1:].view(rows, E)
    for bad, match in (
            (dict(dy=dy.float()), "dy must be"),
            (dict(dy=dy[:-1]), "x's shape"),
            (dict(dy=misaligned), "dy must be 16-byte aligned"),
            (dict(r=r[:-1]), "one value a row"),
            (dict(r=r.double()), "r must be"),
            (dict(x=x[:, :60].contiguous(), w=w[:60], dy=dy[:, :60].contiguous()), "width"),
            (dict(x=misaligned), "aligned")):
        args = dict(x2=x, w=w, r=r, dy2=dy)
        args.update({("x2" if n == "x" else "dy2" if n == "dy" else n): t for n, t in bad.items()})
        with pytest.raises(ValueError, match=match):
            k._launch_bwd(args["x2"], args["w"], args["r"], args["dy2"], "model", want_dw)
    assert len(launched) == 1

    # _bwd on tensors off the CPU: the launch's dw as it is
    got = {}

    def fake_launch(x2, w_, r_, dy2, mode, need_dw):
        got["dx"], got["dw"] = torch.empty_like(x2), torch.empty((E,), device=x2.device)
        return got["dx"], got["dw"] if need_dw else None

    monkeypatch.setattr(k, "_launch_bwd", fake_launch)
    xm = torch.empty((2, 1280, E), device="meta", dtype=torch.bfloat16)
    out_dx, out_dw = k._bwd(xm, torch.empty((E,), device="meta", dtype=torch.bfloat16),
                            torch.empty((rows,), device="meta"), torch.empty_like(xm), "model",
                            want_dw)
    assert out_dx.shape == xm.shape
    assert (out_dw is got["dw"]) if want_dw else out_dw is None


# ---------------------------------------------------------------- card only


def _cuda_inputs(rows, E, dtype, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((rows, E), generator=g, device=dev) * 2).to(dtype)
    w = (torch.randn((E,), generator=g, device=dev) * 0.1 + 1).to(dtype)
    dy = torch.randn((rows, E), generator=g, device=dev).to(dtype)
    return x, w, dy


def _ulp(t):
    return torch.exp2(torch.floor(torch.log2(t.float().abs().clamp_min(2.0**-126))) - 7)


def _check_bf16(got, want, slack=1e-6):
    """Both rounded to bf16 from fp32 values a few fp32 ulps apart: one bf16
    ulp (plus ``slack``) elementwise, few elements apart."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    assert (diff <= _ulp(torch.maximum(got.abs(), want.abs())) + slack).all()
    assert (diff > 0).float().mean().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,E", [(4, 4096), (8, 4096), (4 * 3584, 4096), (4096, 4096),
                                    (7, 64), (33, 32)])
@pytest.mark.parametrize("mode", ["model", "fused"])
def test_cuda_matches_plain(cuda, rows, E, dtype, mode):
    """The fused form against the plain version in fp32 on the same values,
    unrounded (kernels/tolerance.py's rule); the model form against its plain
    version rounded as it is: an fp32 last-bit difference in r can move
    u = bf16(x r) by one ulp, which w carries into y before y's own rounding."""
    x, w, dy = _cuda_inputs(rows, E, dtype, cuda)
    y, r = k._launch_fwd(x, w, EPS, mode, True)
    dx, dw = k._launch_bwd(x, w, r, dy, mode, True)
    torch.cuda.synchronize()
    ins = (x, w, dy) if mode == "model" else (x.float(), w.float(), dy.float())
    y_p, r_p = k.rms_norm_fused_reference(ins[0], ins[1], EPS, mode)
    dx_p, dw_p = k.rms_norm_bwd_reference(ins[0], ins[1], r, ins[2], mode)
    assert (r - r_p).abs().max().item() <= 1e-6 * r_p.abs().max().item()
    if mode == "model" and dtype == torch.bfloat16:
        u = (x.float() * r_p[:, None]).bfloat16()
        _check_bf16(y, y_p, slack=_ulp(u) * w.float().abs())
        _check_bf16(dx, dx_p)
    else:
        assert tolerance.excess_error(y, y_p) <= tolerance.ATOL["rms_norm"]
        assert tolerance.excess_error(dx, dx_p) <= tolerance.ATOL["rms_norm"]
    u = (x.float() * r[:, None]).to(dtype).float() if mode == "model" else x.float() * r[:, None]
    terms = (dy.float().abs() * u.abs()).sum(0)
    assert dw.shape == (E,) and dw.dtype == torch.float32
    assert ((dw - dw_p).abs() <= 1e-5 * terms).all()


def _dw_terms(x, r, dy, mode):
    """The sum over the rows of |dy u|, u = x r as dw's terms take it."""
    u = (x.float() * r[:, None]).to(x.dtype).float() if mode == "model" else x.float() * r[:, None]
    return (dy.float().abs() * u.abs()).sum(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("E", [64, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 7, 131, 133, 2560, 4099])
def test_cuda_backward_matches_plain(cuda, rows, E, dtype):
    """The backward at grids of fewer rows than SMs, of one ragged stride
    (131, 133 rows: blocks that walk one row and blocks that walk none past
    the first stride) and at the training paths' 2560 rows, in both roundings,
    dw on and off: dx as test_cuda_matches_plain holds it, the same bits with
    dw on and off, dw (E,) from the one launch within 1e-5 of the sum of its
    terms' sizes."""
    x, w, dy = _cuda_inputs(rows, E, dtype, cuda, seed=rows * E)
    for mode in ("model", "fused"):
        r = k._launch_fwd(x, w, EPS, mode, True)[1]
        dx, dw = k._launch_bwd(x, w, r, dy, mode, True)
        dx_off, none = k._launch_bwd(x, w, r, dy, mode, False)
        torch.cuda.synchronize()
        assert none is None and torch.equal(dx, dx_off), mode
        ins = (x, w, dy) if mode == "model" else (x.float(), w.float(), dy.float())
        dx_p, dw_p = k.rms_norm_bwd_reference(ins[0], ins[1], r, ins[2], mode)
        if mode == "model" and dtype == torch.bfloat16:
            _check_bf16(dx, dx_p)
        else:
            assert tolerance.excess_error(dx, dx_p) <= tolerance.ATOL["rms_norm"], mode
        assert dw.shape == (E,) and dw.dtype == torch.float32
        assert ((dw - dw_p).abs() <= 1e-5 * _dw_terms(x, r, dy, mode)).all(), mode


@pytest.mark.cuda
def test_cuda_backward_is_deterministic(cuda):
    x, w, dy = _cuda_inputs(4096, 4096, torch.bfloat16, cuda, seed=1)
    _, r = k._launch_fwd(x, w, EPS, "model", True)
    runs = [k._launch_bwd(x, w, r, dy, "model", True) for _ in range(2)]
    assert runs[0][1].shape == (4096,)
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])


@pytest.mark.cuda
def test_cuda_backward_is_one_launch(cuda):
    """``_bwd`` with dw is one launch of the backward kernel and nothing else
    on the device (torch.profiler's kernels; no sum after it)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, w, dy = _cuda_inputs(2560, 4096, torch.bfloat16, cuda, seed=2)
    _, r = k._launch_fwd(x, w, EPS, "model", True)
    k._bwd(x, w, r, dy, "model", True)
    torch.cuda.synchronize()
    before = k.KERNELS_BWD["model"].launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            k._bwd(x, w, r, dy, "model", True)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert k.KERNELS_BWD["model"].launches - before == 4
    assert names and all("rmsnorm_bwd" in n for n in names) and len(names) <= 4, names


@pytest.mark.cuda
def test_cuda_refuses_what_it_does_not_take(cuda):
    for E in (100, 2 * k.MAX_WIDTH):
        x, w, _ = _cuda_inputs(4, E, torch.bfloat16, cuda)
        with pytest.raises(ValueError, match="width"):
            k.rms_norm(x, w, EPS)
    x, w, _ = _cuda_inputs(4, 64, torch.float16, cuda)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        k.rms_norm(x, w, EPS)
    x, w, _ = _cuda_inputs(4, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="fused"):
        k.rms_norm(x, w.float(), EPS, "fused")


@pytest.fixture(scope="module")
def two_pass_forward(tmp_path_factory):
    """The forward kernels of tests/data/rmsnorm_two_pass.cu (the row read
    twice) -> launch(x, w, mode) -> (y, r)."""
    import ctypes
    import subprocess
    from pathlib import Path

    from callireader_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    src = Path(__file__).parent / "data" / "rmsnorm_two_pass.cu"
    so = tmp_path_factory.mktemp("rmsnorm_two_pass") / "rmsnorm_two_pass.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))

    def launch(x, w, mode):
        fn = k.KERNELS_FWD[mode].entry_in(lib)
        y = torch.empty_like(x)
        r = torch.empty((x.shape[0],), dtype=torch.float32, device=x.device)
        assert fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), r.data_ptr(), x.shape[0], x.shape[1],
                  EPS, k.DTYPES[x.dtype], torch.cuda.current_stream().cuda_stream) == 0
        return y, r

    return launch


@pytest.mark.cuda
@pytest.mark.parametrize("E", [64, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 4, 8, 2 * 2048, 4 * 3584])
def test_cuda_forward_bits_equal_the_two_pass_kernel(cuda, two_pass_forward, rows, E):
    """Reading each row once into registers keeps each thread's elements and
    the order of the block's sum: y and r are the bits of the kernel that
    read the row twice, in both roundings and both dtypes."""
    for dtype in (torch.bfloat16, torch.float32):
        x, w, _ = _cuda_inputs(rows, E, dtype, cuda, seed=rows + E)
        for mode in ("model", "fused"):
            y, r = k._launch_fwd(x, w, EPS, mode, True)
            y_old, r_old = two_pass_forward(x, w, mode)
            torch.cuda.synchronize()
            assert torch.equal(y, y_old) and torch.equal(r, r_old), (dtype, mode)


@pytest.fixture(scope="module")
def row_kernel_backward(tmp_path_factory):
    """The backward of tests/data/rmsnorm_bwd_rows.cu (groups of rows a block,
    each row read twice, dw as (blocks, E) partials) -> launch(x, w, r, dy,
    mode, want_dw) -> dx."""
    import subprocess

    from callireader_tpu_torch.tools import norm_bwd_probe as probe

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    so = tmp_path_factory.mktemp("rmsnorm_bwd_rows") / "rmsnorm_bwd_rows.so"
    subprocess.run(probe.rows_kernel_command(so), check=True, capture_output=True, text=True)
    fns = probe.bind_rows(so)
    return lambda x, w, r, dy, mode, want_dw: probe.launch_rows(fns[mode], x, w, r, dy, want_dw)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("E", [64, 4096, 8192])
@pytest.mark.parametrize("rows", [1, 7, 133, 2560, 4099])
def test_cuda_backward_dx_matches_the_row_kernel(cuda, row_kernel_backward, rows, E):
    """Holding each row in registers keeps each thread's elements and the
    order of the block's sum of g x: in fp32 dx is the bits of the kernel that
    walked groups of rows and read each row twice, in both roundings, dw on
    and off; in bf16 it is within one bf16 ulp of it, and apart on at most
    1e-3 of the elements (on the card: 1 to 24 elements of 0.26 to 34
    million, each one ulp)."""
    for dtype in (torch.bfloat16, torch.float32):
        x, w, dy = _cuda_inputs(rows, E, dtype, cuda, seed=rows + E)
        for mode in ("model", "fused"):
            r = k._launch_fwd(x, w, EPS, mode, True)[1]
            for want_dw in (False, True):
                dx = k._launch_bwd(x, w, r, dy, mode, want_dw)[0]
                dx_old = row_kernel_backward(x, w, r, dy, mode, want_dw)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    assert torch.equal(dx, dx_old), (mode, want_dw)
                else:
                    _check_bf16(dx, dx_old, slack=0.0)
