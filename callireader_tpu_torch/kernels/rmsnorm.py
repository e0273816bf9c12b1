"""RMSNorm forward and backward (PyTorch port of
callireader_tpu/kernels/rmsnorm.py ``rms_norm_pallas``, a ``jax.custom_vjp``
over two Pallas kernels).

For x (..., E) and w (E,), with r = 1 / sqrt(mean(x^2) + eps) per row in fp32:

    forward   y = x * r * w
    backward  g = w * dy,  dx = r * g - x * r^3 * sum_j(g_j x_j) / E,
              dw = sum_rows dy * x * r

On the H100 these are the hand-written CUDA kernels of csrc/rmsnorm.cu: the
forward a block per row (the row read once into registers: sum of squares,
then y), the backward a persistent grid of ``BWD_BLOCKS_PER_SM`` blocks an SM
walking the rows (each row read once into registers, the next one loading
while this one's sum is reduced, dw accumulated in registers) that finishes
dw in the same launch: each block's fp32 partial, one grid barrier, the
partials summed in a fixed order (no atomics: the same bits on every run).
What bounds them: bytes (x read, y written; x, dy read, dx written).

Two modes, two instantiations of each kernel:

- ``"fused"``: y rounded to x's dtype once, exactly ``rms_norm_pallas``;
- ``"model"``: y = T(T(x * r) * T(w)), exactly the model's plain
  ``internlm2.rms_norm`` (T = x's dtype), whose backward rounds g = w * dy to
  T before the fp32 reduction and whose dw sums dy * T(x * r), as autodiff of
  that function does. In fp32 the two modes agree.

``rms_norm_fused_reference`` and ``rms_norm_bwd_reference`` are the plain
versions (fp32 arithmetic); the wrappers take them for CPU tensors only. On
CUDA the wrappers take bf16 or fp32 rows whose width is a multiple of
``WIDTH_MULTIPLE`` up to ``MAX_WIDTH`` and raise on anything else. ``RMSNormFn`` is the differentiable form: its
backward computes dw only when the weight needs a gradient.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import Optional, Tuple

import torch

from callireader_tpu_torch.kernels._build import CudaKernel, check_layout, ptr, refuse_grad

SOURCE = "rmsnorm"
_FWD_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int]
_BWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
KERNELS_FWD = {mode: CudaKernel(SOURCE, f"rmsnorm_fwd_{mode}_launch", _FWD_ARGS)
               for mode in ("model", "fused")}
KERNELS_BWD = {mode: CudaKernel(SOURCE, f"rmsnorm_bwd_{mode}_launch", _BWD_ARGS)
               for mode in ("model", "fused")}
# row widths the kernels take: 16-byte vectors across the row, at most 8 of
# them a thread held in registers. The presets' LLMs are 4096 (8b, 2b) and 64
# (tiny) wide.
WIDTH_MULTIPLE, MAX_WIDTH = 8, 8192
DTYPES = {torch.bfloat16: 0, torch.float32: 1}
# the backward's persistent grid, blocks an SM (never more blocks than rows;
# with dw never more than the card holds at once: the kernel clamps); each
# block with dw writes an (E,) fp32 partial
BWD_BLOCKS_PER_SM = 2


def _acc(x: torch.Tensor) -> torch.dtype:
    """Arithmetic type of the plain versions: fp32, or fp64 for fp64 inputs."""
    return torch.promote_types(x.dtype, torch.float32)


def _check_mode(mode: str) -> None:
    if mode not in KERNELS_FWD:
        raise ValueError(f"mode must be 'model' or 'fused', got {mode!r}")


# ---------------------------------------------------------------- plain versions


def rms_norm_fused_reference(
    x: torch.Tensor, w: torch.Tensor, eps: float, mode: str = "fused"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward -> (y in x's dtype, r fp32 (rows,); fp64 for fp64 x).
    ``"model"`` is the body of the model's rms_norm operation for operation."""
    _check_mode(mode)
    xf = x.to(_acc(x))
    var = (xf * xf).mean(dim=-1, keepdim=True)
    r = torch.rsqrt(var + eps)
    if mode == "model":
        y = (xf * r).to(x.dtype) * w.to(x.dtype)
    else:
        y = (xf * r * w.to(xf.dtype)).to(x.dtype)
    return y, r.reshape(-1)


def rms_norm_bwd_reference(
    x: torch.Tensor,
    w: torch.Tensor,
    r: torch.Tensor,
    dy: torch.Tensor,
    mode: str = "fused",
    need_dw: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain backward from the formula -> (dx in dy's dtype, dw fp32 (E,) or
    None; fp64 for fp64 x). ``r`` is the forward's (rows,)."""
    _check_mode(mode)
    E = x.shape[-1]
    acc = _acc(x)
    xf = x.reshape(-1, E).to(acc)
    df = dy.reshape(-1, E).to(acc)
    rr = r.reshape(-1, 1).to(acc)
    if mode == "model":
        g = (w.to(x.dtype) * dy.reshape(-1, E).to(x.dtype)).to(acc)
    else:
        g = w.to(acc) * df
    inner = (g * xf).sum(dim=-1, keepdim=True)
    dx = rr * g - xf * (rr * rr * rr) * inner / E
    dw = None
    if need_dw:
        u = (xf * rr).to(x.dtype).to(acc) if mode == "model" else xf * rr
        dw = (df * u).sum(dim=0)
    return dx.to(dy.dtype).reshape(dy.shape), dw


# ---------------------------------------------------------------- kernels


def _row_args(x: torch.Tensor, w: torch.Tensor) -> Tuple[int, int, int, int, int]:
    """What the kernels need to read rows of ``x`` (..., E) with weight ``w``
    safely -> (x's address, w's address, rows, E, dtype code); raises
    ValueError on a dtype, width, layout or alignment they do not take."""
    code = DTYPES.get(x.dtype)
    if code is None:
        raise ValueError(f"the RMSNorm kernels take bf16 or fp32 rows, got {x.dtype}")
    E = x.shape[-1]
    if E % WIDTH_MULTIPLE or not 0 < E <= MAX_WIDTH or w.shape != (E,):
        raise ValueError(f"unsupported RMSNorm width {E} (w {tuple(w.shape)}); the kernels "
                         f"take multiples of {WIDTH_MULTIPLE} up to {MAX_WIDTH}")
    if w.dtype != x.dtype:
        raise ValueError(f"w must be {x.dtype}, got {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    px, pw = x.data_ptr(), w.data_ptr()
    if px % 16 or pw % 16:
        raise ValueError("x and w must be 16-byte aligned")
    return px, pw, x.numel() // E, E, code


def _require_cuda(*tensors: torch.Tensor) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the RMSNorm kernels take CUDA tensors")


def _launch_fwd(x: torch.Tensor, w: torch.Tensor, eps: float, mode: str, want_r: bool):
    """x (..., E) -> (y of x's shape, r fp32 (rows,) or None)."""
    _require_cuda(x, w)
    px, pw, rows, E, code = _row_args(x, w)
    y = torch.empty_like(x)
    r = torch.empty((rows,), dtype=torch.float32, device=x.device) if want_r else None
    KERNELS_FWD[mode](px, pw, y.data_ptr(), None if r is None else r.data_ptr(), rows, E,
                      eps, code)
    return y, r


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _bwd_blocks(rows: int, device: torch.device) -> int:
    """The backward's grid: at most ``BWD_BLOCKS_PER_SM`` blocks an SM, as few
    as walk the rows in as many strides (so every block walks as many rows,
    the last stride aside)."""
    strides = -(-rows // (BWD_BLOCKS_PER_SM * _sm_count(device.index)))
    return -(-rows // strides)


def _bwd_buffers(x2: torch.Tensor, want_dw: bool):
    """What the backward writes -> (dx like x2, dw fp32 (E,) or None, the
    blocks' dw partials fp32 (blocks, E) or None, blocks)."""
    rows, E = x2.shape
    blocks = _bwd_blocks(rows, x2.device)
    dx = torch.empty_like(x2)
    if not want_dw:
        return dx, None, None, blocks
    f32 = dict(dtype=torch.float32, device=x2.device)
    return dx, torch.empty((E,), **f32), torch.empty((blocks, E), **f32), blocks


def _launch_bwd(x2: torch.Tensor, w: torch.Tensor, r: torch.Tensor, dy2: torch.Tensor, mode: str,
                want_dw: bool):
    """One launch -> (dx (rows, E), dw fp32 (E,) or None)."""
    _require_cuda(x2, w, r, dy2)
    px, pw, rows, E, code = _row_args(x2, w)
    check_layout(dy2, "dy", x2.dtype)
    check_layout(r, "r", torch.float32)
    if dy2.shape != x2.shape or r.shape != (rows,):
        raise ValueError("dy must have x's shape and r one value a row")
    dx, dw, part, blocks = _bwd_buffers(x2, want_dw)
    KERNELS_BWD[mode](px, pw, ptr(r), ptr(dy2), ptr(dx), None if part is None else ptr(part),
                      None if dw is None else ptr(dw), rows, E, blocks, code)
    return dx, dw


def _weight_for(x: torch.Tensor, w: torch.Tensor, mode: str) -> torch.Tensor:
    """The kernels read w in x's dtype. The port's weights hold the norms in
    the compute dtype, so on its paths this is w itself, and an update in
    place is what the next call reads; in the model mode a weight of another
    dtype is cast afresh on each call (the plain version's first step), never
    kept. The fused mode casts w to fp32 directly, which the kernel can only
    match when it already is x's dtype."""
    if w.dtype != x.dtype:
        if mode != "model":
            raise ValueError(f"fused RMSNorm on CUDA takes w in x's dtype {x.dtype}, got {w.dtype}")
        w = w.to(x.dtype)
    return w.contiguous()


def _fwd(x: torch.Tensor, w: torch.Tensor, eps: float, mode: str, want_r: bool):
    """-> (y of x's shape, r fp32 (rows,) or None)."""
    if x.is_cpu:
        return rms_norm_fused_reference(x, w, eps, mode)
    _check_mode(mode)
    if not x.is_contiguous():
        x = x.contiguous()
    return _launch_fwd(x, _weight_for(x, w, mode), eps, mode, want_r)


def _bwd(x: torch.Tensor, w: torch.Tensor, r: torch.Tensor, dy: torch.Tensor, mode: str,
         want_dw: bool):
    """-> (dx of x's shape in dy's dtype, dw fp32 (E,) or None)."""
    if x.is_cpu:
        return rms_norm_bwd_reference(x, w, r, dy, mode, want_dw)
    E = x.shape[-1]
    dx, dw = _launch_bwd(x.reshape(-1, E).contiguous(), _weight_for(x, w, mode), r,
                         dy.reshape(-1, E).contiguous(), mode, want_dw)
    return dx.reshape(x.shape), dw


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float, mode: str = "model") -> torch.Tensor:
    """Forward only (no autograd): x (..., E), w (E,) -> y in x's dtype. On
    CUDA an input that requires grad raises (``rms_norm_trainable`` has the
    backward)."""
    if not x.is_cpu:
        refuse_grad("rms_norm", x, w)
    return _fwd(x, w, eps, mode, False)[0]


class RMSNormFn(torch.autograd.Function):
    """y = rms_norm(x, w); the backward reads the saved r."""

    @staticmethod
    def forward(ctx, x, w, eps, mode):
        y, r = _fwd(x, w, eps, mode, True)
        ctx.save_for_backward(x, w, r)
        ctx.mode = mode
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w, r = ctx.saved_tensors
        dx, dw = _bwd(x, w, r, dy, ctx.mode, ctx.needs_input_grad[1])
        return dx, None if dw is None else dw.to(w.dtype), None, None


def rms_norm_trainable(x: torch.Tensor, w: torch.Tensor, eps: float,
                       mode: str = "model") -> torch.Tensor:
    """Differentiable RMSNorm: x (..., E), w (E,) -> y in x's dtype."""
    _check_mode(mode)
    return RMSNormFn.apply(x, w, eps, mode)
