"""On-device bicubic char-crop resize (PyTorch port of
callireader_tpu/vision/device_resize.py).

Raw crops ship as bytes; each crop's [200, 350]-rule scale and the white
canvas are applied on the device as two batched matmuls with per-crop weight
matrices built from the (h, w, nh, nw) scalars:

    canvas = clip(round(W_y @ raw @ W_x^T), 0, 255)   # white outside

Rows of W are the 4-tap Keys cubic with a = -0.5 (PIL BICUBIC's kernel);
out-of-range taps are dropped and the row renormalised. This is NOT
``F.interpolate(mode="bicubic")``, which uses a = -0.75.
"""

from __future__ import annotations

from typing import Tuple

import torch

CHAR_RAW_BUCKETS = (48, 64, 96, 128, 192, 256, 352)


def _cubic(t: torch.Tensor, a: float = -0.5) -> torch.Tensor:
    at = t.abs()
    at2 = at * at
    at3 = at2 * at
    w1 = (a + 2.0) * at3 - (a + 3.0) * at2 + 1.0
    w2 = a * at3 - 5.0 * a * at2 + 8.0 * a * at - 4.0 * a
    return torch.where(at <= 1.0, w1, torch.where(at < 2.0, w2, torch.zeros_like(at)))


def _axis_weights(
    out_size: int, raw_bucket: int, src_len: torch.Tensor, dst_len: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(W (N, out, R) f32, inside (N, out) bool) for one axis of N crops."""
    dev = src_len.device
    src = src_len.float()[:, None]
    dst = dst_len.float()[:, None]
    y = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :]
    off = torch.floor((out_size - dst) / 2.0)
    yy = y - off
    inside = (yy >= 0) & (yy < dst)
    u = (yy + 0.5) * (src / dst) - 0.5
    i0 = torch.floor(u).to(torch.int32)
    cols = torch.arange(raw_bucket, dtype=torch.int32, device=dev)
    hi = torch.clamp(src_len.to(torch.int32) - 1, min=0)[:, None]
    W = torch.zeros((src.shape[0], out_size, raw_bucket), dtype=torch.float32, device=dev)
    for t in range(-1, 3):
        idx = i0 + t
        w = torch.where((idx >= 0) & (idx <= hi), _cubic(u - idx.float()), torch.zeros_like(u))
        idxc = torch.minimum(torch.clamp(idx, min=0), hi)
        W = W + w[..., None] * (idxc[..., None] == cols).float()
    s = W.sum(dim=-1, keepdim=True)
    W = W / torch.where(s.abs() < 1e-8, torch.ones_like(s), s)
    return W * inside[..., None].float(), inside


def bicubic_canvas(
    raw: torch.Tensor,  # (N, R, R) or (N, R, R, C) uint8, valid region [:h, :w]
    src_hw: torch.Tensor,  # (N, 2) int32 (h, w)
    tgt_hw: torch.Tensor,  # (N, 2) int32 (nh, nw)
    out_size: int,
) -> torch.Tensor:
    """-> (N, out_size, out_size[, C]) uint8 white canvases."""
    R = raw.shape[1]
    Wy, in_y = _axis_weights(out_size, R, src_hw[:, 0], tgt_hw[:, 0])
    Wx, in_x = _axis_weights(out_size, R, src_hw[:, 1], tgt_hw[:, 1])
    x = raw.float()
    if x.ndim == 3:
        out = Wy @ x @ Wx.transpose(1, 2)
        mask = in_y[:, :, None] & in_x[:, None, :]
    else:
        out = torch.einsum("nyr,nrsc,nxs->nyxc", Wy, x, Wx)
        mask = (in_y[:, :, None] & in_x[:, None, :])[..., None]
    out = torch.where(mask, out, torch.full_like(out, 255.0))
    return torch.clamp(torch.round(out), 0.0, 255.0).to(torch.uint8)
