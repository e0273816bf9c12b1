"""Ulysses sequence parallelism over a mesh axis (PyTorch port of
callireader_tpu/parallel/ulysses.py).

Parity target: train/xtuner/parallel/sequence/ of the reference: the
autograd all_to_all (comm.py:9-87) and the attention's head / sequence
exchange (attention.py:16-127). Each rank of the "seq" axis holds S/sp
positions of every head; an all_to_all gives it the whole sequence for H/sp
heads, attention runs, and the reverse exchange brings its positions back.
The exchange is a ``torch.autograd.Function`` whose backward is the reverse
exchange of the grads (equal splits: the same ``all_to_all_single``). Where
sp does not divide the head count (gcd(H, sp) < sp) the inner-SP route of
the reference (setup_distributed.py:56-79) splits head_dim so that the
exchange divides, then gathers the full head_dim over each inner group of
insp = sp / gcd(H, sp) ranks, so that attention still runs on whole heads.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from callireader_tpu_torch.core.partition import Mesh
from callireader_tpu_torch.kernels.attention import attention_reference, flash_attention
from callireader_tpu_torch.kernels.attention_bwd import flash_attention_trainable
from callireader_tpu_torch.parallel import spmd


def _a2a(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """all_to_all_single over equal splits of dim 0; the backward is the
    same exchange of the grads."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllToAll.apply(x, group)
    return _a2a(x, group)


def _a2a_gather_seq(x: torch.Tensor, sp: int, group) -> torch.Tensor:
    """(B, H, S/sp, D) local -> (B, H/sp, S, D): scatter heads, gather seq."""
    B, H, Sl, D = x.shape
    t = x.reshape(B, sp, H // sp, Sl, D).permute(1, 0, 2, 3, 4)
    t = _exchange(t, group)  # [j] = rank j's positions of my heads
    return t.permute(1, 2, 0, 3, 4).reshape(B, H // sp, sp * Sl, D)


def _a2a_gather_heads(x: torch.Tensor, sp: int, group) -> torch.Tensor:
    """(B, H/sp, S, D) -> (B, H, S/sp, D): scatter seq, gather heads."""
    B, Hl, S, D = x.shape
    t = x.reshape(B, Hl, sp, S // sp, D).permute(2, 0, 1, 3, 4)
    t = _exchange(t, group)  # [j] = rank j's heads of my positions
    return t.permute(1, 0, 2, 3, 4).reshape(B, sp * Hl, S // sp, D)


def ulysses_attention(
    q: torch.Tensor,  # (B, Hq, S/sp, D): this rank's positions
    k: torch.Tensor,  # (B, Hkv, S/sp, D)
    v: torch.Tensor,
    mesh: Mesh,
    *,
    seq_axis: str = "seq",
    causal: bool = True,
    use_flash: bool = False,
    training: Optional[bool] = None,
) -> torch.Tensor:
    """Sequence-parallel attention -> (B, Hq, S/sp, D), this rank's
    positions. GQA KV heads are repeated to Hq first, as in the JAX module.
    ``use_flash``: the gathered heads go through the port's kernels, the
    trainable e-IT forward / backward pair where autograd tracks q
    (``training``, default: q.requires_grad), else the prefill kernel; off,
    the plain attention."""
    sp = mesh.axis_size(seq_axis)
    group = mesh.group(seq_axis)
    Hq, Hkv = q.shape[1], k.shape[1]
    if Hq != Hkv:
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
    insp = sp // math.gcd(Hq, sp)
    B, H, Sl, D = q.shape
    if (H * insp) % sp or D % insp:
        raise ValueError(f"Ulysses: {H} heads of width {D} do not split over seq={sp}")

    def pre_inner(t):
        # (B, H, S, D) -> (B, sp/insp, H*insp/sp, S, insp, D/insp) -> (B, insp*H, S, D/insp)
        t = t.reshape(B, sp // insp, H * insp // sp, Sl, insp, D // insp)
        return t.permute(0, 1, 4, 2, 3, 5).reshape(B, H * insp, Sl, D // insp)

    def post_inner(t):
        _, _, Sp_, Dp = t.shape
        t = t.reshape(B, sp // insp, insp, H * insp // sp, Sp_, Dp)
        return t.permute(0, 1, 3, 4, 2, 5).reshape(B, H, Sp_, Dp * insp)

    if insp > 1:
        q, k, v = pre_inner(q), pre_inner(k), pre_inner(v)
    qg, kg, vg = (_a2a_gather_seq(t, sp, group) for t in (q, k, v))
    rank = mesh.rank(seq_axis)
    if insp > 1:
        # the full head_dim from the inner group (every inner rank then holds
        # the same whole heads): gathered over the axis, the group's kept
        lo = (rank // insp) * insp

        def gather_hd(t):
            full = spmd.all_gather(t, mesh, seq_axis, 3)
            w = t.shape[3]
            return full[..., lo * w:(lo + insp) * w]

        qg, kg, vg = gather_hd(qg), gather_hd(kg), gather_hd(vg)

    scale = D ** -0.5  # the original head_dim
    if training is None:
        training = torch.is_grad_enabled() and qg.requires_grad
    if use_flash and training:
        ctx = flash_attention_trainable(qg.contiguous(), kg.contiguous(), vg.contiguous(), None,
                                        None, causal, scale)
    elif use_flash:
        ctx = flash_attention(qg.contiguous(), kg.contiguous(), vg.contiguous(), causal=causal,
                              scale=scale)
    else:
        ctx = attention_reference(qg, kg, vg, causal=causal, scale=scale)

    if insp > 1:
        # this rank's head_dim slice before the reverse exchange
        w = ctx.shape[-1] // insp
        ctx = ctx[..., (rank % insp) * w:(rank % insp + 1) * w]
    ctx = _a2a_gather_heads(ctx, sp, group)
    if insp > 1:
        ctx = post_inner(ctx)
    return ctx


def split_for_sequence_parallel(x: torch.Tensor, mesh: Mesh, seq_axis: str = "seq",
                                dim: int = 1) -> torch.Tensor:
    """This rank's part of ``x``'s sequence dim (sft.py's
    _split_for_sequence_parallel): block ``rank`` of sp along ``dim``."""
    sp, r = mesh.axis_size(seq_axis), mesh.rank(seq_axis)
    n = x.shape[dim] // sp
    if x.shape[dim] % sp:
        raise ValueError(f"sequence of {x.shape[dim]} does not split over {seq_axis}={sp}")
    return x.narrow(dim, r * n, n)


def reduce_sequence_parallel_loss(loss_sum: torch.Tensor, num_tokens: torch.Tensor,
                                  mesh: Optional[Mesh] = None, seq_axis: str = "seq") -> torch.Tensor:
    """Token-weighted loss over the seq ranks (reduce_loss.py:8-35): the
    summed loss and token counts added over the axis (the loss's backward
    passes through, as each rank's own tokens' share)."""
    if mesh is None:
        return loss_sum / torch.clamp(num_tokens, min=1)
    total = spmd.all_reduce(loss_sum.clone(), mesh, seq_axis)
    count = num_tokens.detach().clone()
    dist.all_reduce(count, group=mesh.group(seq_axis))
    return total / torch.clamp(count, min=1)
