"""Cosine VQ, hard-VQ blend, Gaussian denorm and the embed splice (PyTorch
port of callireader_tpu/align/vq.py)."""

from __future__ import annotations

from typing import Tuple

import torch


def normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize semantics (clamp-by-norm)."""
    xf = x.float()
    n = torch.linalg.vector_norm(xf, dim=dim, keepdim=True)
    return (xf / n.clamp_min(eps)).to(x.dtype)


def vq_cos_sim(embedding_table: torch.Tensor, inputs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(V, E) table, (B, n, E) inputs -> (indices (B, n) int32, cos (B, n) f32)."""
    x = normalize(inputs, dim=2).float()
    t = normalize(embedding_table, dim=1).float()
    sim = torch.einsum("bne,ve->bnv", x, t)
    idx = sim.argmax(dim=2)  # first maximum, as jnp.argmax
    return idx.to(torch.int32), sim.gather(2, idx[..., None])[..., 0]


def gaussian_denorm(outputs, indices, mu, sigma) -> torch.Tensor:
    """pred * sigma[idx] + mu[idx], row-wise."""
    idx = indices.long()
    m = mu.reshape(-1)[idx][..., None].to(outputs.dtype)
    s = sigma.reshape(-1)[idx][..., None].to(outputs.dtype)
    return outputs * s + m


def hard_vq_blend(outputs, indices, cos_vals, embedding_table, threshold: float = 0.5):
    below = (cos_vals <= threshold)[..., None]
    quantized = embedding_table[indices.long()].to(outputs.dtype)
    return torch.where(below, quantized, outputs)


def calli_align_embed(
    resampler_out: torch.Tensor,
    embedding_table: torch.Tensor,
    mu: torch.Tensor,
    sigma: torch.Tensor,
    *,
    hard_vq: bool = False,
    hard_vq_threshold: float = 0.5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (pseudo_embeds (B*n, E), indices (B, n))."""
    indices, vals = vq_cos_sim(embedding_table, resampler_out)
    out = resampler_out
    if hard_vq:
        out = hard_vq_blend(out, indices, vals, embedding_table, hard_vq_threshold)
    out = gaussian_denorm(out, indices, mu, sigma)
    return out.reshape(-1, out.shape[-1]), indices


def splice_embeds(
    inputs_embeds: torch.Tensor,  # (B, S, E)
    input_ids: torch.Tensor,  # (B, S)
    replacement: torch.Tensor,  # (N, E) in order of appearance
    token_id: int,
) -> torch.Tensor:
    """Rows where input_ids == token_id take replacement rows in row-major
    slot order across the batch; extra replacement rows are ignored."""
    B, S, E = inputs_embeds.shape
    flat = inputs_embeds.reshape(-1, E)
    is_slot = input_ids.reshape(-1) == token_id
    rank = torch.cumsum(is_slot.to(torch.int64), 0) - 1
    gathered = replacement[rank.clamp(0, replacement.shape[0] - 1)].to(flat.dtype)
    return torch.where(is_slot[:, None], gathered, flat).reshape(B, S, E)
