"""Perceiver resampler, the CalliAlign core (PyTorch port of
callireader_tpu/models/resampler.py).

(B, N, dim) media features -> (B, num_learns, dim): per layer the learned
queries cross-attend over concat(media, learns), then a LayerNorm-MLP; a
final LayerNorm and, for the compact tower, a dim -> out_dim projection into
the token-table space. The attention here is a (3 x ~260) product per head:
plain torch ops, as the JAX package left it to XLA.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from callireader_tpu_torch.core.config import ResamplerConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.models.internvit import layer_norm

Params = Dict[str, Any]
LN_EPS = 1e-5


def forward(
    params: Params,
    cfg: ResamplerConfig,
    x: torch.Tensor,
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
) -> torch.Tensor:
    """-> (B, num_learns, dim or out_dim)."""
    B = x.shape[0]
    H, Dh = cfg.heads, cfg.dim_head
    scale = Dh**-0.5
    cd = policy.compute_dtype
    x = x.to(cd)
    learns = params["learns"].to(cd).expand(B, cfg.num_learns, cfg.dim)
    lp = params["layers"]

    def heads(t):
        return t.reshape(B, t.shape[1], H, Dh).transpose(1, 2)

    for i in range(cfg.depth):
        xm = layer_norm(x, lp["norm_media_scale"][i], lp["norm_media_bias"][i], LN_EPS, policy)
        ln = layer_norm(learns, lp["norm_learns_scale"][i], lp["norm_learns_bias"][i], LN_EPS, policy)
        q = ln @ lp["to_q"][i].to(cd)
        kv = torch.cat([xm, ln], dim=1) @ lp["to_kv"][i].to(cd)
        k, v = kv.chunk(2, dim=-1)
        q, k, v = heads(q), heads(k), heads(v)
        sim = (q * scale).float() @ k.float().transpose(-1, -2)
        sim = sim - sim.amax(dim=-1, keepdim=True)
        attn = torch.softmax(sim, dim=-1).to(v.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, -1, H * Dh)
        learns = out @ lp["to_out"][i].to(cd) + learns

        h = layer_norm(learns, lp["ff_norm_scale"][i], lp["ff_norm_bias"][i], LN_EPS, policy)
        h = h @ lp["ff1"][i].to(cd) + lp["ff1_bias"][i].to(cd)
        h = F.gelu(h, approximate="none")
        h = h @ lp["ff2"][i].to(cd) + lp["ff2_bias"][i].to(cd)
        learns = learns + h
    learns = layer_norm(learns, params["norm_scale"], params["norm_bias"], LN_EPS, policy)
    if cfg.out_dim is not None:
        learns = learns @ params["out_kernel"].to(cd) + params["out_bias"].to(cd)
    return learns
