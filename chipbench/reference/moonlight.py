"""The plain float32 reference of the MLA-MoE page cell: Moonlight-16B-A3B's
language model (moonshotai/Moonlight-16B-A3B, the DeepSeek-V3 block) behind
CalliReader's front half, and the pipeline that works the cell's pages out
again (``PlainMoonlight``).

The LLM as published (modeling_deepseek.py), in plain torch operations,
float32 products with TF32 off (``models.exact``), no kernel, no cache, no
batching; weights read from the tree the benchmark drew (``weights_moe``:
kernels (in, out), layers stacked), each layer widened to float32 only while
it runs, so that the reference fits on the card beside its bf16 tree:

- latent attention, the non-absorbed form: q = h W_q; [c_kv | k_pe] =
  h W_kv_a; c_kv = RMSNorm(c_kv) (eps ``kv_norm_eps``); [k_nope | v] =
  c_kv W_kv_b; the RoPE parts de-interleaved, then rotate-half (the
  published ``apply_rotary_pos_emb``); softmax scale 1 / sqrt(Dqk); causal;
- the first ``first_k_dense_replace`` layers a dense SwiGLU; the rest the
  published ``MoEGate`` (sigmoid scores in fp32, the top k of scores plus the
  correction bias, ``n_group`` = ``topk_group`` = 1 so the group step keeps
  every expert, the chosen scores over their sum plus 1e-20, times
  ``routed_scaling_factor``) and ``moe_infer`` (each expert's SwiGLU, its
  output weighted and summed), plus the shared experts' SwiGLU.

``expert_layer`` runs one expert layer's feed-forward block alone, for the
driver's expert probe, and marks the tokens whose choice lies clear of a tie.

Departures: every product in float32 (the published model runs in bf16); the
RoPE tables in float32 (the published code casts cos / sin to the
activations' dtype). Neither changes the mathematics.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from chipbench import weights, weights_moe
from chipbench.reference import models
from chipbench.reference.ocr import PlainOCR
from chipbench.reference.tokenizer import InternLM2Tokenizer

NEAR_TIE = 2.0 ** -8  # a choice margin a bf16 score could cross: s ~ 0.5 resolves to 2^-9


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """The published RoPE of x (..., S, Dr) at positions (S,): the pairs
    de-interleaved (x0, x2, ..., x1, x3, ...), then rotate-half."""
    D = x.shape[-1]
    x = x.unflatten(-1, (D // 2, 2)).transpose(-1, -2).flatten(-2)
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    ang = positions.float()[:, None] * inv
    cos, sin = torch.cat([ang.cos(), ang.cos()], -1), torch.cat([ang.sin(), ang.sin()], -1)
    return x * cos + torch.cat([-x[..., D // 2:], x[..., :D // 2]], -1) * sin


def attention(p: Dict[str, torch.Tensor], cfg: Dict, h: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Causal latent attention over h (S, E) -> (S, E) (after W_o)."""
    S = h.shape[0]
    H, R, Dr = cfg["num_attention_heads"], cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    Dn, Dv = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
    q = (h @ p["wq"]).view(S, H, Dn + Dr).transpose(0, 1)
    kva = h @ p["wkv_a"]
    c = models.rms_norm(kva[:, :R], p["kv_norm"], cfg["kv_norm_eps"])
    kv = (c @ p["wkv_b"]).view(S, H, Dn + Dv).transpose(0, 1)
    q_pe = rope(q[..., Dn:], positions, cfg["rope_theta"])
    k_pe = rope(kva[None, :, R:], positions, cfg["rope_theta"])
    causal = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    ctx = torch.empty((H, S, Dv), dtype=torch.float32, device=h.device)
    for j in range(0, H, 8):  # heads in groups: the fp32 scores of all 16 at once are large
        s = (q[j:j + 8, :, :Dn] @ kv[j:j + 8, :, :Dn].transpose(-1, -2)
             + q_pe[j:j + 8] @ k_pe.transpose(-1, -2)) * (Dn + Dr) ** -0.5
        ctx[j:j + 8] = torch.softmax(s.masked_fill(~causal, float("-inf")), -1) @ kv[j:j + 8, :, Dn:]
    return ctx.transpose(0, 1).reshape(S, H * Dv) @ p["wo"]


def swiglu(x, w1, w3, w2):
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def choice_margin(choice: torch.Tensor, k: int) -> torch.Tensor:
    """(T,) how far each token's k-th choice (score plus bias) lies above its
    (k + 1)-th."""
    top = torch.topk(choice, k + 1, dim=-1).values
    return top[:, k - 1] - top[:, k]


def moe(p: Dict[str, torch.Tensor], cfg: Dict, h: torch.Tensor,
        stats: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """The routed experts and the shared experts over h (S, E) -> (S, E).
    ``stats``: counts the tokens' choices (``choices``) and those whose last
    chosen and first unchosen expert lie within NEAR_TIE (``near_ties``), where
    a bf16 program may choose otherwise."""
    s = torch.sigmoid(h @ p["gate"])
    choice = s + p["gate_bias"]
    k = cfg["num_experts_per_tok"]
    sel = torch.topk(choice, k, dim=-1).indices
    if stats is not None:
        stats["choices"] = stats.get("choices", 0) + h.shape[0]
        stats["near_ties"] = stats.get("near_ties", 0) + int((choice_margin(choice, k) < NEAR_TIE).sum())
    w = s.gather(1, sel)
    if cfg["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    y = torch.zeros_like(h)
    for e in range(cfg["n_routed_experts"]):
        t, j = (sel == e).nonzero(as_tuple=True)
        if t.numel():
            y.index_add_(0, t, swiglu(h[t], p["w1"][e], p["w3"][e], p["w2"][e]) * w[t, j, None])
    return y + swiglu(h, p["shared_w1"], p["shared_w3"], p["shared_w2"])


def _leaves(tree: Dict, i: int) -> Dict[str, torch.Tensor]:
    return {k: v[i].float() for k, v in tree.items()}


def hidden(tree: Dict, cfg: Dict, x: torch.Tensor, positions: torch.Tensor,
           stats: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """(S, E) float32 input embeddings of one sequence -> its final normed
    hidden (S, E); ``stats`` as ``moe``'s, over every expert layer."""
    eps, Ld = cfg["rms_norm_eps"], cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        p = _leaves(tree["layers"], i)
        x = x + attention(p, cfg, models.rms_norm(x, p["attn_norm"], eps), positions)
        h = models.rms_norm(x, p["ffn_norm"], eps)
        if i < Ld:
            d = _leaves(tree["dense"], i)
            x = x + swiglu(h, d["w1"], d["w3"], d["w2"])
        else:
            x = x + moe(_leaves(tree["moe"], i - Ld), cfg, h, stats)
        del p
    return models.rms_norm(x, tree["norm"].float(), eps)


def expert_layer(tree: Dict, cfg: Dict, j: int, x: torch.Tensor):
    """The feed-forward block of expert layer j (layer first_k_dense_replace
    + j) over x (T, E) float32 -> (x + its routed and shared experts, a (T,)
    mask of the tokens whose choice lies NEAR_TIE or more from a tie)."""
    h = models.rms_norm(x, tree["layers"]["ffn_norm"][cfg["first_k_dense_replace"] + j].float(),
                        cfg["rms_norm_eps"])
    p = _leaves(tree["moe"], j)
    margin = choice_margin(torch.sigmoid(h @ p["gate"]) + p["gate_bias"], cfg["num_experts_per_tok"])
    return x + moe(p, cfg, h), margin >= NEAR_TIE


def logits(tree: Dict, cfg: Dict, h: torch.Tensor) -> torch.Tensor:
    return h @ tree["output"].float().T


class PlainMoonlight(PlainOCR):
    """The reference pipeline of the MLA-MoE configuration for one seed: the
    front half as PlainOCR works it out (box stage, tiles, tile tower), the
    compact char tower drawn as the configuration says, the Moonlight LLM."""

    def __init__(self, cfg: Dict, seed: int, device):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        v, E, V = cfg["vision"], cfg["hidden_size"], cfg["vocab_size"]
        self.vit = weights.draw_vit(v, seed, device)
        self.proj = weights.draw_projector(v["hidden_size"], E, seed, device)
        self.align = weights.draw_align(V, E, seed, device)
        tower = weights_moe.draw_char_tower(cfg, seed, device)
        self.char_cfg, self.res_cfg = cfg["char_tower"]["vision"], cfg["char_tower"]["resampler"]
        self.char_vit, self.char_proj, self.res = tower["char_vision"], tower["char_projector"], tower["resampler"]
        self.det = weights.load_npz_tree(weights.ASSETS / "detector_640.npz", device)
        self.of = weights.load_npz_tree(weights.ASSETS / "orderformer.npz", device)
        self.tok = InternLM2Tokenizer(str(weights.ASSETS / "tokenizer.model"))
        self.llm = weights_moe.draw_llm(cfg, seed, device)

    def image_feats(self, page: np.ndarray) -> torch.Tensor:
        t = self.tiles(page)
        return torch.cat([models.projector(self.proj, models.vit(self.vit, self.cfg["vision"], t[i:i + 4]))
                          for i in range(0, t.shape[0], 4)]).reshape(-1, self.cfg["hidden_size"])

    def logits(self, ids: np.ndarray, img: torch.Tensor, pseudo: Optional[torch.Tensor],
               bucket: int, served: np.ndarray, stats: Optional[Dict[str, int]] = None) -> torch.Tensor:
        """(T, V) float32 logits at the prompt's last position and at each
        served token but the last: the logits that chose served[0 .. T-1].
        Positions as the program gave them: the prompt at 0 .. n - 1, served
        token j at slot ``bucket`` + j."""
        cfg, dev = self.cfg, self.device
        n, T = len(ids), len(served)
        all_ids = torch.from_numpy(np.concatenate([ids, served[:-1].astype(np.int64)])).to(dev)
        x = self.llm["tok_embeddings"][all_ids].float()
        is_img = all_ids[:n] == cfg["img_context_token_id"]
        x[:n][is_img] = img[:int(is_img.sum())]
        if pseudo is not None:
            is_al = all_ids[:n] == cfg["aligned_token_id"]
            x[:n][is_al] = pseudo[:int(is_al.sum())]
        pos = torch.cat([torch.arange(n, device=dev), bucket + torch.arange(T - 1, device=dev)])
        return logits(self.llm, cfg, hidden(self.llm, cfg, x, pos, stats)[n - 1:])

