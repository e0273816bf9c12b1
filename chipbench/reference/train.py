"""The plain reference of the e-IT cell: the same drawn weights and micro-
batches, the loss of the recipe (the frozen tile tower's features through the
trainable projector and the pseudo embeddings spliced into the token
embeddings, InternLM2 with LoRA on its seven projections, the shifted cross
entropy over the answer tokens) in float32 with TF32 off, its gradients by
autograd, and the recipe's optimizer written out from its definition:
clip by global norm, AdamW under a linear warm-up from 0 and a cosine decay,
inside an accumulation of ``grad_accum`` micro-batches (the running mean of
their gradients). A trainable leaf keeps the dtype the configuration states
for it: each update is computed in float32 and stored in that dtype.

``fp8=True`` is the control: every product of the LLM takes its operands
rounded to float8 e4m3 (per-tensor absmax scale), the precision below the
configuration's bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from chipbench import weights
from chipbench.reference import models

IGNORE = -100
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def draw_lora(llm_cfg: Dict, rank: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """LoRA leaves as the benchmark hands them to both sides: A ~ N(0, 1) / r
    in float32 (one draw a stacked leaf, in target order), B = 0."""
    r = weights.Draw(seed, "lora", device, torch.float32)
    L, E, M = llm_cfg["num_hidden_layers"], llm_cfg["hidden_size"], llm_cfg["intermediate_size"]
    Hq, Hkv = llm_cfg["num_attention_heads"], llm_cfg["num_key_value_heads"]
    D = E // Hq
    dims = {"wq": (E, Hq * D), "wk": (E, Hkv * D), "wv": (E, Hkv * D), "wo": (Hq * D, E),
            "w1": (E, M), "w3": (E, M), "w2": (M, E)}
    out = {}
    for name in LORA_TARGETS:
        d_in, d_out = dims[name]
        out[f"{name}_lora_a"] = r.normal((L, d_in, rank), 1.0 / rank)
        out[f"{name}_lora_b"] = r.full((L, rank, d_out), 0.0)
    return out


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor absmax scale, the gradient
    passed straight through."""
    s = x.detach().abs().amax().clamp_min(1e-12) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x.detach())


class Optimizer:
    """optax's MultiSteps(chain(clip_by_global_norm, adamw(warm-up cosine)))."""

    def __init__(self, rc: Dict, params: Dict[str, torch.Tensor], dtypes: Dict[str, torch.dtype]):
        self.rc, self.dtypes = rc, dtypes
        self.acc = {k: torch.zeros_like(v) for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.micro = 0
        self.count = 0

    def lr(self, count: int) -> float:
        rc = self.rc
        total = rc["total_steps"]
        warm = max(1, int(total * rc["warmup_ratio"]))
        if count < warm:
            return rc["learning_rate"] * count / warm
        t = min(count - warm, total - warm)
        return rc["learning_rate"] * 0.5 * (1 + math.cos(math.pi * t / (total - warm)))

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]) -> None:
        n = self.micro
        for k, g in grads.items():
            self.acc[k] += (g - self.acc[k]) / (n + 1)
        self.micro += 1
        if self.micro < self.rc["grad_accum"]:
            return
        self.micro = 0
        rc = self.rc
        g = self.acc
        norm = torch.sqrt(sum((x * x).sum() for x in g.values()))
        scale = rc["grad_clip"] / norm if norm >= rc["grad_clip"] else torch.ones_like(norm)
        b1, b2 = rc["betas"]
        lr = self.lr(self.count)
        self.count += 1
        for k in params:
            gk = g[k] * scale
            self.m[k] = b1 * self.m[k] + (1 - b1) * gk
            self.v[k] = b2 * self.v[k] + (1 - b2) * gk * gk
            mh = self.m[k] / (1 - b1 ** self.count)
            vh = self.v[k] / (1 - b2 ** self.count)
            u = mh / (vh.sqrt() + 1e-8) + rc["weight_decay"] * params[k]
            params[k].copy_((params[k] - lr * u).to(self.dtypes[k]).float())
            self.acc[k].zero_()


class PlainEIT:
    """The reference e-IT step of a configuration for one seed."""

    def __init__(self, cfg: Dict, seed: int, device, fp8_products: bool = False):
        self.cfg, self.fp8 = cfg, fp8_products
        rc = cfg["recipe"]
        self.llm = weights.draw_llm(cfg["llm"], seed, device)
        self.vit = weights.draw_vit(cfg["vision"], seed, device)
        proj = weights.draw_projector(cfg["vision"]["hidden_size"], cfg["llm"]["hidden_size"], seed, device)
        lora = draw_lora(cfg["llm"], rc["lora_rank"], seed, device)
        self.params = {f"projector/{k}": v.float() for k, v in proj.items()}
        self.params.update({f"llm/layers/{k}": v.float() for k, v in lora.items()})
        self.dtypes = {k: (proj[k.split("/")[-1]].dtype if k.startswith("projector/") else torch.float32)
                       for k in self.params}
        self.scale = rc["lora_alpha"] / rc["lora_rank"]
        self.opt = Optimizer(rc, self.params, self.dtypes)

    def _layer(self, W, cfg, i, x, positions, segments, lora):
        if not self.fp8:
            return models.llm_layer(W, cfg, i, x, positions, segments, lora)
        return models.llm_layer(lambda n, j: fp8(W(n, j)) if "norm" not in n else W(n, j),
                                cfg, i, fp8(x), positions, segments, lora)

    def loss(self, mb: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg, llm = self.cfg, self.cfg["llm"]
        ids = mb["input_ids"]
        x = self.llm["tok_embeddings"][ids].float()
        with torch.no_grad():
            t = mb["pixel_values"]
            hid = torch.cat([models.vit(self.vit, cfg["vision"], t[i:i + 4]) for i in range(0, t.shape[0], 4)])
        proj = {k.split("/")[-1]: v for k, v in params.items() if k.startswith("projector/")}
        img = models.projector(proj, hid).reshape(-1, llm["hidden_size"])
        flat = x.reshape(-1, x.shape[-1])
        flat_ids = ids.reshape(-1)
        slots = torch.nonzero(flat_ids == cfg["img_context_token_id"])[:, 0]
        flat = flat.index_put((slots,), img[:len(slots)])
        slots = torch.nonzero(flat_ids == cfg["aligned_token_id"])[:, 0]
        flat = flat.index_put((slots,), mb["pseudo_embeds"][:len(slots)].float())
        x = flat.reshape(x.shape)
        lora = {name: (params[f"llm/layers/{name}_lora_a"], params[f"llm/layers/{name}_lora_b"])
                for name in LORA_TARGETS}
        lora["scale"] = self.scale
        W = models.plain_weight(self.llm)
        S = x.shape[1]
        pos = torch.arange(S, device=x.device)
        seg = mb["segment_ids"].long()

        def layer(W_, c, i, h, p, s, lr):
            return checkpoint(self._layer, W_, c, i, h, p, s, lr, use_reentrant=False)

        h = models.llm_hidden(W, llm, x, pos, seg, lora, layer_fn=layer)
        head = W("output", None)
        logits = (fp8(h) @ fp8(head).T) if self.fp8 else h @ head.T
        labels = mb["labels"][:, 1:].long()
        valid = labels != IGNORE
        logp = torch.log_softmax(logits[:, :-1], dim=-1)
        ll = torch.gather(logp, -1, torch.where(valid, labels, 0)[..., None])[..., 0]
        return -(ll * valid).sum() / valid.sum().clamp(min=1)

    def step(self, mb: Dict[str, torch.Tensor]):
        """One micro-step -> (loss, this micro-batch's gradients); the
        optimizer's accumulation and update applied."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        loss = self.loss(mb, leaves)
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()), allow_unused=True,
                                                     materialize_grads=True)))
        self.opt.step(grads, self.params)
        return loss.item(), grads


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep: List[str]) -> float:
    """The worst leaf's gap between the program's norm and the reference's,
    against the reference's norm of that leaf or of the median leaf,
    whichever is larger."""
    norms = sorted(ref[k] for k in keep)
    median = norms[len(norms) // 2]
    return max(abs(prog[k] - ref[k]) / max(ref[k], median, 1e-30) for k in keep)


def token_count(mb: Dict[str, torch.Tensor]) -> int:
    return int((mb["segment_ids"] >= 0).sum())


def loss_gaps(prog: List[float], ref: List[float]) -> float:
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))
