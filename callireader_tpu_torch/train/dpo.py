"""Preference optimization: DPO and ORPO (PyTorch port of
callireader_tpu/train/dpo.py).

Parity targets:
  - train/xtuner/model/dpo.py:39-286 (DPO with varlen/SP-aware logp gathering)
  - train/xtuner/model/orpo.py (odds-ratio preference optimization)
  - dataset/collate_fns/preference_collate_fn.py (chosen/rejected pairing)

Chosen and rejected sequences ride one batch (stacked [chosen; rejected])
through a single forward; the frozen reference policy is the same weights
with the LoRA adapters stripped (no second model copy on the device: with
LoRA the base weights ARE the reference), and its forward runs under
``torch.no_grad()``, so none of its activations are kept. The log-softmax
over the vocabulary is taken in fp32, as the JAX loss takes it.

The train step is e_it.make_step over the loss: the trainable leaves'
gradients by ``torch.autograd.grad``, then the e_it.Optimizer's update in
place (its metrics add the gradients' global norm to the JAX step's).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from callireader_tpu_torch.core.config import VLMConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.models import internlm2
from callireader_tpu_torch.train.e_it import IGNORE_INDEX, Optimizer, make_step


@dataclasses.dataclass(frozen=True)
class DPOConfig:
    beta: float = 0.1
    label_smoothing: float = 0.0
    loss_type: str = "sigmoid"  # or "orpo"
    orpo_lambda: float = 0.1


def _strip_lora(llm_params: Dict[str, Any]) -> Dict[str, Any]:
    layers = {k: v for k, v in llm_params["layers"].items()
              if "_lora_" not in k and k != "lora_scale"}
    out = dict(llm_params)
    out["layers"] = layers
    return out


def sequence_logps(
    llm_params: Dict[str, Any],
    cfg: VLMConfig,
    batch: Dict[str, torch.Tensor],
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sequence sum log p(response tokens) and token counts.
    batch rows: [chosen_0..chosen_{B-1}, rejected_0..rejected_{B-1}]."""
    logits = internlm2.forward(
        llm_params, cfg.llm,
        input_ids=batch["input_ids"],
        segment_ids=batch.get("segment_ids"),
        positions=batch.get("positions"),
        policy=policy, remat=remat,
    )
    shift_labels = batch["labels"][:, 1:].long()
    valid = shift_labels != IGNORE_INDEX
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    del logits
    tok_ll = torch.gather(logp, -1, torch.where(valid, shift_labels, 0)[..., None])[..., 0]
    seq_ll = (tok_ll * valid).sum(dim=-1)
    return seq_ll, valid.sum(dim=-1)


def dpo_loss(
    params: Dict[str, Any],
    cfg: VLMConfig,
    batch: Dict[str, torch.Tensor],
    dpo_cfg: DPOConfig,
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    llm = params["llm"]
    pol_ll, counts = sequence_logps(llm, cfg, batch, policy=policy, remat=remat)
    B = pol_ll.shape[0] // 2
    pol_chosen, pol_rejected = pol_ll[:B], pol_ll[B:]

    if dpo_cfg.loss_type == "orpo":
        # ORPO: NLL on chosen + odds-ratio penalty; no reference model
        mean_chosen_ll = pol_chosen / counts[:B].clamp(min=1)
        mean_rejected_ll = pol_rejected / counts[B:].clamp(min=1)
        log_odds = (mean_chosen_ll - mean_rejected_ll) - (
            torch.log1p(-torch.exp(mean_chosen_ll.clamp(-20, -1e-4)))
            - torch.log1p(-torch.exp(mean_rejected_ll.clamp(-20, -1e-4)))
        )
        ratio_loss = -F.logsigmoid(log_odds)
        nll = -mean_chosen_ll
        loss = (nll + dpo_cfg.orpo_lambda * ratio_loss).mean()
        margin = (mean_chosen_ll - mean_rejected_ll).mean()
        acc = (mean_chosen_ll > mean_rejected_ll).float().mean()
        return loss, {"loss": loss, "margin": margin, "accuracy": acc}

    with torch.no_grad():
        ref_ll, _ = sequence_logps(_strip_lora(llm), cfg, batch, policy=policy)
    ref_chosen, ref_rejected = ref_ll[:B], ref_ll[B:]

    pol_logratio = pol_chosen - pol_rejected
    ref_logratio = ref_chosen - ref_rejected
    logits_diff = dpo_cfg.beta * (pol_logratio - ref_logratio)
    ls = dpo_cfg.label_smoothing
    loss = (
        -F.logsigmoid(logits_diff) * (1 - ls)
        - F.logsigmoid(-logits_diff) * ls
    ).mean()
    reward_margin = (dpo_cfg.beta * (pol_chosen - ref_chosen)
                     - dpo_cfg.beta * (pol_rejected - ref_rejected)).mean()
    acc = (logits_diff > 0).float().mean()
    return loss, {"loss": loss, "reward_margin": reward_margin, "accuracy": acc}


def make_dpo_train_step(
    cfg: VLMConfig,
    dpo_cfg: DPOConfig,
    tx: Optimizer,
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
) -> Callable:
    """The DPO / ORPO step (remat on, as the e-IT recipe's)."""
    return make_step(lambda params, batch: dpo_loss(params, cfg, batch, dpo_cfg, policy=policy,
                                                    remat=True), tx)


def preference_collate(
    pairs, tokenizer, max_len_buckets=(256, 512, 1024, 2048), pad_token_id: int = 2
) -> Dict[str, np.ndarray]:
    """pairs: [{"prompt", "chosen", "rejected"}]. Builds the stacked
    [chosen; rejected] batch with IGNORE labels on prompts."""
    rows = []
    for key in ("chosen", "rejected"):
        for p in pairs:
            prompt_ids = tokenizer.encode(p["prompt"], add_bos=True)
            resp_ids = tokenizer.encode(p[key], add_bos=False)
            ids = prompt_ids + resp_ids
            labels = [IGNORE_INDEX] * len(prompt_ids) + resp_ids
            rows.append((np.asarray(ids, np.int32), np.asarray(labels, np.int32)))

    max_len = max(len(r[0]) for r in rows)
    S = next(b for b in max_len_buckets if b >= max_len)
    B = len(rows)
    input_ids = np.full((B, S), pad_token_id, np.int32)
    labels = np.full((B, S), IGNORE_INDEX, np.int32)
    seg = np.full((B, S), -1, np.int32)
    pos = np.zeros((B, S), np.int32)
    for i, (ids, lbl) in enumerate(rows):
        n = len(ids)
        input_ids[i, :n] = ids
        labels[i, :n] = lbl
        seg[i, :n] = 0
        pos[i, :n] = np.arange(n)
    return {"input_ids": input_ids, "labels": labels, "segment_ids": seg, "positions": pos}
