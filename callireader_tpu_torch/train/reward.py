"""Reward model training (value head over the decoder; PyTorch port of
callireader_tpu/train/reward.py).

Parity target: train/xtuner/model/reward.py:87-490 — InternLM2-style reward
model: scalar value head on top of the final hidden state, Bradley-Terry
ranking loss over (chosen, rejected) pairs, optional linear-RoPE long-context
preparation (:186, mirrored by ``long_context_config``).

Reuses the internlm2 stack; the reward is read at each sequence's last valid
token. The value head ``v_head`` (E, 1) is a leaf of the LLM tree; the train
step trains the leaves that e_it.partition_params marks (the LoRA adapters),
as the JAX step does.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from callireader_tpu_torch.core.config import LLMConfig, VLMConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.models import internlm2
from callireader_tpu_torch.train.e_it import Optimizer, make_step


def add_value_head(params: Dict[str, Any], cfg: LLMConfig, generator: torch.Generator,
                   dtype=torch.float32) -> Dict[str, Any]:
    """A new LLM tree with ``v_head`` ~ N(0, (1 / (E + 1))^2) drawn from
    ``generator`` (on its device)."""
    out = dict(params)
    out["v_head"] = (torch.randn((cfg.hidden_size, 1), generator=generator, dtype=torch.float32,
                                 device=generator.device) * (1.0 / (cfg.hidden_size + 1))).to(dtype)
    return out


def long_context_config(cfg: LLMConfig, target_length: int) -> LLMConfig:
    """Enlarge the usable window with linear RoPE scaling
    (sft.py/reward.py _prepare_for_long_context_training)."""
    return internlm2.prepare_long_context(cfg, target_length)


def sequence_rewards(
    llm_params: Dict[str, Any],
    cfg: LLMConfig,
    batch: Dict[str, torch.Tensor],
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
    remat: bool = False,
) -> torch.Tensor:
    """(B,) scalar rewards at the last valid token of each row."""
    hidden = internlm2.forward(
        llm_params, cfg,
        input_ids=batch["input_ids"],
        segment_ids=batch.get("segment_ids"),
        positions=batch.get("positions"),
        policy=policy, remat=remat, return_hidden=True,
    )
    seg = batch.get("segment_ids")
    if seg is not None:
        lengths = (seg >= 0).sum(dim=-1)
    else:
        lengths = torch.full((hidden.shape[0],), hidden.shape[1], device=hidden.device)
    last = hidden[torch.arange(hidden.shape[0], device=hidden.device), lengths.long() - 1]
    return (last.float() @ llm_params["v_head"].float())[:, 0]


def reward_loss(
    params: Dict[str, Any],
    cfg: VLMConfig,
    batch: Dict[str, torch.Tensor],
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
    remat: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Batch rows stacked [chosen; rejected] (train/dpo.preference_collate)."""
    rewards = sequence_rewards(params["llm"], cfg.llm, batch, policy=policy, remat=remat)
    B = rewards.shape[0] // 2
    chosen, rejected = rewards[:B], rewards[B:]
    loss = -F.logsigmoid(chosen - rejected).mean()
    return loss, {
        "loss": loss,
        "accuracy": (chosen > rejected).float().mean(),
        "margin": (chosen - rejected).mean(),
    }


def make_reward_train_step(
    cfg: VLMConfig,
    tx: Optimizer,
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
) -> Callable:
    """The reward model's step (remat on, as the e-IT recipe's)."""
    return make_step(lambda params, batch: reward_loss(params, cfg, batch, policy=policy,
                                                       remat=True), tx)
