"""e-IT (embedding instruction tuning) trainer (PyTorch port of
callireader_tpu/train/e_it.py).

The loss splices pre-computed pseudo-text embeddings at [UNUSED_TOKEN_140]
slots and the frozen ViT's image embeddings (through the trainable
projector) at <IMG_CONTEXT> slots, runs the LLM and takes the shifted cross
entropy. Trainable: every leaf whose key contains ``_lora_`` plus the whole
``projector``; everything else is frozen and gets no gradient (the step asks
autograd for the trainable leaves' gradients only, so no tensor gets a
``.grad``).

The optimizer is optax's ``chain(clip_by_global_norm, adamw(warmup_cosine))``
inside ``MultiSteps(grad_accum)``, written out as tensor code with optax's
arithmetic: clipping scales by ``max_norm / norm`` only when the norm is not
below ``max_norm``; the schedule starts at lr 0, warms up linearly over
``max(1, int(total * warmup_ratio))`` updates and decays by a cosine over the
rest; AdamW's moments keep each leaf's dtype and its decoupled decay applies
to every trainable leaf; MultiSteps keeps the running mean of the micro-batch
gradients and advances the schedule once per ``grad_accum`` micro-batches.
Unlike the JAX step, which returns new arrays, the update is written into
the parameter and moment tensors in place (the 8b LoRA tree and its moments
are ~5 GB). No mesh: the ZeRO sharding of the JAX trainer waits for the
port's parallel layer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from callireader_tpu_torch.align import vq as vq_mod
from callireader_tpu_torch.core.config import VLMConfig
from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from callireader_tpu_torch.models import internlm2, internvit, projector

IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 5e-5
    weight_decay: float = 0.05
    betas: Tuple[float, float] = (0.9, 0.999)
    warmup_ratio: float = 0.03
    total_steps: int = 1000
    grad_clip: float = 1.0
    lora_rank: int = 128
    lora_alpha: float = 256.0
    train_mlp1: bool = True
    remat: bool = True
    # micro-batches per optimizer update (accumulative_counts of the recipe)
    grad_accum: int = 1


# ---------------------------------------------------------------------------
# trainable / frozen partition
# ---------------------------------------------------------------------------


def _is_trainable_path(path: Tuple[str, ...], train_cfg: TrainConfig) -> bool:
    if any("_lora_" in k for k in path):
        return True
    return bool(train_cfg.train_mlp1 and path and path[0] == "projector")


def _split(tree, path, train_cfg):
    if isinstance(tree, dict):
        pairs = {k: _split(v, path + (k,), train_cfg) for k, v in tree.items()}
        return {k: t for k, (t, _) in pairs.items()}, {k: f for k, (_, f) in pairs.items()}
    if isinstance(tree, (list, tuple)):
        pairs = [_split(v, path + (str(i),), train_cfg) for i, v in enumerate(tree)]
        return type(tree)(t for t, _ in pairs), type(tree)(f for _, f in pairs)
    return (tree, None) if _is_trainable_path(path, train_cfg) else (None, tree)


def partition_params(params: Dict[str, Any], train_cfg: TrainConfig):
    """Split into (trainable, frozen) trees of the same structure; a leaf
    absent from one is None there, and the two merge losslessly."""
    return _split(params, (), train_cfg)


def merge_params(trainable, frozen):
    if isinstance(trainable, dict):
        return {k: merge_params(trainable[k], frozen[k]) for k in trainable}
    if isinstance(trainable, (list, tuple)):
        return type(trainable)(merge_params(a, b) for a, b in zip(trainable, frozen))
    return trainable if trainable is not None else frozen


def clone_tree(tree, requires_grad: bool):
    """A copy of a tree of tensors (dicts and lists), detached, each leaf
    ``requires_grad`` as asked: a trainer's own parameters, or a snapshot."""
    if isinstance(tree, dict):
        return {k: clone_tree(v, requires_grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [clone_tree(v, requires_grad) for v in tree]
    return tree.detach().clone().requires_grad_(requires_grad)


def flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Tree -> {"a/b/c": leaf}, None holes dropped."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {} if tree is None else {prefix: tree}
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def eit_loss(
    params: Dict[str, Any],
    cfg: VLMConfig,
    batch: Dict[str, torch.Tensor],
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
    remat: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch (tensors on the model's device):
      input_ids   (B, S) int   right-padded with the pad id
      labels      (B, S) int   IGNORE_INDEX on prompt and pad
      segment_ids (B, S) int   0 on tokens, -1 on pad
      positions   (B, S) int
      pixel_values (T, H, W, 3) uint8 or normalised float: every tile of the batch in order
      pseudo_embeds (P, E)     every pseudo token of the batch in order
    -> (loss, {"loss", "n_tokens"})."""
    input_ids = batch["input_ids"]
    labels = batch["labels"]
    embeds = internlm2.embed_tokens(params["llm"], input_ids, policy.compute_dtype)
    if "pixel_values" in batch:
        # the towers are frozen in e-IT: no graph through the ViT
        with torch.no_grad():
            hidden = internvit.forward(params["vision"], cfg.vision, batch["pixel_values"],
                                       policy=policy)
        img_embeds = projector.extract_feature(params["projector"], hidden, cfg, policy=policy)
        embeds = vq_mod.splice_embeds(embeds, input_ids, img_embeds.reshape(-1, img_embeds.shape[-1]),
                                      cfg.img_context_token_id)
    if "pseudo_embeds" in batch:
        embeds = vq_mod.splice_embeds(embeds, input_ids, batch["pseudo_embeds"], cfg.aligned_token_id)

    logits = internlm2.forward(
        params["llm"], cfg.llm, inputs_embeds=embeds, segment_ids=batch.get("segment_ids"),
        positions=batch.get("positions"), policy=policy, remat=remat)
    shift_labels = labels[:, 1:].long()
    valid = shift_labels != IGNORE_INDEX
    logp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    token_ll = torch.gather(logp, -1, torch.where(valid, shift_labels, 0)[..., None])[..., 0]
    n_valid = valid.sum().clamp(min=1)
    loss = -(token_ll * valid).sum() / n_valid
    return loss, {"loss": loss, "n_tokens": n_valid}


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


def cosine_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Callable[[int], float]:
    """optax.cosine_decay_schedule(init_value, decay_steps, alpha): from
    init_value down to alpha * init_value over decay_steps, then flat."""
    if decay_steps <= 0:
        raise ValueError(f"the cosine decay needs decay_steps > 0, got {decay_steps}")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay_steps)) + alpha)

    return schedule


def join_schedules(schedules: Sequence[Callable[[int], float]],
                   boundaries: Sequence[int]) -> Callable[[int], float]:
    """optax.join_schedules: past each boundary the next schedule runs on
    the count since that boundary."""

    def schedule(count: int) -> float:
        out = schedules[0](count)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = sched(count - boundary)
        return out

    return schedule


def warmup_cosine_schedule(peak: float, warmup: int, total_steps: int,
                           end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, total_steps,
    end_value): linear from 0 to peak over warmup steps, then a cosine to
    end_value at total_steps, flat after."""
    decay = total_steps - warmup
    if decay <= 0:
        raise ValueError(f"the cosine decay needs total_steps > warmup ({total_steps} "
                         f"<= {warmup})")
    alpha = end_value / peak if peak else 0.0

    def schedule(count: int) -> float:
        if count < warmup:
            return peak * min(max(count, 0), warmup) / warmup
        t = min(count - warmup, decay)
        return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t / decay)) + alpha)

    return schedule


def lr_schedule(train_cfg: TrainConfig) -> Callable[[int], float]:
    """The e-IT schedule: warmup_cosine_schedule over total_steps, warmup =
    max(1, int(total_steps * warmup_ratio))."""
    warmup = max(1, int(train_cfg.total_steps * train_cfg.warmup_ratio))
    return warmup_cosine_schedule(train_cfg.learning_rate, warmup, train_cfg.total_steps)


def global_norm(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads.values()))


class Optimizer:
    """[clip_by_global_norm(grad_clip) ->] AdamW(schedule, betas, eps,
    weight_decay) on flat {path: tensor} trees, inside MultiSteps(grad_accum)
    when grad_accum > 1: optax's chain, step for step. No clipping where
    ``grad_clip`` is None. ``update`` writes the parameters and the state in
    place."""

    def __init__(self, schedule: Callable[[int], float], *, betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0, grad_clip: Optional[float] = None,
                 grad_accum: int = 1):
        self.schedule, self.betas, self.eps = schedule, betas, eps
        self.weight_decay, self.grad_clip, self.grad_accum = weight_decay, grad_clip, grad_accum

    def init(self, params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        zeros = lambda: {k: torch.zeros_like(v, memory_format=torch.contiguous_format)
                         for k, v in params.items()}
        state: Dict[str, Any] = {"count": 0, "mu": zeros(), "nu": zeros()}
        if self.grad_accum > 1:
            state.update(mini_step=0, gradient_step=0, acc_grads=zeros())
        return state

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], state: Dict[str, Any],
               params: Dict[str, torch.Tensor]) -> None:
        k = self.grad_accum
        if k == 1:
            self._apply(grads, state, params)
            return
        n = state["mini_step"]
        for path, acc in state["acc_grads"].items():
            acc.add_((grads[path] - acc) / (n + 1))  # the running mean of the micro grads
        if n < k - 1:
            state["mini_step"] = n + 1
            return
        self._apply(state["acc_grads"], state, params)
        for acc in state["acc_grads"].values():
            acc.zero_()
        state["mini_step"] = 0
        state["gradient_step"] += 1

    def _apply(self, grads, state, params) -> None:
        max_norm = self.grad_clip
        if max_norm is not None:
            g_norm = global_norm(grads)
            keep = g_norm < max_norm
        b1, b2 = self.betas
        count = state["count"] + 1
        lr = self.schedule(state["count"])
        one = torch.ones((), dtype=torch.float32)
        bc1, bc2 = 1 - (one * b1) ** count, 1 - (one * b2) ** count
        for path, g in grads.items():
            p, mu, nu = params[path], state["mu"][path], state["nu"][path]
            if max_norm is not None:
                g = torch.where(keep, g, (g / g_norm.to(g.dtype)) * max_norm)
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            u = (mu / bc1.to(mu.device, mu.dtype)) / (
                torch.sqrt(nu / bc2.to(nu.device, nu.dtype)) + self.eps)
            u = u + self.weight_decay * p
            p.add_(torch.tensor(-lr, dtype=u.dtype, device=u.device) * u)
        state["count"] = count


def make_optimizer(train_cfg: TrainConfig) -> Optimizer:
    """The e-IT optimizer: clip, then AdamW (eps 1e-8) under ``lr_schedule``."""
    return Optimizer(lr_schedule(train_cfg), betas=train_cfg.betas, eps=1e-8,
                     weight_decay=train_cfg.weight_decay, grad_clip=train_cfg.grad_clip,
                     grad_accum=train_cfg.grad_accum)


# ---------------------------------------------------------------------------
# train state / step
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class TrainState:
    trainable: Any  # the params tree with None for every frozen leaf
    opt_state: Dict[str, Any]
    step: int  # micro-batches taken


def create_train_state(params, train_cfg: TrainConfig):
    """-> (state, frozen, optimizer). The trainable leaves are marked
    ``requires_grad`` in place."""
    trainable, frozen = partition_params(params, train_cfg)
    flat = flatten(trainable)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    tx = make_optimizer(train_cfg)
    return TrainState(trainable, tx.init(flat), 0), frozen, tx


def make_step(loss_fn: Callable, tx: Optimizer) -> Callable:
    """``train_step(state, frozen, batch) -> (state, metrics)`` for one
    micro-batch of ``loss_fn(params, batch) -> (loss, metrics)`` on the
    merged tree: the loss, the trainable leaves' gradients, the
    (accumulating) update in place. ``metrics["grad_norm"]`` is the global
    norm of this micro-batch's gradients before clipping. The e-IT, DPO /
    ORPO and reward steps are this step over their losses."""

    def train_step(state: TrainState, frozen, batch: Dict[str, torch.Tensor]):
        flat = flatten(state.trainable)
        loss, metrics = loss_fn(merge_params(state.trainable, frozen), batch)
        grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True,
                                    materialize_grads=True)
        grads = dict(zip(flat, grads))
        tx.update(grads, state.opt_state, flat)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        return state, metrics

    return train_step


def make_train_step(
    cfg: VLMConfig,
    train_cfg: TrainConfig,
    tx: Optimizer,
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
) -> Callable:
    """The e-IT step: ``make_step`` over ``eit_loss``."""
    return make_step(lambda params, batch: eit_loss(params, cfg, batch, policy=policy,
                                                    remat=train_cfg.remat), tx)
