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
are ~5 GB).

Under a mesh (``create_train_state(..., mesh=, axes=)``) each rank keeps its
block of every trainable leaf and of its optimizer moments (ZeRO over the
leaves' logical axes), and the frozen tree whole. A step takes the whole
batch, computes on the rows of its (data, fsdp) coordinate
(``shard_eit_batch``: the rows with their own tiles and pseudo tokens) with
the trainable leaves gathered whole, adds the grads over data, fsdp and seq,
clips by their global norm and updates its own blocks. The loss is
normalised by the token count of the whole batch, so that the added grads
are those of the unsharded step. With "seq" > 1 (``make_train_step(mesh=)``)
each rank runs its part of the sequence and attention goes through Ulysses
(parallel/ulysses.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from callireader_tpu_torch.align import vq as vq_mod
from callireader_tpu_torch.core import partition
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


def replace_leaves(tree, flat: Dict[str, Any], prefix: str = ""):
    """``tree`` with each leaf at path p replaced by ``flat[p]`` (None holes
    kept): the inverse of ``flatten``."""
    if isinstance(tree, dict):
        return {k: replace_leaves(v, flat, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replace_leaves(v, flat, f"{prefix}/{i}" if prefix else str(i))
                          for i, v in enumerate(tree))
    return None if tree is None else flat[prefix]


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
    mesh=None,
    attn_override: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch (tensors on the model's device):
      input_ids   (B, S) int   right-padded with the pad id
      labels      (B, S) int   IGNORE_INDEX on prompt and pad
      segment_ids (B, S) int   0 on tokens, -1 on pad
      positions   (B, S) int
      pixel_values (T, H, W, 3) uint8 or normalised float: every tile of the batch in order
      pseudo_embeds (P, E)     every pseudo token of the batch in order
    -> (loss, {"loss", "n_tokens"}). ``mesh``: the batch is a rank's rows
    (``shard_eit_batch``); the loss is normalised by the tokens of all of
    them (added over data, fsdp and seq), and with "seq" > 1 the rank runs
    its part of the sequence through ``attn_override``."""
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

    seg, positions = batch.get("segment_ids"), batch.get("positions")
    S = embeds.shape[1]
    split = mesh is not None and mesh.axis_size("seq") > 1
    if split:
        from callireader_tpu_torch.parallel.ulysses import split_for_sequence_parallel

        # each position's target is the next token (the last has none), cut
        # with the rank's part of the sequence
        shift_labels = torch.cat([labels[:, 1:], torch.full_like(labels[:, :1], IGNORE_INDEX)],
                                 dim=1)
        if positions is None:
            positions = torch.arange(S, device=embeds.device)[None].expand(embeds.shape[0], S)
        embeds, positions, shift_labels = (split_for_sequence_parallel(t, mesh)
                                           for t in (embeds, positions, shift_labels))
        seg = None  # the Ulysses attention is causal only (unpacked rows, pads at the end)
    logits = internlm2.forward(
        params["llm"], cfg.llm, inputs_embeds=embeds, segment_ids=seg, positions=positions,
        policy=policy, remat=remat, attn_override=attn_override, rope_len=S)
    if not split:
        logits, shift_labels = logits[:, :-1], labels[:, 1:]
    shift_labels = shift_labels.long()
    valid = shift_labels != IGNORE_INDEX
    logp = torch.log_softmax(logits.float(), dim=-1)
    token_ll = torch.gather(logp, -1, torch.where(valid, shift_labels, 0)[..., None])[..., 0]
    loss_sum = -(token_ll * valid).sum()
    n_valid = valid.sum()
    if mesh is None:
        n_valid = n_valid.clamp(min=1)
        loss = loss_sum / n_valid
        return loss, {"loss": loss, "n_tokens": n_valid}
    import torch.distributed as dist

    both = torch.stack([loss_sum.detach().float(), n_valid.float()])
    for a in ("data", "fsdp", "seq"):
        if mesh.axis_size(a) > 1:
            dist.all_reduce(both, group=mesh.group(a))
    n_all = both[1].clamp(min=1)
    return loss_sum / n_all, {"loss": both[0] / n_all, "n_tokens": n_all.long()}


def shard_eit_batch(batch: Dict[str, torch.Tensor], cfg: VLMConfig, mesh) -> Dict[str, torch.Tensor]:
    """A whole e-IT batch -> the rows of this rank's (data, fsdp) coordinate
    (of its data coordinate where data x fsdp does not divide the batch: the
    fsdp ranks then run the same rows, which the loss's token count, added
    over the same axes as the grads, makes up for), with the image tiles and
    pseudo tokens those rows splice (the payloads are in row order: each row
    takes as many as it has slots)."""
    d, f = mesh.axis_size("data"), mesh.axis_size("fsdp")
    ids = batch["input_ids"]
    B = ids.shape[0]
    if B % (d * f):
        f = 1
    if B % d:
        raise ValueError(f"batch of {B} rows does not split over data={d}")
    n = B // (d * f)
    r0 = (mesh.rank("data") * f + (mesh.rank("fsdp") if f > 1 else 0)) * n
    out = {k: v[r0:r0 + n] for k, v in batch.items() if k not in ("pixel_values", "pseudo_embeds")}
    for key, token, per in (("pixel_values", cfg.img_context_token_id, cfg.num_image_token),
                            ("pseudo_embeds", cfg.aligned_token_id, 1)):
        if key in batch:
            counts = ((ids == token).sum(dim=1) // per).tolist()
            lo = sum(counts[:r0])
            out[key] = batch[key][lo:lo + sum(counts[r0:r0 + n])]
    return out


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
               params: Dict[str, torch.Tensor], norm_fn: Callable = global_norm) -> None:
        """``norm_fn``: the global norm of a grads dict (a sharded tree's
        needs its ranks: spmd.global_norm)."""
        k = self.grad_accum
        if k == 1:
            self._apply(grads, state, params, norm_fn)
            return
        n = state["mini_step"]
        for path, acc in state["acc_grads"].items():
            acc.add_((grads[path] - acc) / (n + 1))  # the running mean of the micro grads
        if n < k - 1:
            state["mini_step"] = n + 1
            return
        self._apply(state["acc_grads"], state, params, norm_fn)
        for acc in state["acc_grads"].values():
            acc.zero_()
        state["mini_step"] = 0
        state["gradient_step"] += 1

    def _apply(self, grads, state, params, norm_fn=global_norm) -> None:
        max_norm = self.grad_clip
        if max_norm is not None:
            g_norm = norm_fn(grads)
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
    mesh: Any = None  # under a mesh: the trainable leaves and moments are the rank's blocks
    specs: Optional[Dict[str, Any]] = None  # flat path -> spec of each trainable leaf


def create_train_state(params, train_cfg: TrainConfig, mesh=None, axes=None):
    """-> (state, frozen, optimizer). The trainable leaves are marked
    ``requires_grad`` in place. ``mesh`` (with ``axes``, the logical axes of
    ``params``, e.g. spmd.engine_logical_axes): the state holds this rank's
    block of each trainable leaf and the moments shaped like it; the frozen
    tree stays whole."""
    trainable, frozen = partition_params(params, train_cfg)
    specs = None
    if mesh is not None:
        from callireader_tpu_torch.parallel import spmd

        if axes is None:
            raise ValueError("a mesh needs the params' logical axes (spmd.engine_logical_axes)")
        specs = spmd.flat_specs(trainable, axes, mesh)
        trainable = replace_leaves(trainable, {
            k: partition.local_shard(v.detach(), specs[k], mesh).clone()
            for k, v in flatten(trainable).items()})
    flat = flatten(trainable)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    tx = make_optimizer(train_cfg)
    return TrainState(trainable, tx.init(flat), 0, mesh, specs), frozen, tx


def replicate_scalars(state: TrainState, mesh) -> TrainState:
    """The JAX trainer pins its scalar state leaves to a replicated sharding;
    here the counters are host integers, the same on every rank."""
    del mesh
    return state


def gather_state(state: TrainState) -> TrainState:
    """A sharded state -> the whole one (its trainable leaves and moments
    gathered from every rank), for saving; a whole state as it is."""
    if state.mesh is None:
        return state
    from callireader_tpu_torch.parallel import spmd

    def whole(flat):
        return {k: spmd.relayout(v.detach(), state.specs[k], (), state.mesh)
                for k, v in flat.items()}

    opt = {k: whole(v) if isinstance(v, dict) else v for k, v in state.opt_state.items()}
    return TrainState(replace_leaves(state.trainable, whole(flatten(state.trainable))), opt,
                      state.step)


def shard_state(state: TrainState, template: TrainState) -> TrainState:
    """A whole state (restored from a checkpoint) -> ``template``'s layout:
    this rank's blocks, copied into the template's tensors."""
    if template.mesh is None:
        return state

    def put(flat, into):
        with torch.no_grad():
            for k, v in flat.items():
                into[k].copy_(partition.local_shard(v, template.specs[k], template.mesh))

    put(flatten(state.trainable), flatten(template.trainable))
    for k, v in state.opt_state.items():
        if isinstance(v, dict):
            put(v, template.opt_state[k])
        else:
            template.opt_state[k] = v
    template.step = state.step
    return template


def make_step(loss_fn: Callable, tx: Optimizer) -> Callable:
    """``train_step(state, frozen, batch) -> (state, metrics)`` for one
    micro-batch of ``loss_fn(params, batch) -> (loss, metrics)`` on the
    merged tree: the loss, the trainable leaves' gradients, the
    (accumulating) update in place. ``metrics["grad_norm"]`` is the global
    norm of this micro-batch's gradients before clipping. The e-IT, DPO /
    ORPO and reward steps are this step over their losses."""

    def train_step(state: TrainState, frozen, batch: Dict[str, torch.Tensor]):
        flat = flatten(state.trainable)
        if state.mesh is not None:
            return _sharded_step(state, frozen, batch, flat)
        loss, metrics = loss_fn(merge_params(state.trainable, frozen), batch)
        grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True,
                                    materialize_grads=True)
        grads = dict(zip(flat, grads))
        tx.update(grads, state.opt_state, flat)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = global_norm(grads)
        return state, metrics

    def _sharded_step(state, frozen, batch, flat):
        from callireader_tpu_torch.parallel import spmd

        mesh, specs = state.mesh, state.specs
        loss, metrics, grads = sharded_grads(loss_fn, state, frozen, batch)
        norm = global_norm(grads)  # whole grads, the same on every rank
        local = {k: partition.local_shard(g, specs[k], mesh) for k, g in grads.items()}
        tx.update(local, state.opt_state, flat,
                  norm_fn=lambda g: spmd.global_norm(g, specs, mesh))
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = norm
        return state, metrics

    return train_step


def sharded_grads(loss_fn: Callable, state: TrainState, frozen, batch):
    """One micro-batch under the state's mesh -> (loss, metrics, the whole
    grads of every trainable leaf, added over data, fsdp and seq: the
    unsharded step's)."""
    from callireader_tpu_torch.parallel import spmd

    mesh, specs = state.mesh, state.specs
    whole = {k: spmd.relayout(v.detach(), specs[k], (), mesh).requires_grad_(True)
             for k, v in flatten(state.trainable).items()}
    params = merge_params(replace_leaves(state.trainable, whole), frozen)
    loss, metrics = loss_fn(params, batch)
    grads = torch.autograd.grad(loss, list(whole.values()), allow_unused=True,
                                materialize_grads=True)
    grads = dict(zip(whole, grads))
    spmd.reduce_grads(grads, mesh, ("data", "fsdp", "seq"))
    return loss, metrics, grads


def make_loss_fn(
    cfg: VLMConfig,
    train_cfg: TrainConfig,
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
    mesh=None,
    use_flash: Optional[bool] = None,
) -> Callable:
    """``loss_fn(params, batch) -> (loss, metrics)`` of the e-IT step.
    ``mesh`` (the state's): ``batch`` is the whole batch and the loss runs
    this rank's rows (``shard_eit_batch``); with "seq" > 1 attention goes
    through Ulysses, through the training kernels (``use_flash``, default on
    the card) or the plain attention."""
    if mesh is None:
        return lambda params, batch: eit_loss(params, cfg, batch, policy=policy,
                                              remat=train_cfg.remat)
    attn_override = None
    if mesh.axis_size("seq") > 1:
        from callireader_tpu_torch.parallel import ulysses

        flash = use_flash if use_flash is not None else mesh.device.type == "cuda"

        def attn_override(q, k, v):
            return ulysses.ulysses_attention(q, k, v, mesh, causal=True, use_flash=flash)

    return lambda params, batch: eit_loss(
        params, cfg, shard_eit_batch(batch, cfg, mesh), policy=policy, remat=train_cfg.remat,
        mesh=mesh, attn_override=attn_override)


def make_train_step(
    cfg: VLMConfig,
    train_cfg: TrainConfig,
    tx: Optimizer,
    *,
    policy: DTypePolicy = DEFAULT_POLICY,
    mesh=None,
    use_flash: Optional[bool] = None,
) -> Callable:
    """The e-IT step: ``make_step`` over ``make_loss_fn``'s loss (under a
    mesh, the whole batch in, this rank's rows run)."""
    return make_step(make_loss_fn(cfg, train_cfg, policy=policy, mesh=mesh,
                                  use_flash=use_flash), tx)
