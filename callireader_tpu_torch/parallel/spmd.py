"""SPMD on torch.distributed (PyTorch port of callireader_tpu/parallel/spmd.py).

The JAX package runs one controller over all devices and lets GSPMD insert
the collectives. Here every rank is a process (``torchrun``, or
``init_distributed`` with no launcher for a world of 1), holds its own block
of each sharded leaf (``shard_tree``) and runs the collectives the modules
write: NCCL on the card, gloo where the caller asked for the CPU.

Mesh axes: data (rows), fsdp (ZeRO parameter / optimizer-state sharding),
tensor (heads / mlp / vocab), seq (Ulysses, parallel/ulysses.py), expert
(models/moe.py).

The collectives here: ``all_reduce`` (a sum whose backward is the identity:
the exit of a row-parallel product), ``copy_to`` (the identity whose
backward sums: the entry of a block that ranks split), ``all_gather``
(backward: the sum of the gathered grads, cut to the rank's block) and
``relayout``, which moves a leaf from the spec it is stored in to the one a
product needs (gathering a dim, or cutting this rank's block of it). Every
collective runs on a group of the mesh, also of size 1.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from callireader_tpu_torch.core import partition as part
from callireader_tpu_torch.core.partition import Mesh, Spec


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(
    device: str = "cuda",
    *,
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
) -> Tuple[int, int]:
    """Joins (or starts) the default process group -> (rank, world size);
    the counterpart of ``initialize_multihost``. Under ``torchrun`` the
    rendezvous, rank and world size come from its environment (RANK,
    WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT); with no launcher it
    is a world of 1 on ``tcp://localhost:<free port>``. NCCL on the card,
    each rank on card LOCAL_RANK; gloo where ``device`` is the CPU. A
    failed init raises."""
    dev = torch.device(device)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    if rank is None:
        rank = int(env.get("RANK", 0))
    if init_method is None:
        init_method = "env://" if "MASTER_ADDR" in env and "MASTER_PORT" in env \
            else f"tcp://localhost:{_free_port()}"
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' for a gloo world")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", 0)))
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return rank, world_size


def is_main() -> bool:
    """Rank 0 (or no process group): the one rank that prints and writes."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(shape: Optional[Mapping[str, int]] = None, device: str = "cuda") -> Mesh:
    """A mesh over every rank, the process group started if there is none.
    Default: all ranks on "data"."""
    init_distributed(device)
    n = dist.get_world_size()
    if shape is None:
        shape = {"data": n, "fsdp": 1, "tensor": 1, "seq": 1}
    return part.make_mesh(shape, "cuda" if torch.device(device).type == "cuda" else "cpu")


def parse_mesh(spec: str, world: int, fill: str = "data") -> Dict[str, int]:
    """``"tensor=4,fsdp=2"`` -> {axis: size}, the axis ``fill`` taking the
    rest of the world where it is not named (the JAX CLIs' rule). Sizes
    that do not make up the world are left for make_mesh to refuse."""
    shape = {}
    for kv in spec.split(","):
        k, _, v = kv.partition("=")
        if not v:
            raise ValueError(f"mesh entry {kv!r} is not axis=size")
        shape[k.strip()] = int(v)
    used = int(np.prod(list(shape.values()), dtype=np.int64))
    if fill not in shape and world % used == 0:
        shape[fill] = world // used
    return shape


# ------------------------------------------------------------------ trees


def _is_axes(x) -> bool:
    return x is None or (isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x))


def map_axes(fn, tree, axes):
    """``fn(leaf, axes)`` over a params tree and its logical-axes tree."""
    if _is_axes(axes):
        return None if tree is None else fn(tree, axes)
    if isinstance(tree, dict):
        return {k: map_axes(fn, v, axes[k]) for k, v in tree.items()}
    return type(tree)(map_axes(fn, v, a) for v, a in zip(tree, axes))


def _nones(tree):
    if isinstance(tree, dict):
        return {k: _nones(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_nones(v) for v in tree)
    return None


def llm_logical_axes(llm_cfg, sub: Dict[str, Any]) -> Dict[str, Any]:
    """The LLM part of ``engine_logical_axes``: internlm2's axes, the int8
    leaves', and any LoRA leaf (A's in dim over "embed", B replicated)."""
    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime.quantize import quantized_logical_axes

    a = internlm2.logical_axes(llm_cfg)
    if any(k.endswith("_q") for k in sub["layers"]) or "output_q" in sub:
        a = quantized_logical_axes(a, sub)
    for leaf in sub["layers"]:
        if leaf not in a["layers"]:
            if leaf.endswith("_lora_a"):
                a["layers"][leaf] = ("stack", "embed", None)
            elif leaf.endswith("_lora_b"):
                a["layers"][leaf] = ("stack", None, None)
            else:
                a["layers"][leaf] = ("stack",)
    return a


def engine_logical_axes(cfg, params: Dict[str, Any]) -> Dict[str, Any]:
    """Logical-axis tree matching the engine param structure; components
    without annotations of their own (detector, OrderFormer) replicate."""
    from callireader_tpu_torch.models import internvit, projector, resampler
    from callireader_tpu_torch.runtime.quantize import quantized_vit_logical_axes

    axes: Dict[str, Any] = {}
    for name, sub in params.items():
        if name == "llm":
            axes[name] = llm_logical_axes(cfg.llm, sub)
        elif name in ("vision", "char_vision"):
            vcfg = (cfg.char_vision if name == "char_vision" and cfg.char_vision is not None
                    else cfg.vision)
            a = internvit.logical_axes(vcfg)
            if any(k.endswith("_kernel_q") for k in sub["layers"]):
                a = quantized_vit_logical_axes(a, sub)
            axes[name] = a
        elif name in ("projector", "char_projector"):
            axes[name] = projector.logical_axes(cfg)
        elif name == "resampler":
            axes[name] = resampler.logical_axes(cfg.resampler)
        elif name == "align":
            axes[name] = {"normed_emb": ("vocab", "embed"), "mu": (None,), "sigma": (None,)}
        else:
            axes[name] = _nones(sub)
    return axes


def tree_specs(tree: Any, axes: Any, mesh: Mesh, rules=part.DEFAULT_RULES) -> Any:
    """The spec of every leaf of a whole tree (spec_for_shape)."""
    return map_axes(lambda x, a: part.spec_for_shape(tuple(x.shape), a, rules, mesh), tree, axes)


def flat_specs(tree: Any, axes: Any, mesh: Mesh, prefix: str = "") -> Dict[str, Spec]:
    """{"a/b/c": spec} of every leaf of a whole tree (train/e_it.flatten's
    paths)."""
    if _is_axes(axes):
        return {} if tree is None else {
            prefix: part.spec_for_shape(tuple(tree.shape), axes, mesh=mesh)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out: Dict[str, Spec] = {}
    for k, v in items:
        out.update(flat_specs(v, axes[k], mesh, f"{prefix}/{k}" if prefix else str(k)))
    return out


def shard_tree(tree: Any, axes: Any, mesh: Mesh, rules=part.DEFAULT_RULES) -> Any:
    """This rank's block of every leaf of a whole tree, by its logical axes
    (None axes and dims their mesh axis does not divide: whole)."""
    return map_axes(
        lambda x, a: part.local_shard(x, part.spec_for_shape(tuple(x.shape), a, rules, mesh), mesh),
        tree, axes)


def gather_tree(tree: Any, specs: Any, mesh: Mesh) -> Any:
    """The whole leaves again from every rank's blocks (``tree_specs`` of
    the whole tree gives ``specs``)."""
    return map_axes(lambda x, s: relayout(x, s, (None,) * x.ndim, mesh), tree, specs)


# ------------------------------------------------------------------ batches


def batch_sharding(mesh: Mesh, seq_sharded: bool = False):
    """-> fn(x) giving a host batch array's spec: rows over data x fsdp,
    and the sequence over seq where asked."""
    rows = tuple(a for a in ("data", "fsdp") if mesh.shape.get(a, 1) > 1) or None
    if rows is not None and len(rows) == 1:
        rows = rows[0]

    def spec_for(x) -> Spec:
        if x.ndim >= 2 and seq_sharded and mesh.shape.get("seq", 1) > 1:
            return (rows, "seq") + (None,) * (x.ndim - 2)
        if x.ndim >= 1:
            return (rows,) + (None,) * (x.ndim - 1)
        return ()

    return spec_for


def shard_batch(batch: Dict[str, Any], mesh: Mesh, seq_sharded: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's part of a host batch, on the mesh's device: token arrays
    (B, S) by rows over data x fsdp (the sequence over seq where asked);
    the flat payloads (pixel_values, pseudo_embeds) whole, their order
    being batch-global."""
    spec_for = batch_sharding(mesh, seq_sharded)
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
        if k not in ("pixel_values", "pseudo_embeds"):
            t = part.local_shard(t, spec_for(t), mesh)
        out[k] = t.to(mesh.device)
    return out


# ------------------------------------------------------------------ collectives


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _gather_dim(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, rank, dim):
        ctx.group, ctx.n, ctx.rank, ctx.dim, ctx.size = group, n, rank, dim, x.shape[dim]
        return _gather_dim(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None, None, None


def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (backward: the identity). In place
    where autograd does not track ``x``: pass a fresh tensor. An axis the
    mesh does not name is of size 1 (no collective)."""
    if axis not in mesh.shape:
        return x
    group = mesh.group(axis)
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllReduce.apply(x, group)
    dist.all_reduce(x, group=group)
    return x


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``x`` as it is (backward: the sum of the grads over ``axis``)."""
    if axis in mesh.shape and torch.is_grad_enabled() and x.requires_grad:
        return _CopyTo.apply(x, mesh.group(axis))
    return x


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """The blocks of ``axis``'s ranks concatenated along ``dim`` in rank
    order."""
    n = mesh.axis_size(axis)
    if axis not in mesh.shape:
        return x
    dim = dim % x.ndim
    if torch.is_grad_enabled() and x.requires_grad:
        return _AllGather.apply(x, mesh.group(axis), n, mesh.rank(axis), dim)
    return _gather_dim(x, mesh.group(axis), n, dim)


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def relayout(x: torch.Tensor, have: Spec, want: Spec, mesh: Mesh) -> torch.Tensor:
    """``x``, stored under spec ``have``, under spec ``want``: a dim sharded
    in ``have`` and not in ``want`` is gathered, one sharded only in
    ``want`` is cut to this rank's block."""
    have = tuple(have) + (None,) * (x.ndim - len(have))
    want = tuple(want) + (None,) * (x.ndim - len(want))
    for d, (h, w) in enumerate(zip(have, want)):
        if h == w:
            continue
        for a in reversed(_axes_of(h)):
            x = all_gather(x, mesh, a, d)
        if w is not None:
            x = x[(slice(None),) * d + (part.block(x.shape[d], w, mesh),)]
    return x


def reduce_grads(grads: Dict[str, torch.Tensor], mesh: Mesh, axes: Iterable[str]) -> None:
    """Sums every grad over each of ``axes`` (of size > 1), in place."""
    for a in axes:
        if mesh.shape.get(a, 1) > 1:
            for g in grads.values():
                dist.all_reduce(g, group=mesh.group(a))


def global_norm(grads: Dict[str, torch.Tensor], specs: Dict[str, Spec], mesh: Mesh) -> torch.Tensor:
    """The global L2 norm of a tree held in blocks: each rank's squares,
    over the ranks that hold the same block, summed over the world."""
    total = torch.zeros((), dtype=torch.float32, device=mesh.device)
    for k, g in grads.items():
        held = {a for e in specs[k] for a in _axes_of(e)}
        copies = int(np.prod([s for a, s in mesh.shape.items() if a not in held], dtype=np.int64))
        total = total + (g.float() * g.float()).sum() / copies
    dist.all_reduce(total)
    return torch.sqrt(total)
