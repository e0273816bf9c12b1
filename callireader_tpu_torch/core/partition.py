"""Logical-axis sharding (PyTorch port of callireader_tpu/core/partition.py).

Every parameter leaf has a tuple of *logical* axis names (the models'
``logical_axes``); a rule table maps each logical name onto a mesh axis, and
``spec_for_shape`` resolves a leaf's spec: one mesh axis or None per dim, a
plain tuple where JAX has a ``PartitionSpec``. Where GSPMD inserts the
collectives in the JAX package, the port's modules write them
(parallel/spmd.py, models/internlm2.py).

Mesh axes:
  "data"    data parallelism (batch rows)
  "fsdp"    parameter / optimizer-state sharding (ZeRO)
  "tensor"  tensor parallelism (heads, mlp, vocab)
  "seq"     Ulysses sequence parallelism (parallel/ulysses.py)
  "expert"  expert parallelism (models/moe.py)

A ``Mesh`` is one process per rank (torchrun) arranged row-major over the
named axes, as JAX's ``make_mesh`` reshapes its device list: global rank r
sits at ``np.unravel_index(r, sizes)``, the position of ``jax.devices()[r]``
in the JAX mesh of the same shape, so both packages give a rank the same
block of every leaf.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

Spec = Tuple[Optional[str], ...]

# logical axis -> mesh axis (or None = replicated)
DEFAULT_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", "data"),
    ("seq", None),  # set to "seq" for sequence parallelism
    ("embed", "fsdp"),
    ("heads", "tensor"),
    ("kv_heads", "tensor"),
    ("head_dim", None),
    ("qkv", "tensor"),
    ("mlp", "tensor"),
    ("vocab", "tensor"),
    ("expert", "expert"),
    ("vit_embed", None),
    ("vit_mlp", "tensor"),
    ("norm", None),
    ("patch", None),
    ("stack", None),  # the stacked layer axis
)


class Mesh:
    """Named mesh axes over the ranks of the default process group.

    ``shape`` is the {axis: size} dict of the JAX ``Mesh``; ``rank(axis)``
    is this process's coordinate on an axis and ``group(axis)`` the process
    group of the ranks that differ from it only there (a
    ``torch.distributed.device_mesh.DeviceMesh`` dimension). ``device`` is
    where this rank's tensors live. A mesh made by ``Mesh.virtual`` has a
    coordinate and no process groups: it names one rank's block (a shard's
    shapes on one card) and refuses collectives."""

    def __init__(self, shape: Mapping[str, int], device_type: str, *, coords=None):
        self.shape = {str(k): int(v) for k, v in shape.items()}
        self.axis_names = tuple(self.shape)
        self.device_type = device_type
        self.device_mesh = None
        if coords is None:
            from torch.distributed.device_mesh import init_device_mesh

            self.device_mesh = init_device_mesh(device_type, tuple(self.shape.values()),
                                                mesh_dim_names=self.axis_names)
            coords = {a: self.device_mesh.get_local_rank(a) for a in self.axis_names}
        self.coords = {a: int(coords.get(a, 0)) for a in self.axis_names}
        if device_type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device(device_type)

    @classmethod
    def virtual(cls, shape: Mapping[str, int], coords: Mapping[str, int],
                device_type: str = "cpu") -> "Mesh":
        return cls(shape, device_type, coords=dict(coords))

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values()), dtype=np.int64))

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def rank(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        if self.device_mesh is None:
            raise RuntimeError(f"a virtual mesh has no process group for {axis!r}")
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.device_type})"


def make_mesh(shape: Optional[Mapping[str, int]] = None, device_type: Optional[str] = None) -> Mesh:
    """A mesh over every rank of the initialised default process group.
    Default: all ranks on "data". Raises where the shape's size is not the
    world size (JAX: not the device count)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.spmd.init_distributed first")
    n = dist.get_world_size()
    if shape is None:
        shape = {"data": n, "fsdp": 1, "tensor": 1}
    size = int(np.prod(list(shape.values()), dtype=np.int64))
    if size != n:
        raise ValueError(f"mesh shape {dict(shape)} does not match {n} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return Mesh(shape, device_type)


def resolve_spec(
    logical_axes: Optional[Tuple[Optional[str], ...]],
    rules: Sequence[Tuple[str, Optional[str]]] = DEFAULT_RULES,
    mesh: Optional[Mesh] = None,
) -> Spec:
    """Map a tuple of logical axis names to a spec; an axis of size 1 in
    ``mesh`` resolves to None (replicated)."""
    if logical_axes is None:
        return ()
    table = dict(rules)
    out = []
    for name in logical_axes:
        mesh_axis = table.get(name) if name is not None else None
        if mesh is not None and mesh_axis is not None and mesh.shape.get(mesh_axis, 1) == 1:
            mesh_axis = None
        out.append(mesh_axis)
    return tuple(out)


def spec_for_shape(
    shape: Tuple[int, ...],
    logical_axes: Optional[Tuple[Optional[str], ...]],
    rules: Sequence[Tuple[str, Optional[str]]] = DEFAULT_RULES,
    mesh: Optional[Mesh] = None,
) -> Spec:
    """resolve_spec, then a dim whose size its mesh axis does not divide
    replicates (the odd 92553-row vocab over "tensor"; pad it to shard it)."""
    spec = resolve_spec(logical_axes, rules, mesh)
    if mesh is None:
        return spec
    return tuple(
        None if axis is not None and i < len(shape) and shape[i] % mesh.shape[axis] else axis
        for i, axis in enumerate(spec))


def block(n: int, axis, mesh: Mesh) -> slice:
    """The slice of a dim of size ``n`` that this rank holds on ``axis``: a
    mesh axis, or a tuple of them (the dim split over their product, the
    first axis major, as a PartitionSpec entry of several axes)."""
    if axis is None:
        return slice(None)
    size, r = 1, 0
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        size, r = size * mesh.axis_size(a), r * mesh.axis_size(a) + mesh.rank(a)
    step = n // size
    return slice(r * step, (r + 1) * step)


def local_shard(tensor: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a whole ``tensor`` under ``spec`` (a contiguous
    copy where it is a strict part)."""
    if not any(a is not None for a in spec):
        return tensor
    idx = tuple(block(tensor.shape[i], a, mesh) for i, a in enumerate(spec))
    return tensor[idx].contiguous()
