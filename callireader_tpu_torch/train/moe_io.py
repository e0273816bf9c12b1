"""MoE expert-shard checkpoint I/O (PyTorch port of
callireader_tpu/train/moe_io.py).

Parity target: train/xtuner/utils/handle_moe_load_and_save.py — per-expert
HF weights (Mixtral naming, ``...block_sparse_moe.experts.{e}.{w1,w2,w3}.weight``)
merged into per-shard fused tensors (``...experts.{shard}.w1w3.weight``
(n, 2M, E) + ``...experts.{shard}.w2.weight`` (n, E, M)) so that each
expert-parallel rank saves or loads only its shard (:60-96
_merge_experts_weight, :49-58 _get_merged_param_name).

The converters work on numpy arrays, as the JAX module's do, so a state dict
crosses between the packages bit for bit. The stacked ``(L, X, ...)`` tree
saves and restores through the port's own train/checkpoint.py
(``save_params`` / ``restore_params``), where the JAX pair uses orbax.
Under an expert mesh ``save_sharded`` writes one file per expert shard in
the merged layout (each writing rank its own X/expert experts) beside the
dense leaves, and ``restore_sharded`` reassembles the shards it finds,
whatever mesh wrote them, then cuts the restoring rank's block.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict

import numpy as np
import torch

from callireader_tpu_torch.models.moe import MoEConfig
from callireader_tpu_torch.train import checkpoint

_PREFIX = "model.layers.{l}.block_sparse_moe"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def moe_to_hf_experts(params: Dict[str, Any], cfg: MoEConfig) -> Dict[str, np.ndarray]:
    """Stacked (L, X, ...) expert weights -> per-expert Mixtral-style state
    dict (torch Linear (out, in) orientation). The router maps to ``gate``."""
    lay = params["layers"]
    L, X = cfg.llm.num_hidden_layers, cfg.num_experts
    sd: Dict[str, np.ndarray] = {}
    w1, w3 = _np(lay["w1"]), _np(lay["w3"])  # (L, X, E, M) in, out
    w2 = _np(lay["w2"])  # (L, X, M, E)
    router = _np(lay["router"])  # (L, E, X)
    for l in range(L):
        base = _PREFIX.format(l=l)
        sd[f"{base}.gate.weight"] = router[l].T  # (X, E)
        for e in range(X):
            sd[f"{base}.experts.{e}.w1.weight"] = w1[l, e].T  # (M, E)
            sd[f"{base}.experts.{e}.w3.weight"] = w3[l, e].T
            sd[f"{base}.experts.{e}.w2.weight"] = w2[l, e].T  # (E, M)
    return sd


def hf_experts_to_moe(
    sd: Dict[str, np.ndarray], cfg: MoEConfig, dtype=np.float32
) -> Dict[str, np.ndarray]:
    """Inverse of moe_to_hf_experts: per-expert state dict -> stacked leaves
    {"w1", "w3", "w2", "router"} ready to drop into params["layers"]."""
    llm = cfg.llm
    L, X, E, M = llm.num_hidden_layers, cfg.num_experts, llm.hidden_size, llm.intermediate_size
    w1 = np.zeros((L, X, E, M), dtype)
    w3 = np.zeros((L, X, E, M), dtype)
    w2 = np.zeros((L, X, M, E), dtype)
    router = np.zeros((L, E, X), dtype)
    for l in range(L):
        base = _PREFIX.format(l=l)
        router[l] = np.asarray(sd[f"{base}.gate.weight"]).T
        for e in range(X):
            w1[l, e] = np.asarray(sd[f"{base}.experts.{e}.w1.weight"]).T
            w3[l, e] = np.asarray(sd[f"{base}.experts.{e}.w3.weight"]).T
            w2[l, e] = np.asarray(sd[f"{base}.experts.{e}.w2.weight"]).T
    return {"w1": w1, "w3": w3, "w2": w2, "router": router}


def merge_expert_shards(
    sd: Dict[str, np.ndarray], experts_per_shard: int
) -> Dict[str, np.ndarray]:
    """Per-expert -> merged expert-shard format (_merge_experts_weight): for
    each group of ``experts_per_shard`` experts, a fused
    ``experts.{shard}.w1w3.weight`` (n, 2M, E) + ``experts.{shard}.w2.weight``
    (n, E, M); other entries pass through."""
    out: Dict[str, np.ndarray] = {}
    expert_keys = sorted(
        [k for k in sd if ".experts." in k],
        key=lambda k: (k.split(".experts.")[0], int(k.split(".experts.")[1].split(".")[0]),
                       k.rsplit(".", 2)[-2]),
    )
    for k in sd:
        if ".experts." not in k:
            out[k] = sd[k]
    by_layer: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    for k in expert_keys:
        base, rest = k.split(".experts.")
        e, w, _ = rest.split(".")
        by_layer.setdefault(base, {}).setdefault(int(e), {})[w] = sd[k]
    for base, experts in by_layer.items():
        n_exp = len(experts)
        if n_exp % experts_per_shard:
            raise ValueError(f"{n_exp} experts do not split into shards of {experts_per_shard}")
        for shard in range(n_exp // experts_per_shard):
            grp = [experts[shard * experts_per_shard + i] for i in range(experts_per_shard)]
            w1 = np.stack([g["w1"] for g in grp])  # (n, M, E)
            w3 = np.stack([g["w3"] for g in grp])
            out[f"{base}.experts.{shard}.w1w3.weight"] = np.concatenate([w1, w3], axis=1)
            out[f"{base}.experts.{shard}.w2.weight"] = np.stack([g["w2"] for g in grp])
    return out


def split_expert_shards(
    sd: Dict[str, np.ndarray], experts_per_shard: int
) -> Dict[str, np.ndarray]:
    """Inverse of merge_expert_shards: fused shard tensors -> per-expert
    w1/w3/w2 entries (the load path of handle_moe_load_and_save)."""
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if ".experts." not in k:
            out[k] = v
            continue
        base, rest = k.split(".experts.")
        shard_s, w, _ = rest.split(".")
        shard = int(shard_s)
        if w == "w1w3":
            M2 = v.shape[1]
            for i in range(experts_per_shard):
                e = shard * experts_per_shard + i
                out[f"{base}.experts.{e}.w1.weight"] = v[i, : M2 // 2]
                out[f"{base}.experts.{e}.w3.weight"] = v[i, M2 // 2:]
        elif w == "w2":
            for i in range(experts_per_shard):
                out[f"{base}.experts.{shard * experts_per_shard + i}.w2.weight"] = v[i]
        else:
            raise KeyError(k)
    return out


_EXPERT_LEAVES = ("w1", "w3", "w2")
_SHARD_FILE = "experts-{:05d}-of-{:05d}.pt"


def _writer(mesh, *axes) -> bool:
    """The one rank of each ``axes`` coordinate that writes."""
    return all(mesh.rank(a) == 0 for a in mesh.axis_names if a not in axes)


def save_sharded(path: str, params: Any, cfg: MoEConfig = None, mesh=None) -> None:
    """The MoE params tree under ``path``: whole as ``params.pt``
    (train/checkpoint.py), or under an expert mesh the dense leaves as
    ``params.pt`` (rank 0) and each expert rank's experts as
    ``experts-<r>-of-<n>.pt`` in the merged layout (``merge_expert_shards``:
    the shard index is the rank's)."""
    if mesh is None:
        checkpoint.save_params(path, params)
        return
    import dataclasses

    import torch.distributed as dist

    os.makedirs(path, exist_ok=True)
    lay = params["layers"]
    n_local = lay["w1"].shape[1]
    r, n = mesh.rank("expert"), mesh.axis_size("expert")
    if _writer(mesh, "expert"):
        sd = moe_to_hf_experts(params, dataclasses.replace(cfg, num_experts=n_local))
        merged = merge_expert_shards({k: v for k, v in sd.items() if ".experts." in k}, n_local)
        merged = {k.replace(".experts.0.", f".experts.{r}."): torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in merged.items()}
        torch.save(merged, os.path.join(path, _SHARD_FILE.format(r, n)))
    if _writer(mesh):
        dense = dict(params)
        dense["layers"] = {k: v for k, v in lay.items() if k not in _EXPERT_LEAVES}
        checkpoint.save_params(path, dense)
    dist.barrier()


def restore_sharded(path: str, template: Any, cfg: MoEConfig = None, mesh=None) -> Any:
    """A tree like ``template``, each leaf on its template leaf's device and
    in its dtype: the whole saved tree, or the expert shards of any mesh
    reassembled (``split_expert_shards``), then this rank's blocks where
    ``mesh`` is given."""
    files = sorted(glob.glob(os.path.join(path, "experts-*-of-*.pt")))
    if not files:
        return checkpoint.restore_params(path, template)
    from callireader_tpu_torch.models import moe
    from callireader_tpu_torch.parallel import spmd

    tree = checkpoint.load_params(path)
    merged: Dict[str, np.ndarray] = {}
    for f in files:
        merged.update({k: v.numpy() for k, v in torch.load(f, weights_only=True).items()})
    sd = split_expert_shards(merged, cfg.num_experts // len(files))
    router = _np(tree["layers"]["router"])
    for l in range(cfg.llm.num_hidden_layers):
        sd[f"{_PREFIX.format(l=l)}.gate.weight"] = router[l].T
    leaves = hf_experts_to_moe(sd, cfg)
    for k in _EXPERT_LEAVES:
        tree["layers"][k] = torch.from_numpy(leaves[k])
    if mesh is not None:
        tree = spmd.shard_tree(tree, moe.logical_axes(cfg), mesh)

    def put(x, t):
        if tuple(x.shape) != tuple(t.shape):
            raise ValueError(f"restored {tuple(x.shape)} where the template holds {tuple(t.shape)}")
        return x.to(t.device, t.dtype)

    return _put_like(tree, template, put)


def _put_like(tree, template, put):
    if isinstance(template, dict):
        return {k: _put_like(tree[k], v, put) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_put_like(a, b, put) for a, b in zip(tree, template))
    return put(tree, template)
