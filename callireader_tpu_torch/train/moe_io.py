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
(``save_params`` / ``restore_params``), where the JAX pair uses orbax; the
port does not shard it over a mesh (ROADMAP queue A, parallelism).
"""

from __future__ import annotations

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


def save_sharded(path: str, params: Any) -> None:
    """The MoE params tree as ``<path>/params.pt`` (train/checkpoint.py)."""
    checkpoint.save_params(path, params)


def restore_sharded(path: str, template: Any) -> Any:
    """A tree like ``template``, each leaf on its template leaf's device and
    in its dtype."""
    return checkpoint.restore_params(path, template)
