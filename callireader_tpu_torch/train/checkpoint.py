"""Train-state and parameter checkpoints (PyTorch port of the save/restore
half of callireader_tpu/train/checkpoint.py).

The JAX package writes orbax checkpoints, which cannot be read without JAX;
the port writes its own format: ``<path>/state.pt`` (``torch.save`` of the
flattened {"trainable/...", "opt_state/...": tensor} tree plus the integer
counters) beside the same ``metadata.json``. A restore copies into the
template's tensors, so the leaves keep their device, dtype and
``requires_grad``. (``export_reference_format``, the merged safetensors
export, waits for a safetensors writer.)
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from callireader_tpu_torch.train.e_it import TrainState, flatten

STATE_FILE = "state.pt"
PARAMS_FILE = "params.pt"


def _tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """The state's own tensors under their checkpoint keys."""
    out = {f"trainable/{k}": v for k, v in flatten(state.trainable).items()}
    for k, v in state.opt_state.items():
        if isinstance(v, dict):
            out.update({f"opt_state/{k}/{p}": t for p, t in v.items()})
    return out


def save_train_state(path: str, state: TrainState, metadata: Optional[Dict] = None) -> None:
    os.makedirs(path, exist_ok=True)
    counters = {"step": state.step}
    counters.update({f"opt_state/{k}": v for k, v in state.opt_state.items()
                     if not isinstance(v, dict)})
    tensors = {k: v.detach().cpu() for k, v in _tensors(state).items()}
    torch.save({"tensors": tensors, "counters": counters}, os.path.join(path, STATE_FILE))
    if metadata is not None:
        with open(os.path.join(path, "metadata.json"), "w") as f:
            json.dump(metadata, f)


def restore_train_state(path: str, template: TrainState) -> TrainState:
    """The saved state, written into ``template``'s tensors (every leaf the
    template has must be in the file, with its shape; a template without
    optimizer moments restores the trainable leaves alone)."""
    # mmap: only the template's tensors are read (a serving restore skips the
    # optimizer moments, most of an 8b state file)
    saved = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", mmap=True,
                       weights_only=True)
    want = _tensors(template)
    missing = sorted(set(want) - set(saved["tensors"]))
    if missing:
        raise KeyError(f"{path}: the checkpoint lacks {missing[:5]}")
    with torch.no_grad():
        for key, dst in want.items():
            src = saved["tensors"][key]
            if src.shape != dst.shape:
                raise ValueError(f"{path}: {key} has shape {tuple(src.shape)}, want {tuple(dst.shape)}")
            dst.copy_(src)
    counters = saved["counters"]
    opt_state = dict(template.opt_state)
    for k in opt_state:
        if not isinstance(opt_state[k], dict):
            opt_state[k] = int(counters[f"opt_state/{k}"])
    return TrainState(template.trainable, opt_state, int(counters["step"]))


def save_params(path: str, params: Any) -> None:
    """A params tree as ``<path>/params.pt`` (leaves moved to the CPU)."""
    os.makedirs(path, exist_ok=True)
    flat = {k: v.detach().cpu() for k, v in flatten(params).items()}
    torch.save(flat, os.path.join(path, PARAMS_FILE))


def restore_params(path: str, template: Any) -> Any:
    """A new tree shaped like ``template`` with the saved leaves, each on its
    template leaf's device and in its dtype."""
    flat = torch.load(os.path.join(path, PARAMS_FILE), map_location="cpu", weights_only=True)

    def build(tree, prefix):
        if isinstance(tree, dict):
            return {k: build(v, f"{prefix}/{k}" if prefix else str(k)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, f"{prefix}/{i}" if prefix else str(i))
                              for i, v in enumerate(tree))
        if tree is None:
            return None
        return flat[prefix].to(tree.device, tree.dtype)

    return build(template, "")
