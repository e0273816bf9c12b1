"""Config zoo: named training/eval recipes (a copy of
callireader_tpu/configs/__init__.py). Each recipe is a plain dict: the
hand-written recipe files of this package, then the generated zoo matrix
(configs/zoo.py). The train CLI turns a recipe's hyperparameters into flag
defaults; list-cfg / copy-cfg enumerate and copy them."""

from __future__ import annotations

import importlib
import os
import shutil
from typing import Dict, List

_DIR = os.path.dirname(__file__)


def _file_configs() -> List[str]:
    return sorted(
        f[:-3] for f in os.listdir(_DIR)
        if f.endswith(".py") and not f.startswith("_") and f != "zoo.py"
    )


def list_configs(include_zoo: bool = True) -> List[str]:
    """Hand-written recipes first, then the generated zoo matrix."""
    names = _file_configs()
    if include_zoo:
        from callireader_tpu_torch.configs import zoo

        names += zoo.list_zoo()
    return names


def get_config(name: str) -> Dict:
    if name in _file_configs():
        return importlib.import_module(f"callireader_tpu_torch.configs.{name}").config()
    from callireader_tpu_torch.configs import zoo

    try:
        return zoo.generate(name)
    except ValueError:
        raise ValueError(
            f"unknown config {name!r}; have {_file_configs()} plus the "
            f"generated zoo (python -m callireader_tpu_torch list-cfg)"
        )


def copy_config(name: str, dst: str) -> str:
    if os.path.isdir(dst):
        dst = os.path.join(dst, name + "_copy.py")
    src = os.path.join(_DIR, name + ".py")
    if os.path.exists(src):
        shutil.copyfile(src, dst)
        return dst
    # zoo member: materialize the generated dict as an editable config()
    cfg = get_config(name)  # raises for unknown names
    with open(dst, "w") as f:
        f.write(
            f'"""Materialized zoo recipe {name!r} '
            f"(python -m callireader_tpu_torch copy-cfg).\"\"\"\n\n\n"
            f"def config():\n    return {cfg!r}\n"
        )
    return dst
