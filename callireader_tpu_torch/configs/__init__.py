"""Training recipes the port has (a copy of the hand-written recipes of
callireader_tpu/configs that the ported trainers run; each is a plain dict
the train CLI turns into flag defaults). The generated recipe zoo of the
JAX package is not ported."""

from __future__ import annotations

import importlib
import os
from typing import Dict, List

_DIR = os.path.dirname(__file__)


def list_configs() -> List[str]:
    return sorted(f[:-3] for f in os.listdir(_DIR) if f.endswith(".py") and not f.startswith("_"))


def get_config(name: str) -> Dict:
    if name not in list_configs():
        raise ValueError(f"unknown config {name!r}; the port has {list_configs()}")
    return importlib.import_module(f"callireader_tpu_torch.configs.{name}").config()
