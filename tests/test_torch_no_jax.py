"""The port imports neither JAX nor the JAX package, and its entry points run
on CUDA unless the caller asks for the CPU.

Checked in a fresh subprocess: the pytest worker already holds JAX
(tests/conftest.py imports it)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, sys
import callireader_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(callireader_tpu_torch.__path__, "callireader_tpu_torch."))
for n in names:
    importlib.import_module(n)
print(json.dumps({
    "modules": names,
    "jax": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "jax_package": sorted(m for m in sys.modules if m == "callireader_tpu" or m.startswith("callireader_tpu.")),
    "banned": sorted(m for m in ("PIL", "tokenizers", "transformers", "google.protobuf",
                                 "sentencepiece", "cv2", "sklearn") if m in sys.modules),
}))
"""


def _probe():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax_and_no_jax_package():
    res = _probe()
    assert len(res["modules"]) >= 20
    assert res["jax"] == []
    assert res["jax_package"] == []
    assert res["banned"] == []


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from callireader_tpu_torch.core.config import callireader_tiny
    from callireader_tpu_torch.runtime.engine import CalliReaderEngine, build_engine

    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine("callireader-tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        CalliReaderEngine(callireader_tiny(), {}, tokenizer=None)
