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
                                 "sentencepiece", "cv2", "sklearn", "optax", "safetensors",
                                 "orbax", "pandas", "pyarrow", "opencc", "sentence_transformers",
                                 "openai", "sympy") if m in sys.modules),
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
    for name in ("cli.serve", "runtime.serving", "runtime.paged_cache", "runtime.http_server",
                 "kernels.paged_decode", "kernels.attention_bwd", "train.lora", "train.e_it",
                 "train.data", "train.checkpoint", "utils.profiling", "configs", "configs.e_it",
                 "cli.train", "kernels.rmsnorm", "cli.common", "cli.inference", "cli.chat",
                 "cli.get_embeddings", "apis", "__main__", "bench", "runtime.safetensors_io",
                 "runtime.detector_weights", "cli.convert", "evalx.metrics", "evalx.callibench",
                 "evalx.mmbench", "evalx.refcoco", "evalx.judges", "cli.evaluate", "cli.judge",
                 "runtime.plugins", "runtime.agent", "cli.preprocess", "configs.zoo",
                 "train.templates", "train.sft_data", "train.dpo", "train.reward",
                 "configs.dpo_internlm2_7b", "configs.llava_finetune", "configs.llava_pretrain",
                 "configs.long_context_sp4", "configs.orderformer_train", "configs.orpo_internlm2",
                 "configs.reward_internlm2", "configs.sft_internlm2_7b", "vision.native",
                 "models.llava", "models.moe", "train.moe_io", "train.detector_train",
                 "scripts", "scripts.train_orderformer", "scripts.train_detector",
                 "train.callialign_train", "scripts.train_callialign", "core.partition",
                 "parallel", "parallel.spmd", "parallel.tp_attention", "parallel.ulysses",
                 "parallel.dryrun", "scripts.bench_common", "scripts.bench_decode",
                 "scripts.bench_serving", "scripts.bench_http", "scripts.bench_prefix",
                 "scripts.bench_train_step", "scripts.bench_vit", "scripts.bench_8b_int8",
                 "scripts.mb_scan_int8"):
        assert f"callireader_tpu_torch.{name}" in res["modules"]
    assert res["jax"] == []
    assert res["jax_package"] == []
    # PIL among them: the servers import it per request only, the evaluation
    # harness's readers (pandas, PIL) and the CalliAlign fixture reader only
    # where they read a file; sympy: runtime/plugins.solve_equations imports it
    # inside the call
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
