"""Whole runs of the drivers at the small sizes of small.py on the
CPU, past the harness's look for a card: the program's readings against the
reference, the control (the reference in a lower precision in the
program's place) well above them, and each fault a cell can have turning
``correct`` false under the cell's limits. Also: a run loads neither JAX
nor the JAX package, compared by whole top-level module name."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from chipbench import run as runner
from chipbench.tests import faults
from chipbench.tests.small import small_config, small_traffic, small_train_config, small_train_traffic

ROOT = Path(__file__).resolve().parents[2]


class Clock:
    process_start = time.time()


def limits(cell):
    return {k: v["limit"] for k, v in json.loads((ROOT / "chipbench" / "limits" / f"{cell}.json").read_text()).items()}


def correct(checks, cell):
    lim = limits(cell)
    return all(v <= lim[k] for k, v in checks.items())


SMALL_RUN = """
import json, time
from chipbench.drivers import ocr
from chipbench.run import forbidden_modules
from chipbench.tests.small import small_config, small_traffic
class C: process_start = time.time()
cfg, spec, seed = small_config(), small_traffic(), 2**31 + 101
out = ocr.run(cfg, spec, seed, 1.0, False, C, device="cpu")
control = ocr.control(cfg, spec, seed, out["sample"], "cpu")
print(json.dumps({"checks": out["checks"], "control": control, "forbidden": forbidden_modules(),
                  "attempted": out["attempted"]}))
"""


def test_page_run_no_jax_and_control():
    proc = subprocess.run([sys.executable, "-c", SMALL_RUN], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    assert r["forbidden"] == []
    assert r["attempted"] > 0
    c = r["checks"]
    assert c["order_mismatch"] == c["prompt_length_mismatch"] == c["bucket_mismatch"] == 0, c
    assert min(r["control"]) > 3 * c["max_served_gap"]


def test_forbidden_modules_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "callireader_tpu_torch_fake.sub", object())
    assert runner.forbidden_modules() == [m for m in runner.forbidden_modules() if m != "callireader_tpu_torch_fake"]
    monkeypatch.setitem(sys.modules, "callireader_tpu.runtime", object())
    assert "callireader_tpu" in runner.forbidden_modules()


@pytest.mark.parametrize("fault", ["altered_tokens", "swapped_order"])
def test_page_faults_are_not_correct(fault, monkeypatch):
    from chipbench.drivers import ocr

    getattr(faults, fault)(monkeypatch)
    out = ocr.run(small_config(), small_traffic(), 2**31 + 102, 1.0, False, Clock, device="cpu")
    assert not correct(out["checks"], "fullpage_ocr.8b_int8"), out["checks"]
    if fault == "swapped_order":
        assert out["checks"]["order_mismatch"] > 0


def test_training_run_and_control():
    from chipbench.drivers import eit

    cfg, spec, seed = small_train_config(), small_train_traffic(), 2**31 + 103
    out = eit.run(cfg, spec, seed, 1.0, False, Clock, device="cpu")
    ctl = eit.control(cfg, spec, seed, "cpu")
    assert any(ctl[k] > 3 * out["checks"][k] for k in out["checks"]), (out["checks"], ctl)
    assert out["attempted"] > 0


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_state"])
def test_training_faults_are_not_correct(fault, monkeypatch):
    from chipbench.drivers import eit

    getattr(faults, fault)(monkeypatch)
    out = eit.run(small_train_config(), small_train_traffic(), 2**31 + 104, 1.0, False, Clock, device="cpu")
    assert not correct(out["checks"], "eit.8b_lora"), out["checks"]
