"""The control and the faults at each cell's own size, on the card (marker
``cuda``; they skip without one): on three seeds or more, the program's
numbers stay under the cell's limits while the control (the reference in
the precision below the configuration's, in the program's place) and each
fault a cell can have go over them. Each reading is printed as a JSON line.

    python3 -m pytest chipbench/tests/test_chipbench_cuda.py -m cuda -s
"""

import json
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
SEEDS = (2**31 + 7001, 2**32 + 7002, 2**33 + 7003)


class Clock:
    process_start = time.time()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def cell_files(cell):
    from chipbench import run as runner

    w = runner.cell_of(runner.manifest(), cell)
    cfg = json.loads((runner.HERE / "configs" / f"{w['config']}.json").read_text())
    spec = json.loads((runner.HERE / "traffic" / f"{w['traffic']}.json").read_text())
    lim = {k: v["limit"] for k, v in json.loads((runner.HERE / "limits" / f"{cell}.json").read_text()).items()}
    return cfg, spec, lim


def report(**kw):
    print(json.dumps(kw), flush=True)


def release():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["fullpage_ocr.8b_int8", "interpret.8b_int8"])
def test_page_control(card, cell):
    from chipbench.drivers import ocr

    cfg, spec, lim = cell_files(cell)
    readings = []
    for seed in SEEDS:
        out = ocr.run(cfg, spec, seed, 1.0, False, Clock)
        gap = out["checks"]["max_served_gap"]
        ctl = ocr.control(cfg, spec, seed, out["sample"], "cuda")
        report(cell=cell, seed=seed, program=out["checks"], control=max(ctl), control_requests=ctl)
        readings.append((out["checks"], max(ctl)))
        del out
        release()
    assert all(all(v <= lim[k] for k, v in checks.items()) and lim["max_served_gap"] < ctl
               for checks, ctl in readings)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["altered_tokens", "swapped_order"])
def test_page_faults(card, fault, monkeypatch):
    from chipbench.drivers import ocr
    from chipbench.tests import faults

    getattr(faults, fault)(monkeypatch)
    cfg, spec, lim = cell_files("fullpage_ocr.8b_int8")
    readings = []
    for seed in SEEDS:
        out = ocr.run(cfg, spec, seed, 1.0, False, Clock)
        report(cell="fullpage_ocr.8b_int8", seed=seed, fault=fault, reading=out["checks"])
        readings.append(out["checks"])
        del out
        release()
    assert all(any(v > lim[k] for k, v in r.items()) for r in readings)


@pytest.mark.cuda
@pytest.mark.parametrize("fault", ["control", "half_batch"])
def test_training_control_and_half_batch(card, fault, monkeypatch):
    from chipbench.drivers import eit
    from chipbench.tests import faults

    cfg, spec, lim = cell_files("eit.8b_lora")
    if fault == "half_batch":
        faults.half_batch(monkeypatch)
    readings = []
    for seed in SEEDS:
        out = eit.run(cfg, spec, seed, 1.0, False, Clock)
        checks = out["checks"]
        del out
        release()
        reading = eit.control(cfg, spec, seed, "cuda") if fault == "control" else checks
        report(cell="eit.8b_lora", seed=seed, fault=fault, program=checks, reading=reading)
        readings.append((checks, reading))
        release()
    for program, reading in readings:
        if fault == "control":
            assert all(v <= lim[k] for k, v in program.items())
        assert any(v > lim[k] for k, v in reading.items())
