"""The port's bench entry (callireader_tpu_torch/bench.py) on the CPU.

- ``BENCH_SMOKE=1 python -m callireader_tpu_torch.bench`` in a subprocess:
  the last line parses, is under 2000 characters, carries bench.py's keys
  and fingerprint, says ``"device": "cpu"`` and that it is no performance
  number.
- The orchestrator keeps a failed row's exit code and stderr tail in the
  combined line, which stays under 2000 characters however long the tails.
- ``make_page`` and ``converged`` equal the repository bench.py's.
- Without a card and without BENCH_SMOKE the bench fails with a message.
"""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from callireader_tpu_torch import bench as tbench

REPO = Path(__file__).resolve().parents[1]
ROW_KEYS = {"metric", "value", "unit", "vs_baseline", "p50_ttft_ms", "interval_spread",
            "device_wait_s", "host_stage_s_per_batch", "worst_interval_s", "batches",
            "converged", "warm_batches", "warmup_s", "workload"}
WORKLOAD_KEYS = {"batch", "preset", "quant", "page", "detector", "orderformer", "callialign",
                 "chars_per_image", "tiles_per_image", "char_canvas", "decode_tokens", "stages"}


def _root_bench():
    spec = importlib.util.spec_from_file_location("repo_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env(**kw):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env["PYTHONPATH"] = str(REPO)
    env.update(kw)
    return env


def test_smoke_runs_on_the_cpu_and_prints_a_short_last_line():
    out = subprocess.run([sys.executable, "-m", "callireader_tpu_torch.bench"],
                         env=_env(BENCH_SMOKE="1"), cwd=REPO, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    last = out.stdout.strip().splitlines()[-1]
    assert len(last) < 2000
    res = json.loads(last)
    assert ROW_KEYS <= res.keys()
    assert WORKLOAD_KEYS <= res["workload"].keys()
    root = _root_bench()
    assert res["metric"] == "full_page_pipeline_imgs_per_sec_per_chip"
    assert res["workload"]["stages"] == [
        "dynamic_tiling", "vit_projector", "detector_forward",
        "box_pipeline(dedup,kmeans,merge,orderformer)", "char_crops",
        "fused_char_vit_resampler_vq", "double_splice", "prefill", "fused_decode"]
    w = res["workload"]
    assert (w["batch"], w["decode_tokens"], w["preset"]) == (2, 8, "tiny")
    assert w["device"] == "cpu" and "not a performance number" in res["note"]
    assert w["chars_per_image"] == len(root.make_page()[1]) and w["detector"] == "gt_stub"
    assert len(res["batches"]) == 3 and res["value"] > 0
    assert "[bench] TTFT ms" in out.stderr and "convergence:" in out.stderr


def test_failed_row_keeps_its_exit_code_and_stderr_tail(capsys):
    rows = [("broken", {"BENCH_SMOKE": "1", "BENCH_QUANT": "int4"})]
    results, line = tbench.orchestrate(rows=rows, env=_env(), timeout_s=300)
    assert results["broken"]["rc"] == 1
    assert "quant='int4'" in results["broken"]["stderr_tail"]
    assert len(line) < 2000
    combined = json.loads(line)
    row = combined["rows"]["broken"]
    assert row["rc"] == 1 and "quant='int4'" in row["stderr_tail"] and "row_wall_s" in row
    assert combined["value"] is None and combined["headline_row"] is None
    # the row's own object went to an earlier line
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["row"] == "broken"


def test_combined_line_cuts_long_tails_to_fit():
    ok = {"value": 0.5, "p50_ttft_ms": 1234.5, "interval_spread": 0.01, "converged": True,
          "device_wait_s": 0.0, "row_wall_s": 300.0, "batches": [1.0] * 12,
          "host_stage_s_per_batch": {f"stage{i}": 0.1 for i in range(20)},
          "workload": {"device": "NVIDIA H100 80GB HBM3, 700.00 W", "stages": ["x"] * 9}}
    bad = {"error": "row exited 1" + " detail" * 100, "rc": 1,
           "stderr_tail": "\n".join(f"line {i} " + "x" * 200 for i in range(6)), "row_wall_s": 9.0}
    rows = {"a": ok, "b": dict(bad), "c": dict(bad, rc=124)}
    line = tbench.combined_line(rows, ["a", "b", "c"])
    assert len(line) < 2000
    out = json.loads(line)
    assert out["value"] == 0.5 and out["headline_row"] == "a"
    assert out["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert set(out["rows"]["a"]) == {"value", "p50_ttft_ms", "interval_spread", "converged",
                                     "device_wait_s", "row_wall_s", "device"}
    assert out["rows"]["b"]["rc"] == 1 and out["rows"]["c"]["rc"] == 124
    assert out["rows"]["b"]["stderr_tail"].endswith("x" * 20)  # the tail is kept, not the head


@pytest.mark.parametrize("seed", [0, 3])
def test_make_page_equals_the_repository_bench(seed):
    root = _root_bench()
    page, boxes = tbench.make_page(seed)
    want_page, want_boxes = root.make_page(seed)
    assert page.dtype == np.uint8 and np.array_equal(page, want_page)
    assert boxes == want_boxes


def test_converged_equals_the_repository_bench():
    root = _root_bench()
    rng = np.random.RandomState(0)
    cases = [[], [1.0] * 5, [1.0] * 6, [10, 9, 8, 7, 6, 5], [5, 5, 5, 5, 4.6, 4.4],
             [5, 5, 5, 5, 4.4, 4.4], [3, 1, 2, 2, 2, 2, 2]]
    cases += [list(rng.uniform(0.5, 1.5, n)) for n in range(1, 30)]
    for iv in cases:
        assert tbench.converged(iv) == root.converged(iv), iv
    assert (tbench.CONVERGE_WINDOW, tbench.CONVERGE_TOL, tbench.WARM_CAP_S,
            tbench.MAX_WARM_BATCHES, tbench.N_BATCHES, tbench.N_TTFT, tbench.DECODE_TOKENS) == (
        root.CONVERGE_WINDOW, root.CONVERGE_TOL, root.WARM_CAP_S, root.MAX_WARM_BATCHES, 12, 5, 256)
    assert [(n, e) for n, e in tbench.ROWS] == [(n, e) for n, e in root.ROWS]


def test_bench_fails_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert tbench.main(_env()) == 2
    assert tbench.main(_env(BENCH_PRESET="callireader-8b")) == 2
    err = capsys.readouterr().err
    assert err.count("found no CUDA device") == 2
