"""BENCHMARK.json and the files of chipbench/ agree: every cell's
configuration, traffic and limits are files found by name, every per-layer
metric is a reader of its own, every name and unit keeps to its alphabet,
and each per-layer metric's cells report the end-to-end metric it moves."""

import ast
import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "chipbench"
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _e2e_of(cell):
    return [m["name"] for m in MAN["end_to_end"] if "workloads" not in m or cell in m["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["chipbench"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in MAN["command"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_files(cell):
    w = next(w for w in MAN["workloads"] if w["name"] == cell)
    assert w["chips"] == 1
    cfg = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    assert (HERE / "drivers" / f"{cfg['driver']}.py").exists()
    assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    assert all("limit" in v for v in limits.values())
    assert "setup_s" in _e2e_of(cell) and len(_e2e_of(cell)) >= 2
    assert any(cell in m.get("workloads", [cell]) for m in MAN["per_layer"])


def test_config_files_are_named_in_the_manifest():
    for c in MAN["configs"]:
        assert c["file"] == f"chipbench/configs/{c['name']}.json"
        assert (ROOT / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in MAN["workloads"])


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_per_layer_reader(metric):
    m = next(m for m in MAN["per_layer"] if m["name"] == metric)
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    assert m["moves"] in [e["name"] for e in MAN["end_to_end"]]
    for cell in m["workloads"]:
        assert m["moves"] in _e2e_of(cell), (metric, cell)
    if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_bounds():
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = next(m for m in MAN["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] == 0.25


def test_metric_readers_import_no_program():
    for path in (HERE / "metrics").glob("*.py"):
        tree = ast.parse(path.read_text())
        mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        assert not any(m.split(".")[0] in ("jax", "callireader_tpu", "callireader_tpu_torch") for m in mods)
