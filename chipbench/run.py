"""Run one cell of ``BENCHMARK.json`` once:

    python3 -m chipbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on the CUDA device of this machine. The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness comparison
read, beside its limit (also the last lines of standard error).

Without a CUDA device, or with fewer than the cell asks for, it prints no
result and exits 2. If JAX or the JAX package is loaded in this process
once the window has closed, it names the modules and exits 3.
"""

from __future__ import annotations

import time

PROCESS_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from chipbench.drivers.common import log  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "callireader_tpu")
CACHE = ROOT / ".chipbench_cache"


class Clock:
    process_start = PROCESS_START


def fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"


def manifest() -> Dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def reports(metric: Dict, cell: str, e2e_of_cell: List[str]) -> bool:
    """A metric with ``workloads`` is the listed cells'; an end-to-end one
    without is every cell's; a per-layer one without, the cells that report
    the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def load_metric(name: str):
    spec = importlib.util.spec_from_file_location(f"chipbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_caches()
    man = manifest()
    cell = cell_of(man, args.workload)
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    spec = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"the cell needs {cell['chips']} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return 2
    driver = importlib.import_module(f"chipbench.drivers.{cfg['driver']}")
    out = driver.run(cfg, spec, args.seed, args.seconds, bool(args.trace), Clock)

    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {', '.join(found)}: no result")
        return 3
    e2e = [m for m in man["end_to_end"] if reports(m, cell["name"], []) and m["name"] in out]
    e2e_names = [m["name"] for m in e2e]
    metrics: Dict[str, Dict] = {}
    if not args.trace:
        for m in e2e:
            metrics[m["name"]] = {"value": out[m["name"]], "unit": m["unit"]}
    else:
        ctx = out["context"]
        for m in man["per_layer"]:
            if not reports(m, cell["name"], e2e_names):
                continue
            value = load_metric(m["name"]).read(ctx)
            if value is None:
                log(f"{m['name']}: nothing to read ({'; '.join(ctx.missing) or 'no events'}); left out")
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = json.loads((HERE / "limits" / f"{cell['name']}.json").read_text())
    checks = {k: {"value": v, "limit": limits[k]["limit"]} for k, v in out["checks"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell["chips"],
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["traced_s"])
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device, "notes": out.get("notes", {})}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} = {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result, ensure_ascii=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
