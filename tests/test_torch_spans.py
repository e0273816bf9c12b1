"""The port's recorder (utils/profiling.Spans): nesting, totals, the ring, the
off switch, the clock it shares with torch.profiler, its counters in the
kernels' registry (which graph captures leave alone), the page metrics that
read them, and the spans of the tiny CPU engine's batch route. The CUDA
event brackets run on the card only."""

import contextlib
import dataclasses
import importlib.util
import json
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from callireader_tpu_torch.kernels import _build
from callireader_tpu_torch.runtime import decode_graph
from callireader_tpu_torch.utils import profiling
from callireader_tpu_torch.utils.profiling import SPAN_FIELDS, SPAN_NAMES, SPANS, Spans

ROOT = Path(__file__).resolve().parents[1]
QUESTION = "读出图中所有文字。"


def _counter(name, field):
    return next(c for c in _build.COUNTS if c.name == f"span.{name}.{field}")


def test_nesting_totals_and_blocked_time():
    rec = Spans()
    with rec.span("outer"):
        with rec.span("inner"):
            with rec.span("blocked.readback"):
                time.sleep(0.002)
        with rec.span("blocked.upload"):
            time.sleep(0.001)
    rec.add("outer", 0.5)
    by = {e[0]: e for e in rec.log}
    assert [e[0] for e in rec.log] == ["blocked.readback", "inner", "blocked.upload", "outer", "outer"]
    assert by["blocked.readback"][1] == "inner" and by["inner"][1] == "outer"
    assert by["blocked.upload"][1] == "outer" and rec.log[3][1] is None
    for name, parent, t0, t1, _, dev in rec.log:
        assert t1 >= t0 and dev is None
        if parent is not None:
            outer = next(e for e in rec.log if e[0] == parent)
            assert outer[2] <= t0 and t1 <= outer[3]
    assert rec.counts == {"blocked.readback": 1, "inner": 1, "blocked.upload": 1, "outer": 2}
    assert rec.totals["outer"] >= 0.5 + 0.003
    # the waits inside a span count in its blocked time, nested ones too
    assert rec.blocked["inner"] == pytest.approx(rec.totals["blocked.readback"])
    assert rec.blocked["outer"] == pytest.approx(rec.totals["blocked.readback"] + rec.totals["blocked.upload"])
    assert "blocked.upload" not in rec.blocked and rec.device_totals == {}
    assert "outer" in rec.report() and "inner" in rec.report()
    rec.reset()
    assert not rec.totals and not rec.log


def test_the_log_is_a_ring():
    rec = Spans()
    n = profiling.LOG_SIZE + 100
    for i in range(n):
        with rec.span(f"s{i}"):
            pass
    assert [e[0] for e in rec.log] == [f"s{i}" for i in range(100, n)]
    assert len(rec.counts) == n


def test_threads_share_one_recorder():
    """Spans from more threads than cores, the interpreter switching often:
    no call is lost and each thread's spans nest in its own."""
    rec = Spans()
    switch = sys.getswitchinterval()

    def work():
        for _ in range(200):
            with rec.span("outer"):
                with rec.span("blocked.upload"):
                    pass

    threads = [threading.Thread(target=work) for _ in range(16)]
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert rec.counts == {"outer": 3200, "blocked.upload": 3200}
    assert all(parent == ("outer" if name == "blocked.upload" else None) for name, parent, *_ in rec.log)


def test_the_off_switch(monkeypatch):
    calls = _counter("decode", "calls")
    before = calls.launches
    monkeypatch.setattr(Spans, "enabled", False)
    rec = Spans()
    assert isinstance(rec.span("x"), contextlib.nullcontext)
    nbytes = profiling.UPLOAD_BYTES.launches
    with rec.span("x"), SPANS.span("decode"), SPANS.device("decode"):
        # an upload to the card would be a plain .to: no span, no bytes
        assert profiling._blocks(torch.zeros(4), "cuda:0") is False
    assert not rec.totals and not rec.log and calls.launches == before
    assert profiling.UPLOAD_BYTES.launches == nbytes


def test_a_move_within_the_host_is_no_upload():
    """``upload`` to the CPU is a plain ``.to``: no span, no bytes."""
    SPANS.reset()
    nbytes = profiling.UPLOAD_BYTES.launches
    out = profiling.upload(torch.arange(4, dtype=torch.int32), torch.device("cpu"), torch.int64)
    assert out.dtype == torch.int64 and out.tolist() == [0, 1, 2, 3]
    assert not SPANS.log and profiling.UPLOAD_BYTES.launches == nbytes
    assert profiling._blocks(torch.zeros(1), "cuda") and not profiling._blocks(torch.zeros(1), "cpu")


def test_spans_share_the_profiler_clock():
    """A span opened inside a record_function region starts and ends within
    that event of the CPU profiler, to within 1 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function

    rec = Spans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with record_function(f"region{i}"):
                with rec.span(f"span{i}"):
                    sum(range(20000))
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for i, (name, _, t0, t1, _, _) in enumerate(rec.log):
        ev = events[f"region{i}"]
        assert ev.start_ns() - 1_000_000 <= t0 <= t1 <= ev.start_ns() + ev.duration_ns() + 1_000_000


def test_counters_exist_at_import_with_unique_names():
    from callireader_tpu_torch.runtime import engine  # noqa: F401  (its counters)

    names = [c.name for c in _build.COUNTS]
    assert len(names) == len(set(names))
    for name in SPAN_NAMES:
        for field in SPAN_FIELDS:
            c = _counter(name, field)
            assert isinstance(c, _build.Counter) and not c.replayed
    for name in ("graph_captures", "kernel_builds", "decode_pad_steps", "blocked.upload.bytes"):
        assert isinstance(next(c for c in _build.COUNTS if c.name == name), _build.Counter)
    assert all(c.replayed for c in _build.COUNTS if not isinstance(c, _build.Counter))


class _FakeGraph:
    def pool(self):
        return None


def test_capture_bookkeeping_leaves_the_span_counters(monkeypatch):
    """A graph capture takes off what the launch counts moved during it and
    leaves the program's counters as they moved."""
    launch = _build.LaunchCount("test_spans.capture_launch")
    try:
        stream = types.SimpleNamespace(wait_stream=lambda s: None)
        monkeypatch.setattr(decode_graph, "_capture_stream", lambda d: stream)
        monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: stream)
        monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
        monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
        monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
        host, calls = _counter("decode", "host_ns"), _counter("decode", "calls")
        h0, c0 = host.launches, calls.launches

        def fn():
            launch.launches += 1
            with SPANS.span("decode"):
                pass

        decode_graph.StepGraph(torch.device("cuda"))._run_and_capture(fn)
        assert launch.launches == 1  # the eager run's; the capture's taken off
        assert calls.launches == c0 + 2 and host.launches > h0  # both runs' spans kept
    finally:
        _build.COUNTS.remove(launch)


def _reader(name):
    spec = importlib.util.spec_from_file_location(f"reader_{name}", ROOT / "chipbench" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _ctx(launches, batches=2):
    return types.SimpleNamespace(launches=launches, missing=[],
                                 work={"traced": {"batches": [{}] * batches}})


def test_page_metrics_read_the_span_counters():
    from chipbench import spans as bench_spans

    launches = {}
    for i, name in enumerate(SPAN_NAMES):
        launches.update({f"span.{name}.host_ns": (i + 1) * 10**9, f"span.{name}.device_ns": (i + 1) * 10**8,
                         f"span.{name}.blocked_ns": i * 10**7, f"span.{name}.calls": 2})
    ctx = _ctx(launches)
    front = bench_spans.BOX_STAGE + bench_spans.BUILD
    idx = {n: i for i, n in enumerate(SPAN_NAMES)}
    assert _reader("front_host_s.ocr")(ctx) == pytest.approx(
        sum((idx[n] + 1) - idx[n] * 0.01 for n in front) / 2)
    assert _reader("host_blocked_s.ocr")(ctx) == pytest.approx(
        (idx["blocked.upload"] + 1 + idx["blocked.readback"] + 1) / 2)
    assert _reader("front_device_s.ocr")(ctx) == pytest.approx(sum(
        (idx[n] + 1) * 0.1 for n in ("detect_dispatch", "order_dispatch", "page_tiling", "char_route",
                                     "tile_encode", "embed_build")) / 2)
    assert _reader("prefill_device_s.ocr")(ctx) == pytest.approx((idx["prefill"] + 1) * 0.1 / 2)
    assert _reader("decode_device_s.ocr")(ctx) == pytest.approx((idx["decode"] + 1) * 0.1 / 2)
    # a program without the counters (or whose span never ran) gives nothing to read
    names = ["front_host_s.ocr", "host_blocked_s.ocr", "front_device_s.ocr", "prefill_device_s.ocr",
             "decode_device_s.ocr"]
    bare = _ctx({"flash_decode_launch": 5})
    assert all(_reader(n)(bare) is None for n in names) and bare.missing
    assert _reader("decode_device_s.ocr")(_ctx(dict(launches, **{"span.decode.calls": 0}))) is None


@pytest.fixture(scope="module")
def engine():
    from callireader_tpu_torch.core.dtypes import FP32_POLICY
    from callireader_tpu_torch.models.detector import Detector
    from callireader_tpu_torch.runtime.engine import build_engine

    eng = build_engine("callireader-tiny", device="cpu", policy=FP32_POLICY)
    # a low confidence, so that the random-weight detector finds boxes
    eng.detector = Detector(eng.params["detector"], dataclasses.replace(
        eng.cfg.detector, conf_threshold=1e-4, max_detections=40), "cpu")
    return eng


STAGES = {
    "batch_sort_boxes": ("detect_dispatch", "detect_fetch", "nms", "columns", "order_dispatch",
                         "order_fetch"),
    "batch_build_rows": ("page_tiling", "char_prep", "char_route", "tile_encode", "tokenize",
                         "embed_build"),
    "batch_prepare": ("prefill", "decode"),
    "batch_decode": ("readback", "detokenize"),
}
# the sites of the waits on the CPU route (host tiling, device char resize)
BLOCKED_SITES = {
    "blocked.upload": {"detect_dispatch", "order_dispatch", "page_tiling", "char_route", "tile_encode",
                       "embed_build", "prefill"},
    "blocked.readback": {"detect_fetch", "order_fetch", "readback"},
}


def test_the_batch_route_opens_each_span_once_and_never_syncs(engine, monkeypatch, tmp_path):
    def no_sync(*a, **k):
        raise AssertionError("a span path synchronised the device")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    # the CPU engine's moves stand in for the card's uploads
    monkeypatch.setattr(profiling, "_blocks", lambda t, device: Spans.enabled and t.device.type == "cpu")
    rng = np.random.RandomState(0)
    pages = [rng.randint(60, 255, (96, 72, 3), np.uint8) for _ in range(2)]
    calls0 = {n: _counter(n, "calls").launches for n in SPAN_NAMES}
    nbytes0 = profiling.UPLOAD_BYTES.launches
    SPANS.reset()
    seen = {}
    ordered = engine.batch_sort_boxes(pages)
    seen["batch_sort_boxes"] = list(SPANS.log)
    SPANS.reset()
    rows = engine.batch_build_rows(pages, [QUESTION] * 2, ordered_lists=ordered)
    seen["batch_build_rows"] = list(SPANS.log)
    SPANS.reset()
    prepared = engine.batch_prepare([], [], prepared_rows=rows, max_new_tokens=8)
    seen["batch_prepare"] = list(SPANS.log)
    SPANS.reset()
    texts = engine.batch_decode(prepared)
    seen["batch_decode"] = list(SPANS.log)
    assert len(texts) == 2 and sum(len(o) for o in ordered) > 0
    sites = {"blocked.upload": set(), "blocked.readback": set()}
    for call, log in seen.items():
        names = [e[0] for e in log if not e[0].startswith(profiling.BLOCKED)]
        assert sorted(names) == sorted(STAGES[call]), call
        for name, parent, *_ in log:
            if name.startswith(profiling.BLOCKED):
                sites[name].add(parent)
            elif name == "nms":
                assert parent == "detect_fetch"
            else:
                assert parent is None, name
    assert sites == BLOCKED_SITES
    # every stage once in the registry too; the uploads' bytes counted
    for name in SPAN_NAMES:
        if not name.startswith(profiling.BLOCKED):
            assert _counter(name, "calls").launches - calls0[name] == 1, name
    assert profiling.UPLOAD_BYTES.launches > nbytes0
    SPANS.chrome_trace(str(tmp_path / "spans.json"))
    events = json.loads((tmp_path / "spans.json").read_text())["traceEvents"]
    assert [e["name"] for e in events] == [e[0] for e in SPANS.log]
    assert all(e["ph"] == "X" and e["dur"] >= 0 and e["ts"] > 1.7e15 for e in events)


def test_a_saturated_page_nests_no_stage_in_another(engine):
    """A page of more than 250 boxes takes the serial masking path in
    ``order_fetch``: its box-stage spans stand beside the batch's, so that
    no stage's host time is counted inside another's."""
    rng = np.random.RandomState(1)
    pages = [rng.randint(60, 255, (96, 72, 3), np.uint8) for _ in range(2)]
    xy = rng.randint(0, 60, (260, 2))
    crowded = [[x, y, x + 8, y + 10, 0.9] for x, y in xy.tolist()]
    second = [[10, 10, 20, 22, 0.9], [30, 10, 40, 22, 0.9], [10, 40, 20, 52, 0.9]]
    dets = [crowded, second]
    SPANS.reset()
    inter = engine.columns_stage(pages, dets)
    assert [i for i, _ in inter["saturated"]] == [0]
    ordered = engine.order_stage(inter)
    assert ordered[0] is not None and ordered[1] is not None
    stages = [e for e in SPANS.log if e[0] in profiling.STAGE_SPANS]
    assert {e[0] for e in stages} == {"detect_dispatch", "detect_fetch", "columns", "order_dispatch",
                                      "order_fetch"}
    assert all(e[1] is None for e in stages)
    # one thread: no two stage spans overlap in time
    spans_by_start = sorted(stages, key=lambda e: e[2])
    assert all(a[3] <= b[2] for a, b in zip(spans_by_start, spans_by_start[1:]))
    assert SPANS.counts["order_fetch"] == 2 and SPANS.counts["columns"] == 2


@pytest.mark.cuda
def test_device_brackets_resolve_after_a_readback():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    x = torch.randn(2048, 2048, device="cuda")
    dev_ns, calls = _counter("prefill", "device_ns"), _counter("prefill", "calls")
    d0, c0 = dev_ns.launches, calls.launches
    rec = Spans()
    with SPANS.span("prefill"), SPANS.device("prefill"):
        for _ in range(8):
            x = x @ x / 2048
    with rec.span("host_part"):
        with rec.device("device_part"):
            y = x.sum()
    assert calls.launches == c0 + 1
    profiling.readback(y)
    rec.resolve()
    assert dev_ns.launches > d0 and SPANS.device_totals["prefill"] > 0
    assert rec.device_totals["device_part"] > 0 and "device_part" not in rec.counts
    assert SPANS.log[-2][0] == "prefill" and SPANS.log[-2][5] > 0  # the bracket's ns in its span's entry
    assert not SPANS._pending and not rec._pending


def test_span_window_reads_the_untraced_window(monkeypatch, tmp_path):
    """``chipbench.span_window`` writes the program's counters as they moved
    over the untraced window and as the traced stretch's snapshot holds
    them, and puts the driver back."""
    from chipbench import run as bench_run, span_window, trace
    from chipbench.drivers import ocr

    def run_until(self, seconds, last):
        profiling.UPLOAD_BYTES.add(3)
        return [0, 1], 2.5

    def main(argv):
        assert argv == ["--workload", "w"] and not Spans.enabled
        ocr.Pipeline.run_until(None, 51.0, 0.0)
        trace.Context(object(), {"blocked.upload.bytes": 5, "flash_decode_launch": 1},
                      {"traced": {"batches": [{}]}}, {})
        return 0

    monkeypatch.setattr(Spans, "enabled", True)
    monkeypatch.setattr(ocr.Pipeline, "run_until", run_until)
    monkeypatch.setattr(trace.Context, "__init__", lambda self, tr, launches, work, cfg: None)
    monkeypatch.setattr(bench_run, "main", main)
    out = tmp_path / "counters.json"
    assert span_window.main(["--out", str(out), "--spans-off", "--workload", "w"]) == 0
    got = json.loads(out.read_text())
    assert got["spans_enabled"] is False and got["window"]["batches"] == 2
    assert got["window"]["seconds"] == 2.5 and got["window"]["counters"]["blocked.upload.bytes"] == 3
    assert got["window"]["counters"]["span.decode.calls"] == 0
    assert got["traced"] == {"batches": 1, "counters": {"blocked.upload.bytes": 5}}
    assert ocr.Pipeline.run_until is run_until
