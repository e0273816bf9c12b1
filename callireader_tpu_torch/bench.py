"""Full-page pipeline throughput of the PyTorch/CUDA port on one card: the
port's counterpart of the repository's bench.py, with its protocol, rows and
fingerprint.

    python -m callireader_tpu_torch.bench                 # the three rows
    BENCH_ROWS=flagship_8b_int8 python -m callireader_tpu_torch.bench
    BENCH_PRESET=callireader-8b BENCH_QUANT=int8 BENCH_BATCH=8 \\
        python -m callireader_tpu_torch.bench             # one row, in-process
    BENCH_SMOKE=1 python -m callireader_tpu_torch.bench   # CPU shakedown

The workload is full-page ``chat_ocr`` over a batch of pages:

  per page:  dynamic tiling -> ViT -> projector; YOLO detector forward;
             dedup -> k-means -> merge -> OrderFormer -> per-column sort;
             char crops -> device bicubic canvas -> char tower + resampler +
             VQ; prompt build + image / pseudo-token splice
  then:      one prefill and one greedy decode of DECODE_TOKENS tokens for
             the whole batch.

Weights are seeded random for the ViT and the LLM; the committed trained
detector, OrderFormer and CalliAlign assets are overlaid where the preset
matches them. The page is bench.py's synthetic 788x2000 clone of the
reference fixture (``make_page``); the fixture is not in the repository. As
in bench.py, the trained detector drives the box stage when it finds at least
50 boxes on the page; otherwise a stub runs its forward (cost counted) and
returns the page's known boxes, and the fingerprint says ``gt_stub``.

Protocol (bench.py's, step for step):
  1. compile warm-up: one full batch;
  2. TTFT: the single-image path (calli_align + host load_image +
     encode_image_tiles + one prefill, ending in a read of the first token)
     twice to warm, then N_TTFT samples; p50;
  3. throughput: pipelined batches until ``converged`` (cap WARM_CAP_S /
     MAX_WARM_BATCHES), then N_BATCHES intervals;
  value = batch / median(steady intervals); spread = IQR / median.
Each interval ends with ``torch.cuda.synchronize()`` before the host clock is
read. The pipelined schedule is bench.py's (box stages of later batches
around the decode sync): ``batch_prepare`` enqueues the prefill and every
chunk of the decode (CUDA graph replays) and returns, so the host builds
the next batch while the card decodes this one, and ``device_wait_s`` is
the part of the decode the host's work did not hide.

Knobs (bench.py's): BENCH_PRESET, BENCH_QUANT (int8 | int8-all),
BENCH_BATCH, BENCH_CALLIALIGN (0: the shared tower at the 448 canvas),
BENCH_CHAR_CANVAS, BENCH_CHAR_WINDOW, BENCH_DEVICE_TILES (0: host tiling),
BENCH_GT_BOXES, BENCH_ROWS, BENCH_SINGLE, BENCH_SMOKE, BENCH_ROW_TIMEOUT,
and BENCH_PROFILE=<dir>, a torch.profiler trace of two steady intervals
(the interval that holds its export is left out of the measured ones).

Output: a row prints bench.py's JSON object as its last line, with the
fingerprint's ``device`` (card name and power limit). The orchestrator runs
each row in its own process, prints each row's object on an earlier line,
and ends with one combined line under 2000 characters; a row that fails
keeps its exit code and the last lines of its stderr there. Without a card
the bench fails; only BENCH_SMOKE=1 runs on the CPU (tiny preset, batch 2,
3 batches, 8 tokens), and its JSON says it is not a performance number.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

N_BATCHES = 12
N_TTFT = 5
DECODE_TOKENS = 256
CONVERGE_WINDOW = 3
CONVERGE_TOL = 0.10
WARM_CAP_S = 600.0
MAX_WARM_BATCHES = 24
PAGE_W, PAGE_H = 788, 2000
N_COLS, CHARS_PER_COL = 6, 16
QUESTION = "读出图中所有文字。"
METRIC = "full_page_pipeline_imgs_per_sec_per_chip"
LINE_LIMIT = 2000  # characters of the combined last line
STAGES = [
    "dynamic_tiling", "vit_projector", "detector_forward",
    "box_pipeline(dedup,kmeans,merge,orderformer)",
    "char_crops", "fused_char_vit_resampler_vq",
    "double_splice", "prefill", "fused_decode",
]
# (name, env overrides), bench.py's rows; each runs in its own process
ROWS = [
    ("flagship_8b_int8",
     {"BENCH_PRESET": "callireader-8b", "BENCH_QUANT": "int8", "BENCH_BATCH": "8"}),
    ("reference_geometry_8b_int8",
     {"BENCH_PRESET": "callireader-8b", "BENCH_QUANT": "int8-all",
      "BENCH_BATCH": "8", "BENCH_CALLIALIGN": "0"}),
    ("compact_2b_bf16", {}),
]
SINGLE_KNOBS = (
    "BENCH_SINGLE", "BENCH_PRESET", "BENCH_QUANT", "BENCH_CALLIALIGN",
    "BENCH_CHAR_CANVAS", "BENCH_GT_BOXES", "BENCH_BATCH",
    "BENCH_DEVICE_TILES", "BENCH_CHAR_WINDOW",
)


def make_page(seed: int = 0):
    """Synthetic calligraphy page, the structural clone of the reference
    fixture's layout (bench.py's). -> (page uint8 (H, W, 3), flat boxes)."""
    rng = np.random.RandomState(seed)
    page = np.full((PAGE_H, PAGE_W, 3), 235, np.uint8)
    page += rng.randint(0, 18, page.shape).astype(np.uint8)
    boxes = []
    col_w = PAGE_W // (N_COLS + 1)
    for c in range(N_COLS):
        x0 = PAGE_W - (c + 1) * col_w - 20
        for r in range(CHARS_PER_COL):
            y0 = 40 + r * (PAGE_H - 80) // CHARS_PER_COL
            w = rng.randint(55, 75)
            h = rng.randint(55, 75)
            glyph = np.full((h, w, 3), 245, np.uint8)
            for _ in range(6):
                sx, sy = rng.randint(0, w - 8), rng.randint(0, h - 8)
                glyph[sy:sy + rng.randint(4, h - sy), sx:sx + rng.randint(3, 8)] = rng.randint(10, 60)
                glyph[sy:sy + rng.randint(3, 8), sx:sx + rng.randint(4, w - sx)] = rng.randint(10, 60)
            page[y0:y0 + h, x0:x0 + w] = glyph
            boxes.append([float(x0), float(y0), float(x0 + w), float(y0 + h)])
    return page, boxes


def converged(intervals) -> bool:
    """Steady state: the rolling median has stopped improving (the median of
    the last CONVERGE_WINDOW intervals is not more than CONVERGE_TOL below
    the median of the window before)."""
    if len(intervals) < 2 * CONVERGE_WINDOW:
        return False
    prev = float(np.median(intervals[-2 * CONVERGE_WINDOW:-CONVERGE_WINDOW]))
    last = float(np.median(intervals[-CONVERGE_WINDOW:]))
    return last >= (1.0 - CONVERGE_TOL) * prev


class NoCardError(RuntimeError):
    """The bench measures the card; only BENCH_SMOKE=1 runs without one."""

    def __init__(self):
        super().__init__("the bench measures the card and found no CUDA device; "
                         "BENCH_SMOKE=1 runs the CPU shakedown")


def _flag(env, name: str, default: str = "") -> bool:
    return env.get(name, default) not in ("", "0")


@dataclasses.dataclass(frozen=True)
class Protocol:
    batch: int = 16
    n_batches: int = N_BATCHES
    n_ttft: int = N_TTFT
    decode_tokens: int = DECODE_TOKENS
    warm_cap_s: float = WARM_CAP_S
    max_warm_batches: int = MAX_WARM_BATCHES


@dataclasses.dataclass(frozen=True)
class Settings:
    """One row's knobs, read from the environment."""

    smoke: bool
    preset: str
    quant: str
    callialign: bool
    char_canvas: Optional[int]
    char_window: Optional[int]
    device_tiles: bool
    gt_boxes: bool
    profile_dir: Optional[str]

    @classmethod
    def from_env(cls, env) -> "Settings":
        return cls(
            smoke=_flag(env, "BENCH_SMOKE"),
            preset=env.get("BENCH_PRESET", ""),
            quant=env.get("BENCH_QUANT", ""),
            callialign=_flag(env, "BENCH_CALLIALIGN", "1"),
            char_canvas=int(env.get("BENCH_CHAR_CANVAS", "0")) or None,
            char_window=int(env.get("BENCH_CHAR_WINDOW", "0")) or None,
            device_tiles=_flag(env, "BENCH_DEVICE_TILES", "1"),
            gt_boxes=bool(env.get("BENCH_GT_BOXES")),
            profile_dir=env.get("BENCH_PROFILE") or None,
        )

    def protocol(self, env) -> Protocol:
        if self.smoke:
            return Protocol(batch=2, n_batches=3, n_ttft=2, decode_tokens=8)
        return Protocol(batch=int(env.get("BENCH_BATCH", "16")))


def card_description() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0] if out else "unknown"


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


class StubDetector:
    """Runs the real detector's forward (its cost counted) but returns the
    page's known boxes; phased like the real one, so the pipelined schedule
    is the same."""

    def __init__(self, real, boxes):
        self.real, self.boxes = real, boxes

    def _known(self):
        return [list(b) for b in self.boxes]

    def __call__(self, img):
        self.real(img)
        return self._known()

    def dispatch(self, images):
        return self.real.dispatch(images)

    def fetch(self, handle):
        return self.real.fetch(handle)

    def postprocess(self, images, fetched):
        self.real.postprocess(images, fetched)
        return [self._known() for _ in images]

    def batch(self, images):
        return self.postprocess(images, self.fetch(self.dispatch(images)))


def build_row_engine(settings: Settings, device):
    """-> (engine, {"orderformer": mode, "callialign": mode}): the engine a
    row measures, built as bench.py builds it."""
    from callireader_tpu_torch.core.config import get_config
    from callireader_tpu_torch.runtime import engine as engine_mod
    from callireader_tpu_torch.runtime import weights

    preset = "callireader-tiny" if settings.smoke else (settings.preset or "callireader-2b")
    hidden = get_config(preset).llm.hidden_size
    ca_path = weights.ASSETS_DIR / "callialign.npz"
    use_ca = (not settings.smoke and settings.callialign and hidden == 4096
              and ca_path.exists() and weights.asset_version(ca_path) >= 3)
    assets = () if settings.smoke else ("orderformer",) + (("callialign",) if use_ca else ())
    # the shared tower's canvas lever; the compact tower keeps its own
    char_canvas = None if use_ca else settings.char_canvas
    engine = engine_mod.build_engine(
        preset, device=device, quant=settings.quant or None, assets=assets,
        device_tile_pages=settings.device_tiles, char_canvas=char_canvas,
        char_window=settings.char_window,
    )
    modes = {"orderformer": "trained_ckpt" if "orderformer" in engine.assets else "random",
             "callialign": "random"}
    if "callialign" in engine.assets:
        meta = json.loads(str(np.load(ca_path)["meta"]))
        acc = (meta.get("eval", {}).get("fix_clean") or [[0, 0, 0]])[0]
        modes["callialign"] = f"trained_ckpt(fix_acc={acc[-1]:.3f})"
        log(f"trained CalliAlign compact tower: fixture char acc {acc[-1]:.3f}")
    return engine, modes


def choose_detector(engine, page, gt_flat, *, smoke: bool, gt_boxes: bool) -> str:
    """bench.py's rule: the trained detector at the bench's operating point
    (conf 0.5, NMS IoU 0.3) when it finds >= 50 boxes on the page, else the
    GT stub over the engine's detector. Returns the fingerprint's mode."""
    from callireader_tpu_torch.models import detector as det_mod
    from callireader_tpu_torch.runtime import weights

    ckpt = weights.ASSETS_DIR / "detector_640.npz"
    if ckpt.exists() and not smoke and not gt_boxes:
        det_cfg = dataclasses.replace(engine.cfg.detector, conf_threshold=0.5, iou_threshold=0.3)
        det_params = det_mod.load_npz(str(ckpt), engine.device)
        real = det_mod.Detector(det_params, det_cfg, engine.device)
        n_found = len(real(page))
        log(f"trained detector: {n_found} boxes on the page (GT {len(gt_flat)})")
        if n_found >= 50:
            engine.params["detector"] = det_params
            engine.detector = real
            return "trained_ckpt"
        log("detector found <50 boxes; falling back to GT stub")
    engine.detector = StubDetector(engine.detector, gt_flat)
    return "gt_stub"


@dataclasses.dataclass
class RowRun:
    """A measured row: bench.py's result object, and what a caller may hold
    the run to (the box lists of the fused warm-up stage and of the last
    phased stage, the decodes launched)."""

    result: Dict[str, Any]
    fused_boxes: List[Any]
    phased_boxes: List[Any]
    n_decodes: int


def measure(engine, page, protocol: Protocol, *, n_chars: int, profile_dir: Optional[str] = None
            ) -> RowRun:
    """bench.py's measurement on a built engine: warm-up batch, TTFT, the
    pipelined schedule to convergence, then the measured intervals."""
    import torch

    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import generate as gen
    from callireader_tpu_torch.runtime.conversation import build_chat_prompt
    from callireader_tpu_torch.runtime.engine import ALIGNED
    from callireader_tpu_torch.utils.profiling import SPANS, STAGE_SPANS
    from callireader_tpu_torch.vision import preprocess

    cfg = engine.cfg
    on_cuda = engine.device.type == "cuda"
    B, T = protocol.batch, protocol.decode_tokens
    pages_list = [page] * B
    n_decodes = [0]

    def sync_device():
        if on_cuda:
            torch.cuda.synchronize(engine.device)

    def build_row():
        """The single-image chat_ocr front half -> (embeds, mask)."""
        pseudo, _idx = engine.calli_align(page)
        pixel_values = preprocess.load_image(page, cfg.force_image_size, cfg.max_dynamic_patch,
                                             cfg.use_thumbnail)
        img_embeds = engine.encode_image_tiles(engine._to_dev(pixel_values))
        n_pseudo = pseudo.shape[0] if pseudo is not None else 0
        conv = build_chat_prompt("<image>\n" + QUESTION + ALIGNED * n_pseudo)
        query = engine._expand_image_tokens(conv.get_prompt(), [pixel_values.shape[0]])
        ids = engine._tokenize_prompt(query)
        return engine._build_row_embeds(ids, img_embeds, pseudo, gen.bucket_length(len(ids)))

    def detect_boxes():
        """The unpipelined box stage (warm-up only)."""
        return engine.batch_sort_boxes(pages_list)

    def build_batch(ordered=None):
        return engine.batch_build_rows(pages_list, [QUESTION] * B, use_p=True,
                                       ordered_lists=ordered)

    def launch(rows):
        """One prefill + one decode of T tokens for built rows."""
        n_decodes[0] += 1
        return engine.batch_prepare([], [], prepared_rows=rows, max_new_tokens=T,
                                    repetition_penalty=1.0, eos_token_ids=(-1,))

    def sync(prepared):
        lengths = prepared["lengths"].cpu().numpy()
        if not (lengths == T).all():
            raise RuntimeError(f"a row decoded {lengths.tolist()} tokens, not {T}")

    with torch.inference_mode():
        # ---- 1. compile warm-up: every program of the batched path
        t0 = time.time()
        fused_boxes = detect_boxes()
        sync(launch(build_batch(fused_boxes)))
        warmup_s = time.time() - t0
        n_tiles = preprocess.load_image(page, cfg.force_image_size, cfg.max_dynamic_patch,
                                        cfg.use_thumbnail).shape[0]
        log(f"warmup: {warmup_s:.1f}s; per-image work: {n_chars} chars, {n_tiles} tiles, "
            f"{T} decode tokens")

        # ---- 2. TTFT: warm the single-image path, then timed samples
        def ttft_once():
            t0 = time.time()
            e, m = build_row()
            logits, _cache = internlm2.prefill(
                engine.params["llm"], cfg.llm, inputs_embeds=e, attention_mask=engine._to_dev(m),
                max_len=e.shape[1] + T, policy=engine.policy)
            _ = int(logits[0].argmax())  # the device-to-host read ends the sample
            return (time.time() - t0) * 1e3

        ttft_warm = [ttft_once(), ttft_once()]
        ttfts = [ttft_once() for _ in range(protocol.n_ttft)]
        p50_ttft = float(np.median(ttfts))
        log(f"TTFT ms: warm {ttft_warm[0]:.0f}/{ttft_warm[1]:.0f}; samples "
            f"{[round(t) for t in ttfts]} -> p50 {p50_ttft:.0f}")

        # ---- 3. throughput: pipeline to convergence, then measure
        # Schedule per interval (bench.py's): order dispatch (N+2), columns
        # (N+2), build (N+1), sync (N), order fetch (N+2), detector fetch
        # (N+3), launch (N+1), detector dispatch (N+4).
        SPANS.reset()
        state = {"ordered": detect_boxes()}
        state["dets"] = engine.detect_fetch(pages_list, engine.detect_dispatch(pages_list))
        prev = launch(build_batch(state["ordered"]))
        state["handle"] = engine.detect_dispatch(pages_list)
        sync_device()
        last = time.time()
        sync_waits: List[float] = []

        def pipeline_step():
            nonlocal prev, last
            odisp = engine.order_dispatch(engine.columns_stage(pages_list, state["dets"]))
            rows = build_batch(state["ordered"])
            t_sync = time.time()
            sync(prev)
            sync_device()
            now = time.time()
            sync_waits.append(now - t_sync)
            iv = now - last
            last = now
            state["ordered"] = engine.order_fetch(odisp)
            state["dets"] = engine.detect_fetch(pages_list, state["handle"])
            prev = launch(rows)
            state["handle"] = engine.detect_dispatch(pages_list)
            return iv

        warm_iv: List[float] = []
        t_warm = time.time()
        while (not converged(warm_iv) and time.time() - t_warm < protocol.warm_cap_s
               and len(warm_iv) < protocol.max_warm_batches):
            warm_iv.append(pipeline_step())
        did_converge = converged(warm_iv)
        log(f"convergence: {len(warm_iv)} batches {[round(v, 2) for v in warm_iv]} -> "
            f"{'converged' if did_converge else 'CAP HIT'}")

        n_prof = 0
        if profile_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_cuda else [])
            with profile(activities=activities) as prof:
                prof_iv = [pipeline_step() for _ in range(2)]
            n_prof = 2
            os.makedirs(profile_dir, exist_ok=True)
            trace_path = os.path.join(profile_dir, "bench_trace.json")
            prof.export_chrome_trace(trace_path)
            with open(os.path.join(profile_dir, "bench_kernels.txt"), "w") as f:
                f.write(prof.key_averages().table(
                    sort_by="cuda_time_total" if on_cuda else "cpu_time_total", row_limit=30))
            # the next interval holds the export (minutes at the 8b rows): unmeasured
            after = pipeline_step()
            n_prof = 3
            log(f"profile trace ({[round(v, 2) for v in prof_iv]}s; the export's interval "
                f"{after:.2f}s, not measured) -> {trace_path}")
        sync_waits.clear()  # warm-up and profile steps out
        intervals = [pipeline_step() for _ in range(protocol.n_batches - 1)]
        sync(prev)  # the last batch: its decode only, no overlapped build
        sync_device()
        intervals.append(time.time() - last)
        phased_boxes = state["ordered"]
    steady = intervals[:-1]

    med = float(np.median(steady))
    q25, q75 = np.percentile(steady, [25, 75])
    spread = float((q75 - q25) / med)
    dev_wait = float(np.median(sync_waits[:len(steady)])) if sync_waits else 0.0
    log(f"device wait inside interval: median {dev_wait:.2f}s of {med:.2f}s "
        f"({100 * dev_wait / max(med, 1e-9):.0f}%)")
    n_steps = len(warm_iv) + len(intervals) + n_prof
    host_per_batch = {k: round(SPANS.totals[k] / max(n_steps, 1), 3) for k in STAGE_SPANS
                      if k in SPANS.totals}
    blocked = sum(SPANS.totals.get(k, 0.0) for k in ("blocked.upload", "blocked.readback"))
    log(f"host-stage s/batch (the engine's spans, over {n_steps} pipeline steps): {host_per_batch} "
        f"-> total {round(sum(host_per_batch.values()), 2)}s of {med:.2f}s interval, "
        f"{blocked / max(n_steps, 1):.3f}s of it blocked in uploads and readbacks")
    log(f"measured intervals: {[round(v, 2) for v in intervals]}s (median {med:.2f}, spread "
        f"{spread:.2f}) -> {B / med:.4f} imgs/s")
    result = {
        "metric": METRIC,
        "value": round(B / med, 4),
        "unit": "imgs/sec",
        "vs_baseline": None,
        "p50_ttft_ms": round(p50_ttft, 1),
        "interval_spread": round(spread, 3),
        "device_wait_s": round(dev_wait, 2),
        "host_stage_s_per_batch": host_per_batch,
        "worst_interval_s": round(float(max(steady)), 2),
        "batches": [round(float(v), 3) for v in intervals],
        "converged": bool(did_converge),
        "warm_batches": len(warm_iv),
        "warmup_s": round(warmup_s, 1),
        "tiles_per_image": int(n_tiles),
    }
    return RowRun(result, fused_boxes, phased_boxes, n_decodes[0])


def run_row(env) -> Dict[str, Any]:
    """One row in this process -> bench.py's result object."""
    import torch

    settings = Settings.from_env(env)
    protocol = settings.protocol(env)
    if settings.smoke:
        device, device_desc = "cpu", "cpu"
    else:
        if not torch.cuda.is_available():
            raise NoCardError()
        device, device_desc = "cuda", card_description()
    log(f"device={device_desc} preset={settings.preset or '-'} quant={settings.quant or 'bf16'}")
    engine, modes = build_row_engine(settings, device)
    page, gt_flat = make_page()
    det_mode = choose_detector(engine, page, gt_flat, smoke=settings.smoke,
                               gt_boxes=settings.gt_boxes)
    # chars encoded per image: the post-dedup reading-order box count
    n_chars = len(engine.sort_boxes(page)) if det_mode == "trained_ckpt" else len(gt_flat)
    run = measure(engine, page, protocol, n_chars=n_chars, profile_dir=settings.profile_dir)
    result = run.result
    n_tiles = result.pop("tiles_per_image")
    result["workload"] = {
        "batch": protocol.batch,
        "preset": settings.preset or ("tiny" if settings.smoke else "callireader-2b"),
        "quant": settings.quant or "bf16",
        "page": "synthetic_clone",
        "detector": det_mode,
        "orderformer": modes["orderformer"],
        "callialign": modes["callialign"],
        "chars_per_image": int(n_chars),
        "tiles_per_image": n_tiles,
        "char_canvas": int(engine.char_canvas),
        "decode_tokens": protocol.decode_tokens,
        "stages": STAGES,
        "device": device_desc,
    }
    if settings.smoke:
        result["note"] = "BENCH_SMOKE: CPU shakedown of the measurement, not a performance number"
    return result


def _tail(text: str, n_lines: int = 6, n_chars: int = 600) -> str:
    return "\n".join((text or "").strip().splitlines()[-n_lines:])[-n_chars:]


def _row_summary(res: Dict[str, Any]) -> Dict[str, Any]:
    if "value" not in res:
        out = {k: res[k] for k in ("error", "rc", "stderr_tail", "row_wall_s") if k in res}
        if "error" in out:
            out["error"] = out["error"][:160]
        return out
    return {
        "value": res["value"],
        "p50_ttft_ms": res.get("p50_ttft_ms"),
        "interval_spread": res.get("interval_spread"),
        "converged": res.get("converged"),
        "device_wait_s": res.get("device_wait_s"),
        "row_wall_s": res.get("row_wall_s"),
        "device": res.get("workload", {}).get("device"),
    }


def combined_line(rows: Dict[str, Dict[str, Any]], order: Sequence[str]) -> str:
    """The orchestrator's last line: the headline and one summary a row,
    under LINE_LIMIT characters (failed rows' stderr tails are cut to fit)."""
    head = next((n for n in order if "value" in rows.get(n, {})), None)
    summary = {n: _row_summary(rows[n]) for n in order}
    out = {
        "metric": METRIC,
        "value": rows[head]["value"] if head else None,
        "unit": "imgs/sec",
        "vs_baseline": None,
        "headline_row": head,
        "p50_ttft_ms": rows[head].get("p50_ttft_ms") if head else None,
        "interval_spread": rows[head].get("interval_spread") if head else None,
        "device": rows[head].get("workload", {}).get("device") if head else None,
        "rows": summary,
    }
    line = json.dumps(out, ensure_ascii=False)
    tails = [s for s in summary.values() if s.get("stderr_tail")]
    while len(line) >= LINE_LIMIT and tails:
        # drop the head of the longest tail: its last lines say the most
        longest = max(tails, key=lambda s: len(s["stderr_tail"]))
        longest["stderr_tail"] = longest["stderr_tail"][-(len(longest["stderr_tail"]) * 3 // 4):]
        if len(longest["stderr_tail"]) < 8:
            tails.remove(longest)
        line = json.dumps(out, ensure_ascii=False)
    return line


def orchestrate(rows=ROWS, env=None, timeout_s: Optional[float] = None) -> Tuple[Dict, str]:
    """Each row in its own process -> ({name: result or failure}, combined
    line). A failure keeps the row's exit code and the tail of its stderr."""
    env = dict(os.environ if env is None else env)
    timeout_s = timeout_s or float(env.get("BENCH_ROW_TIMEOUT", "2400"))
    names = [n for n in env.get("BENCH_ROWS", "").split(",") if n]
    to_run = [(n, over) for n, over in rows if not names or n in names]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    results: Dict[str, Dict[str, Any]] = {}
    for name, over in to_run:
        row_env = dict(env, BENCH_SINGLE="1", **over)
        row_env["PYTHONPATH"] = os.pathsep.join(p for p in (root, env.get("PYTHONPATH")) if p)
        log(f"==== row {name} {over} ====")
        t0 = time.time()
        try:
            proc = subprocess.run([sys.executable, "-m", "callireader_tpu_torch.bench"],
                                  env=row_env, cwd=root, capture_output=True, text=True,
                                  timeout=timeout_s)
            rc, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc = 124
            out = e.stdout.decode(errors="replace") if isinstance(e.stdout, bytes) else (e.stdout or "")
            err = (e.stderr.decode(errors="replace") if isinstance(e.stderr, bytes)
                   else (e.stderr or "")) + f"\nrow timed out after {timeout_s:.0f} s"
        sys.stderr.write(err)
        lines = out.strip().splitlines()
        res = None
        if rc == 0 and lines:
            try:
                res = json.loads(lines[-1])
            except json.JSONDecodeError:
                res = None
        if res is None:
            res = {"error": f"row exited {rc}" + ("" if lines else ", no stdout"), "rc": rc,
                   "stderr_tail": _tail(err)}
            log(f"row {name} FAILED: rc {rc}: {res['stderr_tail']}")
        res["row_wall_s"] = round(time.time() - t0, 1)
        results[name] = res
        print(json.dumps({"row": name, **res}, ensure_ascii=False), flush=True)
    return results, combined_line(results, [n for n, _ in to_run])


def main(env=None) -> int:
    env = dict(os.environ if env is None else env)
    if _flag(env, "BENCH_SMOKE") or any(env.get(k) for k in SINGLE_KNOBS):
        try:
            result = run_row(env)
        except NoCardError as e:
            print(f"[bench] FAIL: {e}", file=sys.stderr)
            return 2
        print(json.dumps(result, ensure_ascii=False), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print(f"[bench] FAIL: {NoCardError()}", file=sys.stderr)
        return 2
    results, line = orchestrate(env=env)
    print(line, flush=True)
    return 0 if any("value" in r for r in results.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
