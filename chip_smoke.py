"""Chip smoke test of the PyTorch/CUDA port (callireader_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):
  1. build: compile every CUDA kernel of the port (one nvcc per source, in
     parallel) and print the card's name and power limit;
  2. main path, callireader-2b: build_engine("callireader-2b") with seeded
     random weights and the committed trained detector / OrderFormer /
     compact CalliAlign tower, then batch_chat_ocr (batch_prepare +
     batch_decode) on synthetic 788x2000 pages. Launch counts are zeroed just
     before and read just after; every attention kernel must have launched,
     the char path must have run, outputs must be finite. Per-stage timings
     and peak memory are printed;
  3. reference: on a small input (2 tiles through the 12-layer tile tower, one
     128-token row through the 8-layer LLM prefill and one decode step), the
     model run through the kernels against the same model with the attention
     swapped for the plain PyTorch versions;
  4. kernels: each attention kernel against its plain version (fp32 math on
     the same bf16 inputs) at the shapes the 2b main path launched it with,
     elementwise within the output's bf16 rounding plus a per-kernel ATOL
     (callireader_tpu_torch/kernels/tolerance.py); kernel, plain and one
     PyTorch library call (scaled_dot_product_attention, a yardstick the port
     never calls) timed with CUDA events; the least time the card could take
     (bound) computed from this run's inputs. The 2b engine is then freed;
  5. main path, flagship: build_engine("callireader-8b", quant="int8") (24-
     layer tile tower, 32-layer LLM with int8 weight-only fused projections
     and a 128-padded int8 vocab) and batch_chat_ocr on the same pages with
     256 new tokens. All counts zeroed before, read after: every kernel must
     have launched, the (K, N) int8 kernel 4 x 32 times per decode step and
     the LM-head kernel once per step plus once in prefill; token ids below
     the real vocabulary. Spans, prefill time, time per decode step against
     the step's weight bytes, and peak memory are printed;
  6. reference: one 128-token row, prefill plus one decode step through the
     kernels against the same 8b model with every kernel swapped for its
     plain version;
  7. attention kernels as in phase 4, at the shapes the 8b main path
     launched them with (its 32-layer cache, the deepest layer);
  8. int8 kernels: each against its plain version at the five main-path
     shapes (wqkv, wo, w13, w2 of the last layer; the LM head), timed with
     the weights cold in L2 (the (K, N) kernel walks the layers), beside
     the yardstick (bf16 torch.matmul against a dequantized bf16 copy of the
     weight, which the port never calls); the fused wqkv / w13 products,
     split, must equal the separate products bit for bit.
Prints the ``kernels`` JSON line, then the last line
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA or without the
port's sources next to it.
"""

import json
import subprocess
import sys
import time

import numpy as np

N_PAGES = 4
MAX_NEW_TOKENS = 64
MAX_NEW_TOKENS_8B = 256
PAGE_W, PAGE_H = 788, 2000
N_COLS, CHARS_PER_COL = 6, 16
QUESTION = "读出图中所有文字。"
# H100 SXM: 3.35 TB/s HBM, 989 TFLOP/s dense bf16 tensor cores (data sheet)
PEAK_BYTES_S = 3.35e12
PEAK_BF16_FLOPS = 989e12


def make_page(seed: int = 0):
    """Synthetic calligraphy page: 6 columns of 16 dark glyph blocks on
    noisy paper (the layout of the repo's bench page). -> (page, boxes)."""
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


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, torch, min_total_ms: float = 50.0, max_iters: int = 50) -> float:
    """Mean time per launch over a run of launches between two CUDA events,
    after one warm-up launch (the run is sized to ~min_total_ms)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    one = max(start.elapsed_time(end), 1e-3)
    iters = int(min(max_iters, max(3, min_total_ms / one)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(fn, torch, n: int):
    """Kernels on the device while ``fn`` runs ``n`` times under
    torch.profiler: {kernel name: (total device us, launches)}, empty if the
    trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, k = out.get(e.name, (0.0, 0))
            out[e.name] = (us + e.time_range.elapsed_us(), k + 1)
    return out


def device_ms(fn, torch, n: int = 16):
    """Device time per call (ms): the summed durations of the kernels that
    ``n`` calls launched, over ``n``; None if the trace has no device events."""
    kern = device_kernels(fn, torch, n)
    return sum(us for us, _ in kern.values()) / n / 1e3 if kern else None


class ShapeLog:
    """Records, per kernel wrapper, a light summary of each launch's inputs on
    the main path (the script wraps the wrappers' launch functions; the port
    is unchanged): shapes, plus the small mask tensors the kernel is held to."""

    SUMMARY = {
        "vit_attention": lambda a: (tuple(a[0].shape), a[1]),
        "flash_attention": lambda a: (tuple(a[0].shape), tuple(a[1].shape), a[3],
                                      a[4].clone(), a[5].clone(), a[7]),
        "flash_decode": lambda a: (tuple(a[0].shape), tuple(a[1].shape), a[3], a[4].clone()),
        "int8_matmul": lambda a: (a[0].shape[0], *a[1].shape),  # (M, K, N)
        "int8_matmul_nt": lambda a: (a[0].shape[0], a[1].shape[1], a[1].shape[0]),
    }

    def __init__(self, kernels):
        self.kernels = kernels
        self.calls = {name: [] for name in kernels}
        self._orig = {}

    def __enter__(self):
        for name, k in self.kernels.items():
            orig = getattr(k.module, k.launch)
            self._orig[name] = orig

            def rec(*args, _orig=orig, _name=name):
                summary = self.SUMMARY[_name](args)
                if _name == "flash_decode":  # keep the last step's mask only
                    self.calls[_name] = self.calls[_name][-1:]
                self.calls[_name].append(summary)
                return _orig(*args)

            setattr(k.module, k.launch, rec)
        return self

    def __exit__(self, *exc):
        for name, k in self.kernels.items():
            setattr(k.module, k.launch, self._orig[name])


class CallCount:
    """Counts calls of module functions (and times them with a device sync
    after each, where asked) while active."""

    def __init__(self, module, names, timed=(), torch=None):
        self.module, self.names, self.timed, self.torch = module, names, timed, torch
        self.n = {name: 0 for name in names}
        self.seconds = {name: 0.0 for name in names}

    def __enter__(self):
        self._orig = {name: getattr(self.module, name) for name in self.names}
        for name, orig in self._orig.items():
            def wrapped(*a, _orig=orig, _name=name, **kw):
                self.n[_name] += 1
                if _name not in self.timed:
                    return _orig(*a, **kw)
                self.torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _orig(*a, **kw)
                self.torch.cuda.synchronize()
                self.seconds[_name] += time.perf_counter() - t0
                return out

            setattr(self.module, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(self.module, name, orig)


class Swap:
    """Replaces module attributes while active."""

    def __init__(self, module, **repl):
        self.module, self.repl = module, repl

    def __enter__(self):
        self._orig = {k: getattr(self.module, k) for k in self.repl}
        for k, v in self.repl.items():
            setattr(self.module, k, v)
        return self

    def __exit__(self, *exc):
        for k, v in self._orig.items():
            setattr(self.module, k, v)


def main() -> int:
    import types

    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] CUDA is not available", file=sys.stderr)
        return 2
    try:
        from callireader_tpu_torch.kernels import _build
        from callireader_tpu_torch.kernels import attention as k_attn
        from callireader_tpu_torch.kernels import decode_attention as k_dec
        from callireader_tpu_torch.kernels import int8_matmul as k_i8
        from callireader_tpu_torch.kernels import tolerance
        from callireader_tpu_torch.kernels import vit_attention as k_vit
        from callireader_tpu_torch.models import internlm2, internvit
        from callireader_tpu_torch.runtime.engine import build_engine
        from callireader_tpu_torch.runtime.quantize import param_bytes
    except ImportError as e:
        print(f"[chip_smoke] the port is not importable here: {e}", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions run in full fp32
    dev = torch.device("cuda")

    def kernel(module, counter, launch, source, replaces, tol):
        return types.SimpleNamespace(module=module, counter=counter, launch=launch, tol=tol,
                                     source=f"callireader_tpu_torch/csrc/{source}.cu",
                                     replaces=f"callireader_tpu/kernels/{replaces}")

    kernels = {
        "vit_attention": kernel(k_vit, k_vit.KERNEL, "_launch", "vit_attention",
                                "vit_attention.py:208 (+ :73, packed_qkv_attention.py:94)",
                                "vit_attention"),
        "flash_attention": kernel(k_attn, k_attn.KERNEL, "_launch", "flash_attention",
                                  "attention.py:206", "flash_attention"),
        "flash_decode": kernel(k_dec, k_dec.KERNEL, "_launch", "flash_decode",
                               "decode_attention.py:88", "flash_decode"),
        "int8_matmul": kernel(k_i8, k_i8.KERNEL, "_launch", "int8_matmul",
                              "int8_matmul.py:131 int8_matmul_stacked (+ :187 int8_matmul)",
                              "int8_matmul"),
        "int8_matmul_nt": kernel(k_i8, k_i8.KERNEL_NT, "_launch_nt", "int8_matmul",
                                 "int8_matmul.py:74", "int8_matmul_nt"),
    }
    attention = ("vit_attention", "flash_attention", "flash_decode")

    def zero_counts():
        for k in kernels.values():
            k.counter.launches = 0

    def read_counts():
        return {name: k.counter.launches for name, k in kernels.items()}

    # ---------------------------------------------------------- 1. build
    t0 = time.time()
    logs = _build.build_all(sorted({k.counter.source for k in kernels.values()}), force=True)
    log(f"built {len(logs)} kernel libraries in {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    gpu_name = torch.cuda.get_device_name(0)
    log(f"card: {smi}")

    pages_boxes = [make_page(seed) for seed in range(N_PAGES)]
    pages = [p for p, _ in pages_boxes]

    def run_main_path(engine, max_new_tokens, label):
        """Warm-up of the box stage, then batch_chat_ocr with every count
        zeroed just before and read just after."""
        dets = engine.batch_sort_boxes(pages)  # warm-up of the box stage, and its count
        ordered = None
        if min(len(d) for d in dets) == 0:
            ordered = [b for _, b in pages_boxes]
            log("the detector found no boxes on a synthetic page: the batch runs with the "
                "pages' known boxes through ordered_lists")
        else:
            log(f"detector + OrderFormer: {[len(d) for d in dets]} ordered char boxes per page")
        zero_counts()
        engine.timings.spans.clear()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        with ShapeLog(kernels) as shapes, CallCount(internlm2, ("prefill", "decode_step"),
                                                    timed=("prefill",), torch=torch) as steps:
            prepared = engine.batch_prepare(
                pages, [QUESTION] * N_PAGES, max_new_tokens=max_new_tokens,
                repetition_penalty=1.5, ordered_lists=ordered)
            texts = engine.batch_decode(prepared)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[{label}] batch_chat_ocr on {N_PAGES} pages: {wall:.3f} s wall, peak memory {peak:.2f} GiB")
        log(f"[{label}] stage timings (s): "
            + json.dumps({k: round(v, 4) for k, v in engine.timings.spans.items()}))
        log(f"[{label}] launches: {launches}")
        char_calls = [a for a in shapes.calls["vit_attention"]
                      if a[0][-1] // 3 // a[1] != engine.cfg.vision.head_dim]
        if engine.cfg.char_vision is None or not char_calls:
            fail(f"[{label}] the char path did not run through the compact char tower")
        embeds, tokens, lengths = prepared["embeds"], prepared["tokens"], prepared["lengths"]
        if not torch.isfinite(embeds.float()).all():
            fail(f"[{label}] non-finite prompt embeddings")
        if tokens.shape != (N_PAGES, max_new_tokens) or not ((lengths >= 1) & (lengths <= max_new_tokens)).all():
            fail(f"[{label}] bad generate output shapes {tuple(tokens.shape)} {lengths.tolist()}")
        vocab = engine.cfg.llm.real_vocab_size or engine.cfg.llm.vocab_size
        if not ((tokens >= 0) & (tokens < vocab)).all():
            fail(f"[{label}] token ids out of the vocabulary ({vocab})")
        log(f"[{label}] prompt bucket {embeds.shape[1]}, generated lengths {lengths.tolist()}, "
            f"first response {texts[0][:40]!r}")
        return types.SimpleNamespace(prepared=prepared, shapes=shapes, launches=launches, wall=wall,
                                     peak=peak, steps=steps, spans=dict(engine.timings.spans))

    # ---------------------------------------------------------- 2. main path, 2b
    t0 = time.time()
    engine = build_engine("callireader-2b", device="cuda")
    torch.cuda.synchronize()
    log(f"engine built in {time.time() - t0:.1f} s: char tower "
        f"{engine.cfg.char_vision.hidden_size if engine.cfg.char_vision else 'shared'} wide, "
        f"detector {'trained' if engine.cfg.detector.img_size == 640 else 'random'}")
    run2b = run_main_path(engine, MAX_NEW_TOKENS, "2b")
    missing = [n for n in attention if run2b.launches[n] == 0]
    if missing:
        fail(f"kernels never launched on the 2b main path: {missing}")
    shapes, launches_2b = run2b.shapes, run2b.launches
    embeds = run2b.prepared["embeds"]

    # ---------------------------------------------------------- 3. reference
    torch.manual_seed(0)
    tiles = torch.randint(0, 256, (2, 448, 448, 3), dtype=torch.uint8, device=dev)
    hid_k = internvit.forward(engine.params["vision"], engine.cfg.vision, tiles)
    with Swap(internvit, attention_from_packed_qkv_nomax=lambda qkv, h: k_vit.vit_attention_reference(qkv, h)):
        hid_p = internvit.forward(engine.params["vision"], engine.cfg.vision, tiles)
    vit_rel = ((hid_k.float() - hid_p.float()).abs().max() / hid_p.float().abs().max()).item()

    def llm_rel_err(engine, embeds, plain):
        """Prefill of one 128-token row plus one decode step through the
        kernels against the same model with the plain versions in ``plain``."""
        row = embeds[:1, -128:].contiguous()
        mask = torch.ones((1, 128), dtype=torch.int32, device=dev)
        mask[0, :17] = 0
        llm, cfg = engine.params["llm"], engine.cfg.llm
        lg_k, cache_k = internlm2.prefill(llm, cfg, inputs_embeds=row, attention_mask=mask, max_len=136)
        tok = lg_k.argmax(-1)[:, None].int()
        st_k, _ = internlm2.decode_step(llm, cfg, input_ids=tok, cache=cache_k)
        with Swap(internlm2, **plain):
            lg_p, cache_p = internlm2.prefill(llm, cfg, inputs_embeds=row, attention_mask=mask, max_len=136)
            st_p, _ = internlm2.decode_step(llm, cfg, input_ids=tok, cache=cache_p)
        vocab = cfg.real_vocab_size or cfg.vocab_size
        return max(((a[:, :vocab] - b[:, :vocab]).abs().max() / b[:, :vocab].abs().max()).item()
                   for a, b in ((lg_k, lg_p), (st_k, st_p)))

    plain_attention = dict(flash_attention=k_attn.attention_reference,
                           flash_decode=k_dec.flash_decode_reference)
    llm_rel = llm_rel_err(engine, embeds, plain_attention)
    log(f"reference check: tile tower rel err {vit_rel:.3e}, LLM prefill+decode logits rel err {llm_rel:.3e}")
    if not (vit_rel <= 5e-2 and llm_rel <= 5e-2):
        fail("model through the kernels disagrees with the plain-attention model")

    # ---------------------------------------------------------- 4. kernels
    del engine, run2b, embeds, hid_k, hid_p
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def row_for(name, shape_desc, run_k, run_plain, run_lib, nbytes, flops, time_k=None):
        """Check ``run_k`` against ``run_plain``, then time ``time_k`` (default
        ``run_k``), the plain version and the library call."""
        out_k = run_k()
        torch.cuda.synchronize()
        out_p = run_plain()
        err = tolerance.max_abs_error(out_k, out_p)
        excess = tolerance.excess_error(out_k, out_p)
        del out_k, out_p
        ms = time_ms(time_k or run_k, torch)
        plain_ms = time_ms(run_plain, torch, max_iters=5)
        lib_ms = time_ms(run_lib, torch) if run_lib is not None else None
        dev_ms = device_ms(time_k or run_k, torch)
        dev_lib = device_ms(run_lib, torch) if run_lib is not None else None
        b_ms, b_by = bound(nbytes, flops)
        tol = tolerance.ATOL[kernels[name].tol]
        log(f"{name} {shape_desc}: max_abs_err {err:.3e}, beyond bf16 output rounding "
            f"{excess:.3e} (tol {tol}), {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            f"bound {b_ms:.4f} ms ({b_by}); device time from the profiler: kernel "
            f"{dev_ms if dev_ms is None else round(dev_ms, 4)} ms, library "
            f"{dev_lib if dev_lib is None else round(dev_lib, 4)} ms")
        if excess > tol:
            fail(f"{name} disagrees with its plain version at {shape_desc}")
        return err, ms, plain_ms, lib_ms, b_ms, b_by, dev_ms

    results = {}

    def attention_rows(path, shapes, launches):
        """Each attention kernel against its plain version at the shapes the
        ``path`` main path launched it with; one row per kernel and shape,
        carrying that run's launch counts."""
        # ViT: the tile tower (D=64) and the char tower (D=32), each at the
        # largest batch the main path launched it with; launches split by tower
        towers = {}
        for (B, S, threeE), H in shapes.calls["vit_attention"]:
            key = (S, H, threeE // 3 // H)
            n, b_max = towers.get(key, (0, 0))
            towers[key] = (n + 1, max(b_max, B))
        if sum(n for n, _ in towers.values()) != launches["vit_attention"]:
            fail(f"[{path}] ViT launches by tower {towers} disagree with the kernel's count "
                 f"{launches['vit_attention']}")
        for (S, H, D), (n_calls, B) in sorted(towers.items()):
            E = H * D
            qkv = rnd((B, S, 3 * E))
            x = qkv.view(B, S, 3, H, D)
            qv, kv_, vv = (x[:, :, i].transpose(1, 2) for i in range(3))
            r = row_for("vit_attention", f"[{path}] B={B} S={S} H={H} D={D}",
                        lambda: k_vit.attention_from_packed_qkv_nomax(qkv, H),
                        lambda: k_vit.vit_attention_reference(qkv.float(), H),
                        lambda: F.scaled_dot_product_attention(qv, kv_, vv),
                        nbytes=2 * B * S * 4 * E, flops=4 * B * H * S * S * D)
            results.setdefault("vit_attention", []).append(
                (f"{path} " + "x".join(map(str, (B, S, H, D))), n_calls, r))
            del qkv, x, qv, kv_, vv

        # prefill flash attention at the main path's shape and segment ids
        q_shape, k_shape, causal, qseg, kseg, q_off = shapes.calls["flash_attention"][0]
        B, Hq, Sq, D = q_shape
        Hkv, Sk = k_shape[1], k_shape[2]
        q, k, v = rnd(q_shape), rnd(k_shape), rnd(k_shape)
        seg_mask = qseg[:, :, None] == kseg[:, None, :]
        causal_mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev).tril(q_off)
        allowed = seg_mask & causal_mask
        pairs = int(allowed.sum().item())
        r = row_for("flash_attention", f"[{path}] B={B} Hq={Hq} Hkv={Hkv} S={Sq} D={D} causal",
                    lambda: k_attn.flash_attention(q, k, v, causal=True, q_segment_ids=qseg,
                                                   kv_segment_ids=kseg),
                    lambda: k_attn.attention_reference(q.float(), k.float(), v.float(), causal=True,
                                                       q_segment_ids=qseg, kv_segment_ids=kseg),
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed[:, None],
                                                           enable_gqa=True),
                    nbytes=2 * (2 * q.numel() + 2 * k.numel()) + 4 * (qseg.numel() + kseg.numel()),
                    flops=4 * pairs * Hq * D)
        results.setdefault("flash_attention", []).append(
            (f"{path} B={B} S={Sq}", launches["flash_attention"], r))
        del allowed, seg_mask, causal_mask, q, k, v
        torch.cuda.empty_cache()

        # decode over the whole stacked cache at the main path's last step,
        # at its deepest layer
        q_shape, c_shape, _layer, valid_d = shapes.calls["flash_decode"][-1]
        L, B, Hkv, S, D = c_shape
        Hq = q_shape[1]
        qd, ckd, cvd = rnd(q_shape), rnd(c_shape), rnd(c_shape)
        valid = valid_d.clone()
        n_valid = int((valid > 0).sum().item())
        lay = L - 1
        r = row_for("flash_decode", f"[{path}] B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} L={L} layer={lay}",
                    lambda: k_dec.flash_decode(qd, ckd, cvd, lay, valid),
                    lambda: k_dec.flash_decode_reference(qd.float(), ckd, cvd, lay, valid),
                    lambda: F.scaled_dot_product_attention(qd, ckd[lay], cvd[lay],
                                                           attn_mask=(valid > 0)[:, None, None, :],
                                                           enable_gqa=True),
                    nbytes=2 * (2 * n_valid * Hkv * D + 2 * qd.numel()) + 4 * valid.numel(),
                    flops=4 * n_valid * Hq * D)
        results.setdefault("flash_decode", []).append(
            (f"{path} L={L} S={S}", launches["flash_decode"], r))
        del qd, ckd, cvd
        torch.cuda.empty_cache()

    attention_rows("2b", shapes, launches_2b)
    del shapes
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 5. main path, 8b int8
    t0 = time.time()
    engine = build_engine("callireader-8b", device="cuda", quant="int8")
    torch.cuda.synchronize()
    cfg = engine.cfg.llm
    llm = engine.params["llm"]
    L = cfg.num_hidden_layers
    step_bytes = param_bytes({k: v for k, v in llm["layers"].items() if k.endswith(("_q", "_scale"))}) \
        + param_bytes([llm["output_q"], llm["output_scale"]])
    log(f"[8b] engine built in {time.time() - t0:.1f} s: ViT {engine.cfg.vision.num_hidden_layers} "
        f"layers, LLM {L} layers int8 ({param_bytes(llm) / 1e9:.3f} GB, vocab {cfg.vocab_size} "
        f"padded from {cfg.real_vocab_size}), device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    run8 = run_main_path(engine, MAX_NEW_TOKENS_8B, "8b")
    launches_8b = run8.launches
    missing = [n for n, c in launches_8b.items() if c == 0]
    if missing:
        fail(f"kernels never launched on the 8b int8 main path: {missing}")
    n_steps = run8.steps.n["decode_step"]
    if run8.steps.n["prefill"] != 1 or n_steps < 1:
        fail(f"[8b] expected one prefill and some decode steps, got {run8.steps.n}")
    if launches_8b["int8_matmul"] != 4 * L * n_steps:
        fail(f"[8b] (K, N) int8 launches {launches_8b['int8_matmul']} != 4 x {L} x {n_steps}")
    if launches_8b["int8_matmul_nt"] != n_steps + 1:
        fail(f"[8b] LM-head int8 launches {launches_8b['int8_matmul_nt']} != {n_steps} + 1")
    if len(run8.shapes.calls["int8_matmul"]) != launches_8b["int8_matmul"]:
        fail("[8b] int8 launches seen by the shape log disagree with the kernel's count")
    prefill_s = run8.steps.seconds["prefill"]
    decode_ms = (run8.spans["generate"] - prefill_s) / n_steps * 1e3
    floor_ms = step_bytes / PEAK_BYTES_S * 1e3
    log(f"[8b] prefill {prefill_s:.4f} s; {n_steps} decode steps at {decode_ms:.3f} ms a step "
        f"(host clock, generate span minus prefill); the step's int8 weights are "
        f"{step_bytes / 1e9:.4f} GB, a floor of {floor_ms:.3f} ms at 3.35 TB/s")

    # ---------------------------------------------------------- 6. reference, 8b
    plain_int8 = dict(int8_matmul=k_i8.int8_matmul_reference,
                      int8_matmul_nt=k_i8.int8_matmul_nt_reference)
    llm_rel = llm_rel_err(engine, run8.prepared["embeds"], dict(plain_attention, **plain_int8))
    part_rel = {name: llm_rel_err(engine, run8.prepared["embeds"], plain)
                for name, plain in (("attention", plain_attention), ("int8", plain_int8))}
    log(f"[8b] reference check: LLM prefill+decode logits rel err {llm_rel:.3e} "
        f"(every kernel against its plain version; only the attention kernels swapped "
        f"{part_rel['attention']:.3e}, only the int8 kernels {part_rel['int8']:.3e})")
    if not llm_rel <= 5e-2:
        fail("the 8b int8 model through the kernels disagrees with the plain-version model")

    # where a decode step's time goes: device kernel time against the step's
    # host-clock time, from a profiler trace of 4 steps at the main path's shape
    embeds8 = run8.prepared["embeds"]
    B8, S8 = embeds8.shape[:2]
    n_prof = 4
    logits, cache = internlm2.prefill(llm, cfg, inputs_embeds=embeds8,
                                      attention_mask=torch.ones((B8, S8), dtype=torch.int32, device=dev),
                                      max_len=S8 + 4 * n_prof)
    tok = logits.argmax(-1)[:, None].int()
    state = {"cache": cache}

    def one_step():
        _, state["cache"] = internlm2.decode_step(llm, cfg, input_ids=tok, cache=state["cache"])

    with torch.inference_mode():  # as generate runs it
        one_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_prof):
            one_step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / n_prof * 1e3
        kern = device_kernels(one_step, torch, n_prof)
    if kern:
        busy_ms = sum(us for us, _ in kern.values()) / n_prof / 1e3
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
        log(f"[8b] decode step profile: {step_ms:.3f} ms a step on the host clock (no profiler), "
            f"{busy_ms:.3f} ms of device kernels a step ({sum(k for _, k in kern.values()) / n_prof:.0f} "
            f"kernels), device idle {100 * (1 - busy_ms / step_ms):.1f}%; by kernel (us a step, "
            f"launches a step): " + "; ".join(
                f"{name[:48]} {us / n_prof:.1f} ({k // n_prof})" for name, (us, k) in top))
    else:
        log("[8b] decode step profile: the profiler trace holds no device events (not measured)")
    del logits, cache, state, embeds8

    # ---------------------------------------------------------- 7. attention kernels, 8b
    attention_rows("8b", run8.shapes, launches_8b)

    # ---------------------------------------------------------- 8. int8 kernels
    kn_shapes = {}
    for shape in run8.shapes.calls["int8_matmul"]:
        kn_shapes[shape] = kn_shapes.get(shape, 0) + 1
    nt_shapes = set(run8.shapes.calls["int8_matmul_nt"])
    del run8
    torch.cuda.empty_cache()
    layers = llm["layers"]
    M = N_PAGES

    def int8_row(name, label, run_k, time_k, run_plain, wd, nt, M, K, N, n_launch):
        x = rnd((M, K))
        n_rot = max(1, min(len(wd), -(-200_000_000 // (K * N * 2))))
        rot = [0]

        def lib():  # the yardstick, cold: walks bf16 copies worth >= 200 MB
            rot[0] = (rot[0] + 1) % n_rot
            return x @ (wd[rot[0]].T if nt else wd[rot[0]])

        r = row_for(name, f"{label} M={M} K={K} N={N}", lambda: run_k(x), lambda: run_plain(x.float()),
                    lib, nbytes=K * N + 4 * N + 2 * M * K + 2 * M * N, flops=2 * M * K * N,
                    time_k=lambda: time_k(x))
        results.setdefault(name, []).append((f"8b {label} {M}x{K}x{N}", n_launch, r))

    for label in ("wqkv", "wo", "w13", "w2"):
        q, s = layers[f"{label}_q"], layers[f"{label}_scale"]
        K, N = q.shape[1:]
        n_launch = kn_shapes.get((M, K, N), 0)
        if n_launch != L * n_steps:
            fail(f"[8b] {label} ({M}x{K}x{N}) launched {n_launch} times, expected {L} x {n_steps}")
        walk = [0]

        def time_k(x, q=q, s=s):  # cold: one layer after the other, as in decode
            walk[0] = (walk[0] + 1) % L
            return k_i8.int8_matmul(x, q[walk[0]], s[walk[0]])

        n_copies = max(1, -(-200_000_000 // (K * N * 2)))
        wd = [(q[L - 1 - i].float() * s[L - 1 - i]).bfloat16() for i in range(min(n_copies, L))]
        int8_row("int8_matmul", label,
                 lambda x, q=q, s=s: k_i8.int8_matmul(x, q[L - 1], s[L - 1]), time_k,
                 lambda xf, q=q, s=s: k_i8.int8_matmul_reference(xf, q[L - 1], s[L - 1]),
                 wd, False, M, K, N, n_launch)
        del wd
        torch.cuda.empty_cache()

    q, s = llm["output_q"], llm["output_scale"].reshape(-1)
    N, K = q.shape
    if nt_shapes != {(M, K, N)}:
        fail(f"[8b] LM-head launches at {nt_shapes}, expected {(M, K, N)}")
    wd = [(q.float() * s[:, None]).bfloat16()]
    int8_row("int8_matmul_nt", "lm_head", lambda x: k_i8.int8_matmul_nt(x, q, s),
             lambda x: k_i8.int8_matmul_nt(x, q, s),
             lambda xf: k_i8.int8_matmul_nt_reference(xf, q, s), wd, True, M, K, N,
             launches_8b["int8_matmul_nt"])
    del wd
    torch.cuda.empty_cache()

    # fused products, split, equal the separate products bit for bit
    x = rnd((M, cfg.hidden_size))
    D = cfg.head_dim
    for label, splits in (("wqkv", [cfg.num_attention_heads * D, cfg.num_key_value_heads * D,
                                    cfg.num_key_value_heads * D]),
                          ("w13", [cfg.intermediate_size] * 2)):
        q, s = layers[f"{label}_q"][L - 1], layers[f"{label}_scale"][L - 1, 0]
        fused = k_i8.int8_matmul(x, q, s)
        for i, (got, qp, sp) in enumerate(zip(fused.split(splits, 1), q.split(splits, 1), s.split(splits))):
            if not torch.equal(got, k_i8.int8_matmul(x, qp.contiguous(), sp.contiguous())):
                fail(f"fused {label} part {i} differs from its separate product")
    log("fused wqkv / w13 outputs, split, equal the separate products bit for bit")

    line = []
    for name, entries in results.items():
        for label, n_launch, (err, ms, plain_ms, lib_ms, b_ms, b_by, dev_ms) in entries:
            line.append({
                "name": f"{name}[{label}]",
                "route": "cuda", "source": kernels[name].source, "replaces": kernels[name].replaces,
                "launches": n_launch, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
                "device_ms": dev_ms,
            })
    print(smi, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": gpu_name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
