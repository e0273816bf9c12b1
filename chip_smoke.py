"""Chip smoke test of the PyTorch/CUDA port (callireader_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and continued):
  1. build: compile every CUDA kernel of the port (one nvcc per source, in
     parallel) and print the card's name and power limit;
  2. main path: build_engine("callireader-2b") with seeded random weights and
     the committed trained detector / OrderFormer / compact CalliAlign tower,
     then batch_chat_ocr (batch_prepare + batch_decode) on synthetic 788x2000
     pages. Launch counts are zeroed just before and read just after; every
     kernel must have launched, the char path must have run, outputs must be
     finite. Per-stage timings and peak memory are printed;
  3. reference: on a small input (2 tiles through the 12-layer tile tower, one
     128-token row through the 8-layer LLM prefill and one decode step), the
     model run through the kernels against the same model with the attention
     swapped for the plain PyTorch versions;
  4. kernels: each kernel against its plain version (fp32 math on the same
     bf16 inputs) at the shapes the main path launched it with, elementwise
     within the output's bf16 rounding plus a per-kernel ATOL
     (callireader_tpu_torch/kernels/tolerance.py); kernel,
     plain and one PyTorch library call (scaled_dot_product_attention, a
     yardstick the port never calls) timed with CUDA events; the least time
     the card could take (bound) computed from this run's inputs.
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


class ShapeLog:
    """Records, per kernel wrapper, a light summary of each launch's inputs on
    the main path (the script wraps the wrappers' ``_launch``; the port is
    unchanged): shapes, plus the small mask tensors the kernel is held to."""

    SUMMARY = {
        "vit_attention": lambda a: (tuple(a[0].shape), a[1]),
        "flash_attention": lambda a: (tuple(a[0].shape), tuple(a[1].shape), a[3],
                                      a[4].clone(), a[5].clone(), a[7]),
        "flash_decode": lambda a: (tuple(a[0].shape), tuple(a[1].shape), a[3], a[4].clone()),
    }

    def __init__(self, modules):
        self.modules = modules
        self.calls = {name: [] for name in modules}
        self._orig = {}

    def __enter__(self):
        for name, mod in self.modules.items():
            orig = mod._launch
            self._orig[name] = orig

            def rec(*args, _orig=orig, _name=name):
                summary = self.SUMMARY[_name](args)
                if _name == "flash_decode":  # keep the last step's mask only
                    self.calls[_name] = self.calls[_name][-1:]
                self.calls[_name].append(summary)
                return _orig(*args)

            mod._launch = rec
        return self

    def __exit__(self, *exc):
        for name, mod in self.modules.items():
            mod._launch = self._orig[name]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("[chip_smoke] CUDA is not available", file=sys.stderr)
        return 2
    try:
        from callireader_tpu_torch.kernels import _build
        from callireader_tpu_torch.kernels import attention as k_attn
        from callireader_tpu_torch.kernels import decode_attention as k_dec
        from callireader_tpu_torch.kernels import tolerance
        from callireader_tpu_torch.kernels import vit_attention as k_vit
        from callireader_tpu_torch.models import internlm2, internvit
        from callireader_tpu_torch.runtime.engine import build_engine
    except ImportError as e:
        print(f"[chip_smoke] the port is not importable here: {e}", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    dev = torch.device("cuda")
    kernels = {"vit_attention": k_vit, "flash_attention": k_attn, "flash_decode": k_dec}
    sources = {"vit_attention": "callireader_tpu_torch/csrc/vit_attention.cu",
               "flash_attention": "callireader_tpu_torch/csrc/flash_attention.cu",
               "flash_decode": "callireader_tpu_torch/csrc/flash_decode.cu"}
    replaces = {
        "vit_attention": "callireader_tpu/kernels/vit_attention.py:208 (+ :73, packed_qkv_attention.py:94)",
        "flash_attention": "callireader_tpu/kernels/attention.py:206",
        "flash_decode": "callireader_tpu/kernels/decode_attention.py:88",
    }

    # ---------------------------------------------------------- 1. build
    t0 = time.time()
    logs = _build.build_all([k.KERNEL.source for k in kernels.values()], force=True)
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

    # ---------------------------------------------------------- 2. main path
    t0 = time.time()
    engine = build_engine("callireader-2b", device="cuda")
    torch.cuda.synchronize()
    log(f"engine built in {time.time() - t0:.1f} s: char tower "
        f"{engine.cfg.char_vision.hidden_size if engine.cfg.char_vision else 'shared'} wide, "
        f"detector {'trained' if engine.cfg.detector.img_size == 640 else 'random'}")
    pages_boxes = [make_page(seed) for seed in range(N_PAGES)]
    pages = [p for p, _ in pages_boxes]
    dets = engine.batch_sort_boxes(pages)  # warm-up of the box stage, and its count
    ordered = None
    if min(len(d) for d in dets) == 0:
        ordered = [b for _, b in pages_boxes]
        log("the detector found no boxes on a synthetic page: the batch runs with the "
            "pages' known boxes through ordered_lists")
    else:
        log(f"detector + OrderFormer: {[len(d) for d in dets]} ordered char boxes per page")

    for k in kernels.values():
        k.KERNEL.launches = 0
    engine.timings.spans.clear()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    with ShapeLog(kernels) as shapes:
        prepared = engine.batch_prepare(
            pages, [QUESTION] * N_PAGES, max_new_tokens=MAX_NEW_TOKENS,
            repetition_penalty=1.5, ordered_lists=ordered)
        texts = engine.batch_decode(prepared)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {name: k.KERNEL.launches for name, k in kernels.items()}
    log(f"batch_chat_ocr on {N_PAGES} pages: {wall:.3f} s wall, peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("stage timings (s): " + json.dumps({k: round(v, 4) for k, v in engine.timings.spans.items()}))
    log(f"launches: {launches}")
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    char_calls = [a for a in shapes.calls["vit_attention"]
                  if a[0][-1] // 3 // a[1] != engine.cfg.vision.head_dim]
    if engine.cfg.char_vision is None or not char_calls:
        fail("the char path did not run through the compact char tower")
    embeds, tokens, lengths = prepared["embeds"], prepared["tokens"], prepared["lengths"]
    if not torch.isfinite(embeds.float()).all():
        fail("non-finite prompt embeddings")
    if tokens.shape != (N_PAGES, MAX_NEW_TOKENS) or not ((lengths >= 1) & (lengths <= MAX_NEW_TOKENS)).all():
        fail(f"bad generate output shapes {tuple(tokens.shape)} {lengths.tolist()}")
    if not ((tokens >= 0) & (tokens < engine.cfg.llm.vocab_size)).all():
        fail("token ids out of the vocabulary")
    log(f"prompt bucket {prepared['embeds'].shape[1]}, generated lengths {lengths.tolist()}, "
        f"first response {texts[0][:40]!r}")

    # ---------------------------------------------------------- 3. reference
    torch.manual_seed(0)
    tiles = torch.randint(0, 256, (2, 448, 448, 3), dtype=torch.uint8, device=dev)
    hid_k = internvit.forward(engine.params["vision"], engine.cfg.vision, tiles)
    orig_vit = internvit.attention_from_packed_qkv_nomax
    internvit.attention_from_packed_qkv_nomax = lambda qkv, h: k_vit.vit_attention_reference(qkv, h)
    try:
        hid_p = internvit.forward(engine.params["vision"], engine.cfg.vision, tiles)
    finally:
        internvit.attention_from_packed_qkv_nomax = orig_vit
    vit_rel = ((hid_k.float() - hid_p.float()).abs().max() / hid_p.float().abs().max()).item()

    row = embeds[:1, -128:].contiguous()
    mask = torch.ones((1, 128), dtype=torch.int32, device=dev)
    mask[0, :17] = 0
    llm = engine.params["llm"]
    lg_k, cache_k = internlm2.prefill(llm, engine.cfg.llm, inputs_embeds=row, attention_mask=mask, max_len=136)
    st_k, _ = internlm2.decode_step(llm, engine.cfg.llm, input_ids=lg_k.argmax(-1)[:, None].int(), cache=cache_k)
    orig_fa, orig_fd = internlm2.flash_attention, internlm2.flash_decode
    internlm2.flash_attention = k_attn.attention_reference
    internlm2.flash_decode = k_dec.flash_decode_reference
    try:
        lg_p, cache_p = internlm2.prefill(llm, engine.cfg.llm, inputs_embeds=row, attention_mask=mask, max_len=136)
        st_p, _ = internlm2.decode_step(llm, engine.cfg.llm, input_ids=lg_k.argmax(-1)[:, None].int(), cache=cache_p)
    finally:
        internlm2.flash_attention, internlm2.flash_decode = orig_fa, orig_fd
    llm_rel = max(((a - b).abs().max() / b.abs().max()).item() for a, b in ((lg_k, lg_p), (st_k, st_p)))
    log(f"reference check: tile tower rel err {vit_rel:.3e}, LLM prefill+decode logits rel err {llm_rel:.3e}")
    if not (vit_rel <= 5e-2 and llm_rel <= 5e-2):
        fail("model through the kernels disagrees with the plain-attention model")

    # ---------------------------------------------------------- 4. kernels
    del engine, prepared, embeds, hid_k, hid_p, cache_k, cache_p
    torch.cuda.empty_cache()
    rows = []
    gen = torch.Generator(device=dev).manual_seed(1)

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    def bound(nbytes, flops):
        t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_BF16_FLOPS * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

    def row_for(name, shape_desc, run_k, run_plain, run_lib, nbytes, flops):
        out_k = run_k()
        torch.cuda.synchronize()
        out_p = run_plain()
        err = tolerance.max_abs_error(out_k, out_p)
        excess = tolerance.excess_error(out_k, out_p)
        del out_k, out_p
        ms = time_ms(run_k, torch)
        plain_ms = time_ms(run_plain, torch, max_iters=5)
        lib_ms = time_ms(run_lib, torch) if run_lib is not None else None
        b_ms, b_by = bound(nbytes, flops)
        log(f"{name} {shape_desc}: max_abs_err {err:.3e}, beyond bf16 output rounding "
            f"{excess:.3e} (tol {tolerance.ATOL[name]}), {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, library {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        if excess > tolerance.ATOL[name]:
            fail(f"{name} disagrees with its plain version at {shape_desc}")
        return err, ms, plain_ms, lib_ms, b_ms, b_by

    results = {}
    # ViT: the tile tower (D=64) and the char tower (D=32), each at the
    # largest batch the main path launched it with; launches split by tower
    towers = {}
    for (B, S, threeE), H in shapes.calls["vit_attention"]:
        key = (S, H, threeE // 3 // H)
        n, b_max = towers.get(key, (0, 0))
        towers[key] = (n + 1, max(b_max, B))
    if sum(n for n, _ in towers.values()) != launches["vit_attention"]:
        fail(f"ViT launches by tower {towers} disagree with the kernel's count "
             f"{launches['vit_attention']}")
    for (S, H, D), (n_calls, B) in sorted(towers.items()):
        E = H * D
        qkv = rnd((B, S, 3 * E))
        x = qkv.view(B, S, 3, H, D)
        qv, kv_, vv = (x[:, :, i].transpose(1, 2) for i in range(3))
        r = row_for("vit_attention", f"B={B} S={S} H={H} D={D}",
                    lambda: k_vit.attention_from_packed_qkv_nomax(qkv, H),
                    lambda: k_vit.vit_attention_reference(qkv.float(), H),
                    lambda: F.scaled_dot_product_attention(qv, kv_, vv),
                    nbytes=2 * B * S * 4 * E, flops=4 * B * H * S * S * D)
        results.setdefault("vit_attention", []).append(((B, S, H, D), n_calls, r))

    # prefill flash attention at the main path's shape and segment ids
    q_shape, k_shape, causal, qseg, kseg, q_off = shapes.calls["flash_attention"][0]
    B, Hq, Sq, D = q_shape
    Hkv, Sk = k_shape[1], k_shape[2]
    q, k, v = rnd(q_shape), rnd(k_shape), rnd(k_shape)
    seg_mask = qseg[:, :, None] == kseg[:, None, :]
    causal_mask = torch.ones((Sq, Sk), dtype=torch.bool, device=dev).tril(q_off)
    allowed = seg_mask & causal_mask
    pairs = int(allowed.sum().item())
    r = row_for("flash_attention", f"B={B} Hq={Hq} Hkv={Hkv} S={Sq} D={D} causal",
                lambda: k_attn.flash_attention(q, k, v, causal=True, q_segment_ids=qseg,
                                               kv_segment_ids=kseg),
                lambda: k_attn.attention_reference(q.float(), k.float(), v.float(), causal=True,
                                                   q_segment_ids=qseg, kv_segment_ids=kseg),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=allowed[:, None],
                                                       enable_gqa=True),
                nbytes=2 * (2 * q.numel() + 2 * k.numel()) + 4 * (qseg.numel() + kseg.numel()),
                flops=4 * pairs * Hq * D)
    results["flash_attention"] = [((B, Hq, Hkv, Sq, D), launches["flash_attention"], r)]
    del allowed, seg_mask, causal_mask
    torch.cuda.empty_cache()

    # decode over the whole stacked cache at the main path's last step
    q_shape, c_shape, _layer, valid_d = shapes.calls["flash_decode"][-1]
    L, B, Hkv, S, D = c_shape
    Hq = q_shape[1]
    qd, ckd, cvd = rnd(q_shape), rnd(c_shape), rnd(c_shape)
    valid = valid_d.clone()
    n_valid = int((valid > 0).sum().item())
    lay = L - 1
    r = row_for("flash_decode", f"B={B} Hq={Hq} Hkv={Hkv} S={S} D={D} L={L}",
                lambda: k_dec.flash_decode(qd, ckd, cvd, lay, valid),
                lambda: k_dec.flash_decode_reference(qd.float(), ckd.float(), cvd.float(), lay, valid),
                lambda: F.scaled_dot_product_attention(qd, ckd[lay], cvd[lay],
                                                       attn_mask=(valid > 0)[:, None, None, :],
                                                       enable_gqa=True),
                nbytes=2 * (2 * n_valid * Hkv * D + 2 * qd.numel()) + 4 * valid.numel(),
                flops=4 * n_valid * Hq * D)
    results["flash_decode"] = [((B, Hq, Hkv, S, D), launches["flash_decode"], r)]

    line = []
    for name, entries in results.items():
        for shape, n_launch, (err, ms, plain_ms, lib_ms, b_ms, b_by) in entries:
            line.append({
                "name": name if len(entries) == 1 else f"{name}[{'x'.join(map(str, shape))}]",
                "route": "cuda", "source": sources[name], "replaces": replaces[name],
                "launches": n_launch, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            })
    print(smi, flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": gpu_name,
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
