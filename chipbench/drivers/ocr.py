"""Driver of the page cells: full pages through the port's batch route
(``CalliReaderEngine``: the phased box stage, ``batch_build_rows``,
``batch_prepare`` with every decode chunk enqueued, ``batch_decode``),
pipelined as the repository's bench schedules it: while batch n decodes,
the host builds batch n + 1 and runs the box stages of n + 1 to n + 3. A
closed loop with a full queue over a pool of pages drawn from the seed.

``pages_per_s``: pages whose text reached the host (tokens copied back and
detokenized by ``batch_decode``), over the window; the window opens at a
batch completion after the warm-up and closes at the first completion at
or after ``--seconds``, each read after ``torch.cuda.synchronize()``.
``--trace 1`` runs the same window, then ``trace_steps`` batches under
torch.profiler, and reads the per-layer metrics from the two.

``correct``: after the window (the program freed), the plain float32
reference (``reference/ocr.py``) takes one batch of the window, drawn from
the seed, and works out every page's reading order, prompt length and the
batch's bucket again: each is held exactly to the program's. For the page
with the longest prompt and others drawn from the seed it runs the whole
model over the prompt and the served tokens; the widest gap by which a
served token's logit lies below the reference's best is held to the
cell's limit.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, List

import numpy as np

from chipbench import traffic as traffic_mod
from chipbench.drivers import common
from chipbench import weights as W
from chipbench.reference.ocr import n_tiles


def build_engine(cfg: Dict, seed: int, device):
    """The served engine of the configuration, on weights drawn here: the
    bf16 LLM quantized, fused and padded by the program's own set-up
    (``quantize_llm_int8``, ``fuse_llm_int8``, ``pad_vocab``), the trained
    assets overlaid by the program's loader."""
    import torch

    from callireader_tpu_torch.models import internlm2
    from callireader_tpu_torch.runtime import quantize
    from callireader_tpu_torch.runtime import weights as port_weights
    from callireader_tpu_torch.runtime.engine import CalliReaderEngine
    from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer

    vcfg = common.port_config(cfg)
    if cfg["quant"] != "int8":
        raise ValueError(f"quant {cfg['quant']!r}: the page driver serves the int8 LLM")
    llm = quantize.fuse_llm_int8(quantize.quantize_llm_int8(W.draw_llm(cfg["llm"], seed, device)))
    llm, llm_cfg = internlm2.pad_vocab(llm, vcfg.llm, 128)
    if llm_cfg.vocab_size != cfg["llm"]["padded_vocab_size"]:
        raise RuntimeError(f"padded vocabulary {llm_cfg.vocab_size}")
    vcfg = dataclasses.replace(vcfg, llm=llm_cfg)
    v = cfg["vision"]
    params = {"llm": llm, "vision": W.draw_vit(v, seed, device),
              "projector": W.draw_projector(v["hidden_size"], cfg["llm"]["hidden_size"], seed, device),
              "align": W.draw_align(cfg["llm"]["vocab_size"], cfg["llm"]["hidden_size"], seed, device)}
    vcfg, loaded = port_weights.overlay_trained_assets(params, vcfg, dtype=torch.bfloat16, device=device,
                                                       names=cfg["assets"])
    if sorted(loaded) != sorted(cfg["assets"]):
        raise RuntimeError(f"assets loaded {loaded}, the configuration names {cfg['assets']}")
    return CalliReaderEngine(vcfg, params, InternLM2Tokenizer(str(W.ASSETS / "tokenizer.model")),
                             device=device, device_tile_pages=cfg["device_tile_pages"])


class Pipeline:
    """The bench schedule over the pool. Step k launches batch k, builds
    k + 1 while k decodes, runs the box stages of k + 1 (order readback),
    k + 2 (detector readback, columns, order dispatch) and k + 3 (detector
    dispatch), and ends when batch k's text is on the host."""

    def __init__(self, engine, pages: List[np.ndarray], spec: Dict):
        import torch

        self.torch, self.engine, self.pages, self.spec = torch, engine, pages, spec
        self.B, self.T = spec["batch"], spec["max_new_tokens"]
        self.n_pool = len(pages) // self.B
        self.records: Dict[int, Dict] = {}
        self.built: Dict[int, Dict] = {}
        self.host_build: List[float] = []
        self.waits: List[float] = []
        self.launch_s: List[float] = []

    def batch(self, k: int) -> List[np.ndarray]:
        j = k % self.n_pool
        return self.pages[j * self.B:(j + 1) * self.B]

    def _rf(self, name):
        return self.torch.profiler.record_function("chipbench." + name)

    def build(self, k: int, ordered):
        ordered = [[[float(x) for x in b[:4]] for b in o or []] for o in ordered]
        self.built[k] = {"ordered": ordered,
                         "chars": [sum(1 for b in o if int(b[2]) > int(b[0]) and int(b[3]) > int(b[1]))
                                   for o in ordered]}
        with self._rf("build_rows"):
            return self.engine.batch_build_rows(self.batch(k), [self.spec["question"]] * self.B,
                                                use_p=True, ordered_lists=ordered)

    def launch(self, k: int, rows):
        with self._rf("launch"):
            prepared = self.engine.batch_prepare([], [], prepared_rows=rows, max_new_tokens=self.T,
                                                 repetition_penalty=1.0)
        self.records[k] = {"prepared": prepared, "lengths": np.asarray(rows["mask"]).sum(1).tolist(),
                           "bucket": rows["bucket"], **self.built.pop(k)}

    def finish(self, k: int) -> float:
        """Batch k's tokens copied to the host and detokenized -> the
        completion time."""
        rec = self.records[k]
        with self._rf("wait"):
            prepared = rec.pop("prepared")
            tokens, lengths = prepared["tokens"].cpu(), prepared["lengths"].cpu()
            rec["texts"] = self.engine.batch_decode(dict(prepared, tokens=tokens, lengths=lengths))
            rec["tokens"], rec["served_lengths"] = tokens.numpy(), lengths.numpy()
            self.drain()
        return time.perf_counter()

    def sort_boxes(self, k: int):
        with self._rf("box_stage"):
            return self.engine.batch_sort_boxes(self.batch(k))

    def prime(self) -> float:
        """Batch 0 alone (the graphs of its shapes captured), then the
        pipeline filled -> the completion time of batch 0."""
        e = self.engine
        self.launch(0, self.build(0, self.sort_boxes(0)))
        t = self.finish(0)
        self.rows = self.build(1, self.sort_boxes(1))
        with self._rf("box_stage"):
            dets = e.detect_fetch(self.batch(2), e.detect_dispatch(self.batch(2)))
            self.odisp = e.order_dispatch(e.columns_stage(self.batch(2), dets))
            self.handle = e.detect_dispatch(self.batch(3))
        self.k = 1
        return t

    def step(self) -> float:
        """Launch batch k, build k + 1, finish k -> k's completion time."""
        e, k = self.engine, self.k
        t0 = time.perf_counter()
        with self._rf("box_stage"):
            ordered = e.order_fetch(self.odisp)
            dets = e.detect_fetch(self.batch(k + 2), self.handle)
        t1 = time.perf_counter()
        self.launch(k, self.rows)
        t2 = time.perf_counter()
        with self._rf("box_stage"):
            self.handle = e.detect_dispatch(self.batch(k + 3))
            self.odisp = e.order_dispatch(e.columns_stage(self.batch(k + 2), dets))
        self.rows = self.build(k + 1, ordered)
        t3 = time.perf_counter()
        done = self.finish(k)
        self.host_build.append((t1 - t0) + (t3 - t2))
        self.waits.append(done - t3)
        self.launch_s.append(t2 - t1)
        self.k = k + 1
        return done

    def run_until(self, seconds: float, last: float):
        """Steps until ``seconds`` have passed since ``last`` -> (the batches
        finished, the seconds from ``last`` to the last completion)."""
        first, t0 = self.k, last
        while last - t0 < seconds:
            last = self.step()
        return list(range(first, self.k)), last - t0

    def record(self, done: List[int], seconds: float, cfg: Dict) -> Dict:
        """What the metrics read of a stretch of batches."""
        return {"batches": [{"lengths": self.records[k]["lengths"], "bucket": self.records[k]["bucket"],
                             "chars": self.records[k]["chars"],
                             "tiles": [n_tiles(cfg, p) for p in self.batch(k)]} for k in done],
                "steps": self.T, "rows": self.B, "window_s": seconds,
                "host_build_s": self.host_build[-len(done):]}

    def drain(self) -> None:
        if self.engine.device.type == "cuda":
            self.torch.cuda.synchronize()


def run(cfg: Dict, spec: Dict, seed: int, seconds: float, trace: bool, clock, device="cuda") -> Dict:
    """One run of a page cell -> its record (run.py prints it). ``device``
    other than the card is for the benchmark's CPU tests, at a small size."""
    import torch

    from callireader_tpu_torch.kernels import _build
    from callireader_tpu_torch.runtime import generate as gen

    from chipbench.trace import Context, Trace

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        common.build_kernels()
    stamp = {"start": time.time() - clock.process_start}
    engine = build_engine(cfg, seed, dev)
    stamp["engine"] = time.time() - clock.process_start
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    pages, drawn = traffic_mod.page_pool(spec, seed)
    pipe = Pipeline(engine, pages, spec)
    stamp["pages"] = time.time() - clock.process_start
    with torch.inference_mode():
        last = pipe.prime()
        stamp["prime"] = time.time() - clock.process_start
        for _ in range(spec["warm_steps"]):
            last = pipe.step()
        warm = pipe.k
        setup_s = time.time() - clock.process_start
        stamp["warm"] = setup_s
        common.log(f"set-up (s since start): {stamp}")
        done, window_s = pipe.run_until(seconds, last)
        pipe.drain()
        n = len(done)
        common.log(f"window {window_s:.3f} s, {n} batches; a step's host s: box stages + build "
                   f"{[round(x, 3) for x in pipe.host_build[-n:]]}, launch {[round(x, 3) for x in pipe.launch_s[-n:]]}, "
                   f"wait {[round(x, 3) for x in pipe.waits[-n:]]}")
        work = {"window": pipe.record(done, window_s, cfg)}
        out: Dict = {"setup_s": setup_s}
        if trace:
            from torch.profiler import ProfilerActivity, profile

            counts0 = {c.name: c.launches for c in _build.COUNTS}
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
            with profile(activities=acts) as prof:
                pipe.drain()
                t0, first = time.perf_counter(), pipe.k
                for _ in range(spec["trace_steps"]):
                    last = pipe.step()
            traced, traced_s = list(range(first, pipe.k)), last - t0
            launches = {c.name: c.launches - counts0[c.name] for c in _build.COUNTS}
            tr = Trace.from_profiler(prof, traced_s)
            del prof
            work["traced"] = pipe.record(traced, traced_s, cfg)
            common.log(f"traced {traced_s:.3f} s, {len(traced)} batches ({traced_s / len(traced):.3f} s a batch "
                       f"against {window_s / n:.3f} untraced); device busy {tr.busy_s:.3f} s")
            out.update(context=Context(tr, launches, work, cfg), busy_s=tr.busy_s, traced_s=traced_s,
                       breakdown={"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()})
        else:
            out["context"] = Context(None, {}, work, cfg)
        new_buckets = {pipe.records[k]["bucket"] for k in range(warm, pipe.k)} - {
            pipe.records[k]["bucket"] for k in range(warm)}
        if new_buckets:
            raise RuntimeError(f"the window reached prompt buckets {sorted(new_buckets)} the warm-up did not")
        memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    attempted = n * pipe.B
    failed = int(sum(int((pipe.records[k]["served_lengths"] < 1).sum()) for k in done))
    out.update(pages_per_s=attempted / window_s, attempted=attempted, failed=failed,
               memory_peak_bytes=memory_peak)
    # the sample the reference judges: one batch of the window, drawn from the seed
    pick = done[traffic_mod.rng(seed, 7).integers(n)]
    rec = pipe.records[pick]
    out["sample"] = {"k": pick, "tokens": rec["tokens"], "lengths": rec["served_lengths"],
                     "ordered": rec["ordered"], "prompt_lengths": rec["lengths"], "bucket": rec["bucket"],
                     "pages": pipe.batch(pick),
                     "drawn": [drawn[(pick % pipe.n_pool) * pipe.B + j] for j in range(pipe.B)]}
    del pipe, engine, rec
    gen.GRAPHS.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["checks"], out["notes"] = judge(cfg, spec, seed, out["sample"], dev)
    return out


def order_mismatch(program: List[List[float]], reference: List[List[float]]) -> int:
    """Reading positions at which the program's box is not the reference's
    (IoU under 0.5, so rounding of a coordinate never counts and a
    neighbouring glyph always does), and boxes one side has and the other
    lacks."""
    from chipbench.reference.boxes import calculate_iou

    wrong = sum(1 for a, b in zip(program, reference) if calculate_iou(a, b) < 0.5)
    return wrong + abs(len(program) - len(reference))


def _plan(ref, cfg: Dict, spec: Dict, seed: int, sample: Dict):
    """The reference's reading order, prompt ids and bucket of the sampled
    batch, and the requests compared (the longest prompt and others drawn
    from the seed)."""
    from chipbench.reference.ocr import bucket_length

    pages = sample["pages"]
    ordered = [ref.order(p, d) for p, d in zip(pages, ref.detect(pages))]
    n_chars = [sum(1 for b in o if int(b[2]) > int(b[0]) and int(b[3]) > int(b[1])) for o in ordered]
    ids = [ref.prompt_ids(n_tiles(cfg, p), 3 * n, spec["question"]) for p, n in zip(pages, n_chars)]
    longest = int(np.argmax([len(i) for i in ids]))
    others = [j for j in traffic_mod.rng(seed, 8).permutation(len(pages)).tolist() if j != longest]
    return ordered, n_chars, ids, bucket_length(max(len(i) for i in ids)), [longest] + others[:spec["check_requests"] - 1]


def judge(cfg: Dict, spec: Dict, seed: int, sample: Dict, device):
    """The reference's reading of the sampled batch -> ({name: value}, notes)."""
    import torch

    from chipbench.reference import models
    from chipbench.reference.ocr import PlainOCR, served_gaps

    with torch.no_grad(), models.exact():
        ref = PlainOCR(cfg, seed, device)
        ordered, n_chars, ids, bucket, chosen = _plan(ref, cfg, spec, seed, sample)
        pages, gaps = sample["pages"], []
        for j in chosen:
            served = sample["tokens"][j, :int(sample["lengths"][j])]
            lg = ref.logits(ids[j], ref.image_feats(pages[j]), ref.pseudo(pages[j], ordered[j]), bucket, served)
            gaps.append(float(served_gaps(lg, served).max()))
            del lg
    checks = {"order_mismatch": sum(order_mismatch(p, r) for p, r in zip(sample["ordered"], ordered)),
              "prompt_length_mismatch": sum(len(i) != n for i, n in zip(ids, sample["prompt_lengths"])),
              "bucket_mismatch": int(bucket != sample["bucket"]),
              "max_served_gap": max(gaps)}
    notes = {"detected_glyph_share": sum(n_chars) / sum(len(d) for d in sample["drawn"]),
             "compared_tokens": int(sum(int(sample["lengths"][j]) for j in chosen)), "gaps": gaps}
    return checks, notes


def control(cfg: Dict, spec: Dict, seed: int, sample: Dict, device, levels: int = 7) -> List[float]:
    """The control, for the benchmark's tests: the reference with its LLM's
    weights rounded to ``levels`` a channel in the program's place, read at
    the token it puts first at each served position -> the widest gap of
    each compared request against the float32 reference."""
    import torch

    from chipbench.reference import models
    from chipbench.reference.ocr import PlainOCR, served_gaps

    with torch.no_grad(), models.exact():
        ref = PlainOCR(cfg, seed, device)
        ordered, _, ids, bucket, chosen = _plan(ref, cfg, spec, seed, sample)
        pages, gaps = sample["pages"], []
        for j in chosen:
            served = sample["tokens"][j, :int(sample["lengths"][j])]
            img, pseudo = ref.image_feats(pages[j]), ref.pseudo(pages[j], ordered[j])
            lg = ref.logits(ids[j], img, pseudo, bucket, served)
            low = ref.logits(ids[j], img, pseudo, bucket, served, levels)
            gaps.append(float(served_gaps(lg, low.argmax(-1).cpu().numpy()).max()))
            del lg, low
    return gaps
