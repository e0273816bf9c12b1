"""Driver of the MLA-MoE page cell: the page cells' pipelined batch route
(``drivers/ocr.py``'s ``Pipeline``: the phased box stage,
``batch_build_rows``, ``batch_prepare`` with every decode chunk enqueued,
``batch_decode``) on CalliReader's front half in front of Moonlight-16B-A3B's
language model in bf16 (``configs/moonlight_16b_a3b_bf16.json``).

The engine is the port's ``moonlight-16b-a3b`` preset, built from weights
drawn here (``weights.py`` for the tile tower, its projector and the VQ
table; ``weights_moe.py`` for the LLM and the compact char tower at 2048),
with the committed detector and OrderFormer overlaid by the program's loader;
the program derives its served layout itself (fused expert gate / up, the
absorbed halves of W_kv_b). ``pages_per_s``, ``setup_s`` and ``--trace 1``
as the page driver has them; the trace's counters include the expert
layer's (``moe.rows``, ``moe.experts_touched``) and the device span
``prefill_experts``.

``correct``: after the window (the program freed), the plain float32
reference (``reference/moonlight.py``) takes one batch of the window, drawn
from the seed, and works out every page's reading order, prompt length and
the batch's bucket again (each held exactly), then runs the whole model over
the prompt and the served tokens of the longest prompt and others drawn from
the seed: the widest gap by which a served token's logit lies below the
reference's best, and the mean gap over every compared token, are held to
the cell's limits. The widest gap reads bf16's routing flips (an expert
chosen on a near tie, then the layers after it) at the worst of ~2k
positions; the mean reads how often and how far the served tokens leave the
reference's, which a fault of the expert layer moves at every position.
Neither tells bf16 from a lower precision of the routed experts, which the
flips swamp; ``expert_layer_error`` does: before the program is freed, it runs
every expert layer as served (``mla_moe.ffn``) over rows drawn from the seed
(``expert_probe``: program-prepared data), and the reference runs the same
layers on the same rows; the rows whose choice lies near a tie are left out,
so that bf16's rounding alone is left to read.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, Tuple

import numpy as np

from chipbench import traffic as traffic_mod
from chipbench import weights as W
from chipbench import weights_moe
from chipbench.drivers import common
from chipbench.drivers.ocr import Pipeline, _plan, order_mismatch

def port_config(cfg: Dict):
    """The port's VLMConfig of the configuration file (which is the truth);
    where the file names a preset of the port, every number must agree."""
    from callireader_tpu_torch.core import config as C

    def pick(cls, d):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})

    vcfg = C.VLMConfig(
        vision=pick(C.VisionConfig, cfg["vision"]), llm=pick(C.MLAMoEConfig, cfg),
        char_vision=pick(C.VisionConfig, cfg["char_tower"]["vision"]),
        resampler=pick(C.ResamplerConfig, cfg["char_tower"]["resampler"]),
        downsample_ratio=cfg["downsample_ratio"], force_image_size=cfg["force_image_size"],
        max_dynamic_patch=cfg["max_dynamic_patch"], use_thumbnail=cfg["use_thumbnail"])
    if vcfg.num_image_token != cfg["num_image_token"]:
        raise RuntimeError(f"{vcfg.num_image_token} image tokens a tile, the file says {cfg['num_image_token']}")
    if "preset" in cfg and C.get_config(cfg["preset"]) != vcfg:
        raise RuntimeError(f"the port's preset {cfg['preset']} differs from the configuration file")
    return vcfg


def build_engine(cfg: Dict, seed: int, device):
    """The served engine of the configuration on weights drawn here."""
    import torch

    from callireader_tpu_torch.runtime import weights as port_weights
    from callireader_tpu_torch.runtime.engine import CalliReaderEngine
    from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer

    vcfg = port_config(cfg)
    v, E, V = cfg["vision"], cfg["hidden_size"], cfg["vocab_size"]
    params = {"llm": weights_moe.draw_llm(cfg, seed, device), "vision": W.draw_vit(v, seed, device),
              "projector": W.draw_projector(v["hidden_size"], E, seed, device),
              "align": W.draw_align(V, E, seed, device), **weights_moe.draw_char_tower(cfg, seed, device)}
    vcfg, loaded = port_weights.overlay_trained_assets(params, vcfg, dtype=torch.bfloat16, device=device,
                                                       names=cfg["assets"])
    if sorted(loaded) != sorted(cfg["assets"]):
        raise RuntimeError(f"assets loaded {loaded}, the configuration names {cfg['assets']}")
    return CalliReaderEngine(vcfg, params, InternLM2Tokenizer(str(W.ASSETS / "tokenizer.model")),
                             device=device, device_tile_pages=cfg["device_tile_pages"])


def run(cfg: Dict, spec: Dict, seed: int, seconds: float, trace: bool, clock, device="cuda") -> Dict:
    """One run of the cell -> its record (run.py prints it)."""
    import torch

    # a program without the MLA-MoE LLM fails here, before anything is built
    from callireader_tpu_torch.models import mla_moe  # noqa: F401
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
        captures0 = _count(_build, "graph_captures")
        done, window_s = pipe.run_until(seconds, last)
        pipe.drain()
        n = len(done)
        common.log(f"window {window_s:.3f} s, {n} batches, {_count(_build, 'graph_captures') - captures0} "
                   f"graph captures in it; a step's host s: box stages + build "
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
                       f"against {window_s / n:.3f} untraced); device busy {tr.busy_s:.3f} s; counters "
                       f"{ {k: launches[k] for k in ('moe.rows', 'moe.experts_touched', 'graph_captures')} }")
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
    pick = done[traffic_mod.rng(seed, 7).integers(n)]
    out["sample"] = sample_of(pipe, pick, drawn)
    out["sample"]["probe"] = expert_probe(engine, seed)
    del pipe, engine
    gen.GRAPHS.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["checks"], out["notes"] = judge(cfg, spec, seed, out["sample"], dev)
    return out


PROBE_ROWS = {"decode": 8, "prefill": 512}  # rows a probe block: a decode step's, a prefill block's


def expert_probe(engine, seed: int) -> Dict:
    """Program-prepared data for ``expert_layer_error``: each expert layer of
    the engine as it serves (``mla_moe.ffn``: the RMSNorm, routing, grouped
    expert kernel, shared experts and residual) over rows x ~ N(0, 1/64) in
    bf16 drawn from the seed, a block of 8 as the decode runs them, then one
    of 512 as the prefill does -> {"x", "y"}: (expert layers, 520, E) on the
    host. The RMSNorm undoes x's scale; at an eighth of a unit x lies below
    the block's output, so that the residual's rounding stays under the
    experts'."""
    import torch

    from callireader_tpu_torch.models import mla_moe

    cfg, params = engine.cfg.llm, engine.params["llm"]
    dev, Ld = params["norm"].device, cfg.first_k_dense_replace
    shape = (cfg.num_hidden_layers - Ld, sum(PROBE_ROWS.values()), cfg.hidden_size)
    x = torch.from_numpy(traffic_mod.rng(seed, 11).standard_normal(shape, dtype=np.float32) / 8).to(torch.bfloat16)
    y = torch.empty_like(x)
    with torch.inference_mode():
        for j in range(shape[0]):
            at = 0
            for mode, rows in PROBE_ROWS.items():
                y[j, at:at + rows] = mla_moe.ffn(params, cfg, Ld + j, x[j, at:at + rows].to(dev), engine.policy,
                                                 decode=mode == "decode").cpu()
                at += rows
    return {"x": x, "y": y}


def expert_layer_error(tree: Dict, cfg: Dict, probe: Dict, device) -> Tuple[float, float]:
    """The served expert layers against the reference's on the probe's rows:
    in each layer and block, |y - y_ref| / |y_ref - x| (Frobenius) over the
    rows whose reference choice lies NEAR_TIE or more from a tie (there the
    program's router, which sees the normed rows rounded to bf16, chooses as
    the reference does) -> (the largest, the share of rows left out)."""
    from chipbench.reference import moonlight as plain

    worst, left = 0.0, 0
    for j in range(probe["x"].shape[0]):
        x = probe["x"][j].to(device).float()
        ref, clear = plain.expert_layer(tree, cfg, j, x)
        y, at = probe["y"][j].to(device).float(), 0
        for rows in PROBE_ROWS.values():
            c = clear[at:at + rows]
            if c.any():
                part = slice(at, at + rows)
                d = (y[part] - ref[part])[c].norm() / (ref[part] - x[part])[c].norm()
                worst = max(worst, float(d))
            at += rows
        left += int((~clear).sum())
    return worst, left / (probe["x"].shape[0] * probe["x"].shape[1])


def _count(build, name: str) -> int:
    return next(c.launches for c in build.COUNTS if c.name == name)


def sample_of(pipe: Pipeline, k: int, drawn) -> Dict:
    """What the reference judges of batch ``k``."""
    rec = pipe.records[k]
    return {"k": k, "tokens": rec["tokens"], "lengths": rec["served_lengths"], "ordered": rec["ordered"],
            "prompt_lengths": rec["lengths"], "bucket": rec["bucket"], "pages": pipe.batch(k),
            "drawn": [drawn[(k % pipe.n_pool) * pipe.B + j] for j in range(pipe.B)]}


def judge(cfg: Dict, spec: Dict, seed: int, sample: Dict, device):
    """The reference's reading of the sampled batch and of the expert probe
    (``sample["probe"]``) -> ({name: value}, notes); the notes count the
    reference's near routing ties (reference/moonlight.py)."""
    import torch

    from chipbench.reference import models
    from chipbench.reference.moonlight import PlainMoonlight
    from chipbench.reference.ocr import served_gaps

    with torch.no_grad(), models.exact():
        ref = PlainMoonlight(cfg, seed, device)
        ordered, n_chars, ids, bucket, chosen = _plan(ref, cfg, spec, seed, sample)
        pages, gaps, sums, routing = sample["pages"], [], [], {}
        for j in chosen:
            served = sample["tokens"][j, :int(sample["lengths"][j])]
            img, pseudo = ref.image_feats(pages[j]), ref.pseudo(pages[j], ordered[j])
            lg = ref.logits(ids[j], img, pseudo, bucket, served, stats=routing)
            g = served_gaps(lg, served)
            gaps.append(float(g.max()))
            sums.append(float(g.sum()))
            del lg, g
        layer_error, probe_left = expert_layer_error(ref.llm, cfg, sample["probe"], device)
    checks = {"order_mismatch": sum(order_mismatch(p, r) for p, r in zip(sample["ordered"], ordered)),
              "prompt_length_mismatch": sum(len(i) != n for i, n in zip(ids, sample["prompt_lengths"])),
              "bucket_mismatch": int(bucket != sample["bucket"]),
              "max_served_gap": max(gaps)}
    compared = int(sum(int(sample["lengths"][j]) for j in chosen))
    checks["mean_served_gap"] = sum(sums) / compared
    checks["expert_layer_error"] = layer_error
    notes = {"detected_glyph_share": sum(n_chars) / sum(len(d) for d in sample["drawn"]),
             "compared_tokens": compared, "gaps": gaps, "routing": routing, "probe_rows_left_out": probe_left}
    return checks, notes

