"""Driver of the e-IT cell: micro-steps of ``train/e_it.make_train_step`` on
the recipe (LoRA on the LLM's seven projections, the projector trainable,
the towers frozen, AdamW inside an accumulation of micro-batches, remat),
over micro-batches drawn from the seed.

Set-up builds the one training state, drives it through the first
``checked_steps`` micro-steps of the pool (rows that all differ) and keeps
its readings: each step's loss, the first gradient as the optimizer holds it
after one step, and each trainable leaf's change after the last of them.
Then it warms up and hands the same state to the window.

``train_tokens_per_s``: the non-pad tokens of the micro-steps finished in
the window, over the window; the window opens at a micro-step boundary and
closes at the first boundary at or after ``--seconds``, read after
``torch.cuda.synchronize()``. ``--trace 1`` runs the same window, then
``trace_steps`` micro-steps under torch.profiler, and reads the per-layer
metrics from the two.

``correct``: after the window (the program freed), the plain float32
reference (``reference/train.py``) follows the same micro-steps from the
same weights, and three numbers are held to their limits: the worst step's
loss gap, the worst leaf's gap of the first gradient's norm, and the worst
leaf's gap of the change's norm (leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the change: they move by
round-off alone).
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from chipbench import traffic as traffic_mod
from chipbench import weights as W
from chipbench.drivers import common
from chipbench.reference import train as ref_train
from chipbench.reference.ocr import ALIGNED, SYSTEM
from chipbench.reference.tokenizer import InternLM2Tokenizer


def prompt_builder(cfg: Dict, question: str):
    tok = InternLM2Tokenizer(str(W.ASSETS / "tokenizer.model"))

    def prompt_ids(n_images: int, n_pseudo: int) -> List[int]:
        img = "<img>" + "<IMG_CONTEXT>" * (cfg["num_image_token"] * n_images) + "</img>"
        q = img + "\n" + question + ALIGNED * n_pseudo
        return tok.encode(f"<|im_start|>system\n{SYSTEM}<|im_end|><|im_start|>user\n{q}<|im_end|>"
                          "<|im_start|>assistant\n", add_bos=True)

    return prompt_ids


def micro_batches(cfg: Dict, spec: Dict, seed: int, device, pad_id: int = 2) -> List[Dict]:
    """The pool of micro-batches on the device: right-padded ids, labels,
    segment ids and positions, the tiles (each sample's tiles and its
    thumbnail, uint8 drawn from the seed) and the pseudo embeddings."""
    import torch

    rows = traffic_mod.eit_rows(spec, seed, prompt_builder(cfg, spec["question"]))
    S_img, E = cfg["force_image_size"], cfg["llm"]["hidden_size"]
    g = W.generator(seed, "inputs", device)
    out = []
    for mb in rows:
        S = max(len(ids) for ids, _, _, _ in mb)
        B = len(mb)
        ids = np.full((B, S), pad_id, np.int64)
        labels = np.full((B, S), ref_train.IGNORE, np.int64)
        seg = np.full((B, S), -1, np.int64)
        pos = np.zeros((B, S), np.int64)
        for i, (x, y, _, _) in enumerate(mb):
            ids[i, :len(x)], labels[i, :len(x)], seg[i, :len(x)] = x, y, 0
            pos[i, :len(x)] = np.arange(len(x))
        n_img = sum(t + 1 for _, _, t, _ in mb)
        n_pseudo = sum(3 * c for _, _, _, c in mb)
        pix = torch.randint(0, 256, (n_img, S_img, S_img, 3), generator=g, device=device, dtype=torch.uint8)
        pseudo = torch.empty((n_pseudo, E), dtype=torch.bfloat16, device=device).normal_(
            0.0, spec["pseudo_std"], generator=g)
        t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
        out.append({"input_ids": t(ids), "labels": t(labels), "segment_ids": t(seg), "positions": t(pos),
                    "pixel_values": pix, "pseudo_embeds": pseudo,
                    "lengths": [len(x) for x, _, _, _ in mb], "tiles": n_img, "chars": n_pseudo // 3})
    return out


FEED = ("input_ids", "labels", "segment_ids", "positions", "pixel_values", "pseudo_embeds")


def feed(mb: Dict, cfg: Dict) -> Dict:
    """The step's batch."""
    return {k: mb[k] for k in FEED}


def build_state(cfg: Dict, seed: int, device):
    """The training state of the recipe on weights drawn here."""
    import torch

    from callireader_tpu_torch.train import e_it

    vcfg = common.port_config(cfg)
    rc = cfg["recipe"]
    llm = W.draw_llm(cfg["llm"], seed, device)
    llm["layers"].update(ref_train.draw_lora(cfg["llm"], rc["lora_rank"], seed, device))
    llm["layers"]["lora_scale"] = torch.full((cfg["llm"]["num_hidden_layers"],),
                                             rc["lora_alpha"] / rc["lora_rank"], device=device)
    params = {"llm": llm, "vision": W.draw_vit(cfg["vision"], seed, device),
              "projector": W.draw_projector(cfg["vision"]["hidden_size"], cfg["llm"]["hidden_size"], seed,
                                            device)}
    tc = e_it.TrainConfig(learning_rate=rc["learning_rate"], weight_decay=rc["weight_decay"],
                          betas=tuple(rc["betas"]), warmup_ratio=rc["warmup_ratio"],
                          total_steps=rc["total_steps"], grad_clip=rc["grad_clip"], lora_rank=rc["lora_rank"],
                          lora_alpha=rc["lora_alpha"], train_mlp1=True, remat=rc["remat"],
                          grad_accum=rc["grad_accum"])
    state, frozen, tx = e_it.create_train_state(params, tc)
    return state, frozen, e_it.make_train_step(vcfg, tc, tx), e_it.flatten


def run(cfg: Dict, spec: Dict, seed: int, seconds: float, trace: bool, clock, device="cuda") -> Dict:
    """One run of the e-IT cell -> its record. ``device`` other than the
    card is for the benchmark's CPU tests, at a small size."""
    import torch

    from callireader_tpu_torch.kernels import _build

    from chipbench.trace import Context, Trace

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        common.build_kernels()
    stamp = {"start": time.time() - clock.process_start}
    state, frozen, step, flatten = build_state(cfg, seed, dev)
    pool = micro_batches(cfg, spec, seed, dev)
    stamp["state"] = time.time() - clock.process_start
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    k = 0

    def one():
        nonlocal state, k
        with torch.profiler.record_function("chipbench.micro_step"):
            state, m = step(state, frozen, feed(pool[k % len(pool)], cfg))
        k += 1
        return m

    def stretch(seconds: float, count: int = 0):
        """Micro-steps until ``seconds`` have passed (or ``count`` of them)
        -> (the micro-batches done, the seconds)."""
        sync()
        first, t0 = k, time.perf_counter()
        last = t0
        while (last - t0 < seconds) if not count else (k - first < count):
            one()
            sync()
            last = time.perf_counter()
        return [pool[i % len(pool)] for i in range(first, k)], last - t0

    def record(done: List[Dict], seconds: float) -> Dict:
        return {"steps": [{"lengths": mb["lengths"], "tiles": mb["tiles"], "chars": mb["chars"]} for mb in done],
                "window_s": seconds, "rank": cfg["recipe"]["lora_rank"]}

    # the checked micro-steps: the readings the reference follows
    n_check = spec["checked_steps"]
    start = {n: v.detach().clone() for n, v in flatten(state.trainable).items()}
    losses, first = [], {}
    for i in range(n_check):
        losses.append(float(one()["loss"]))
        if i == 0:
            first = {n: float(v.float().norm()) for n, v in state.opt_state["acc_grads"].items()}
    change = {n: float((v.detach().float() - start[n].float()).norm()) for n, v in flatten(state.trainable).items()}
    del start
    for _ in range(spec["warm_steps"]):
        one()
    sync()
    setup_s = time.time() - clock.process_start
    stamp["warm"] = setup_s
    common.log(f"set-up (s since start): {stamp}")
    done, window_s = stretch(seconds)
    tokens = sum(ref_train.token_count(mb) for mb in done)
    common.log(f"window {window_s:.3f} s, {len(done)} micro-steps, {tokens} tokens; checked losses {losses}")
    work = {"window": record(done, window_s)}
    out: Dict = {"setup_s": setup_s, "train_tokens_per_s": tokens / window_s, "attempted": len(done), "failed": 0}
    if trace:
        from torch.profiler import ProfilerActivity, profile

        counts0 = {c.name: c.launches for c in _build.COUNTS}
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            traced, traced_s = stretch(0.0, spec["trace_steps"])
        launches = {c.name: c.launches - counts0[c.name] for c in _build.COUNTS}
        tr = Trace.from_profiler(prof, traced_s)
        del prof
        work["traced"] = record(traced, traced_s)
        common.log(f"traced {traced_s:.3f} s, {len(traced)} micro-steps; device busy {tr.busy_s:.3f} s")
        out.update(context=Context(tr, launches, work, cfg), busy_s=tr.busy_s, traced_s=traced_s,
                   breakdown={"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()})
    else:
        out["context"] = Context(None, {}, work, cfg)
    out["memory_peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    checked = pool[:n_check]
    del state, frozen, step, pool, done
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    out["checks"], out["notes"] = judge(cfg, seed, checked, (losses, first, change), dev)
    return out


def reference_readings(cfg: Dict, seed: int, checked: List[Dict], device, fp8_products: bool = False):
    """The plain reference over the checked micro-steps -> (each loss, each
    leaf's first-gradient norm, each leaf's change norm, each leaf's largest
    gradient norm)."""
    ref = ref_train.PlainEIT(cfg, seed, device, fp8_products=fp8_products)
    start = {n: v.clone() for n, v in ref.params.items()}
    losses, first, grad_max = [], {}, {}
    for i, mb in enumerate(checked):
        loss, grads = ref.step(mb)
        losses.append(loss)
        norms = {n: float(g.norm()) for n, g in grads.items()}
        if i == 0:
            first = norms
        grad_max = {n: max(grad_max.get(n, 0.0), v) for n, v in norms.items()}
    change = {n: float((ref.params[n] - start[n]).norm()) for n in ref.params}
    return losses, first, change, grad_max


def compare(readings, reference):
    """Readings (losses, first-gradient norms, change norms) against the
    reference's -> ({name: value}, the leaves held in the change)."""
    losses, first, change = readings[:3]
    r_losses, r_first, r_change, grad_max = reference
    med = sorted(grad_max.values())[len(grad_max) // 2]
    moved = [n for n, v in grad_max.items() if v >= 1e-3 * med]
    return {"loss_gap": ref_train.loss_gaps(losses, r_losses),
            "first_grad_gap": ref_train.leaf_gaps(first, r_first, list(r_first)),
            "change_gap": ref_train.leaf_gaps(change, r_change, moved)}, moved


def judge(cfg: Dict, seed: int, checked: List[Dict], readings, device):
    """The reference's reading of the checked micro-steps -> ({name: value}, notes)."""
    from chipbench.reference import models

    with models.exact():
        reference = reference_readings(cfg, seed, checked, device)
    checks, moved = compare(readings, reference)
    notes = {"losses": readings[0], "reference_losses": reference[0],
             "left_out_of_change": sorted(set(reference[2]) - set(moved))}
    return checks, notes


def control(cfg: Dict, spec: Dict, seed: int, device) -> Dict[str, float]:
    """The control, for the benchmark's tests: the reference with every LLM
    product's operands in fp8 e4m3 in the program's place, over the seed's
    checked micro-steps -> its numbers against the float32 reference."""
    from chipbench.reference import models

    checked = micro_batches(cfg, spec, seed, device)[:spec["checked_steps"]]
    with models.exact():
        reference = reference_readings(cfg, seed, checked, device)
        gc.collect()
        low = reference_readings(cfg, seed, checked, device, fp8_products=True)
    return compare(low, reference)[0]
