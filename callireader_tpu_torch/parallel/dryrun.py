"""A dry run of every parallel stage in a gloo world of CPU ranks: the port's
counterpart of ``dryrun_multichip`` in the repository's ``__graft_entry__.py``.

    python -c "from callireader_tpu_torch.parallel.dryrun import dryrun_multichip; dryrun_multichip(8)"

spawns n ranks (one process and one thread each, ``run_world``) and runs the
JAX dry run's stages, each held against the same computation unsharded in
the same process: the sharded LoRA e-IT step (the mesh factored as tensor
<= 2, fsdp <= 2, the rest data), Ulysses attention at sp=2, the expert-
parallel MoE grads (n >= 4), and at n >= 8 sharded generate, the contiguous
and paged batchers (with a prefix hit), the sharded ViT encode and the
data-sharded batch OCR. Rank 0 prints each stage; the caller prints
``[dryrun] PASS`` when every rank ended well.

``run_world(n, "module:function", *args)`` is the runner the CPU tests use
too: each rank joins the world through a file store, calls the function
with ``args`` and saves what it returns; a rank that fails ends the world.
"""

from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_world(n: int, fn: str, *args, timeout: float = 900.0,
              sys_path: Sequence[str] = ()) -> List[Any]:
    """``fn`` ("module:function") in a gloo world of ``n`` CPU ranks ->
    each rank's return value, in rank order. ``sys_path``: directories the
    ranks import ``fn``'s module from (beside the repository)."""
    import torch

    with tempfile.TemporaryDirectory(prefix="gloo_world_") as tmp:
        torch.save(args, os.path.join(tmp, "args.pt"))
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([REPO, *sys_path, os.environ.get("PYTHONPATH", "")]))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "callireader_tpu_torch.parallel.dryrun", "--rank", str(r),
             "--world", str(n), "--fn", fn, "--dir", tmp], env=env, cwd=REPO)
            for r in range(n)]
        deadline = time.time() + timeout
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.returncode not in (None, 0)]
                if bad or time.time() > deadline:
                    raise RuntimeError(f"{fn}: ranks {bad or 'all'} of {n} "
                                       f"{'failed' if bad else 'timed out'}")
                time.sleep(0.05)
            bad = [r for r, p in enumerate(procs) if p.returncode]
            if bad:
                raise RuntimeError(f"{fn}: ranks {bad} of {n} failed")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [torch.load(os.path.join(tmp, f"out{r}.pt"), weights_only=False) for r in range(n)]


def _rank_main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--fn", required=True)
    ap.add_argument("--dir", required=True)
    a = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    from callireader_tpu_torch.parallel import spmd

    torch.set_num_threads(1)
    spmd.init_distributed("cpu", init_method=f"file://{os.path.join(a.dir, 'store')}",
                          world_size=a.world, rank=a.rank)
    module, _, name = a.fn.partition(":")
    args = torch.load(os.path.join(a.dir, "args.pt"), weights_only=False)
    out = getattr(importlib.import_module(module), name)(*args)
    torch.save(out, os.path.join(a.dir, f"out{a.rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """Every stage in a gloo world of ``n_devices`` CPU ranks; prints
    ``[dryrun] PASS`` at the end, raises where a rank failed."""
    print(f"[dryrun] starting a gloo world of {n_devices} CPU ranks", flush=True)
    run_world(n_devices, "callireader_tpu_torch.parallel.dryrun:_dryrun_body", n_devices)
    print("[dryrun] PASS", flush=True)


def _say(msg: str) -> None:
    from callireader_tpu_torch.parallel import spmd

    if spmd.is_main():
        print(f"[dryrun] {msg}", flush=True)


def _factor(n: int):
    facs = {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1}
    rem = n
    for axis, cap in (("tensor", 2), ("fsdp", 2), ("data", 1 << 30)):
        take = 1
        while take * 2 <= cap and rem % 2 == 0:
            take *= 2
            rem //= 2
        facs[axis] = take
    if rem != 1:
        raise ValueError(f"n_devices={n} is not a power of two")
    return facs


def _dryrun_body(n: int) -> None:
    import numpy as np
    import torch

    from callireader_tpu_torch.core.config import get_config
    from callireader_tpu_torch.core.dtypes import FP32_POLICY
    from callireader_tpu_torch.parallel import spmd, ulysses
    from callireader_tpu_torch.runtime import weights
    from callireader_tpu_torch.train import e_it, lora

    cfg = get_config("callireader-tiny")
    cpu = torch.device("cpu")
    facs = _factor(n)
    mesh = spmd.make_mesh(facs, device="cpu")
    _say(f"mesh axes: {mesh.shape}")

    # ---- the sharded LoRA e-IT step against the unsharded one
    tc = e_it.TrainConfig(lora_rank=4, lora_alpha=8.0, total_steps=10, remat=True)
    B, S = max(2, facs["data"] * facs["fsdp"]), 256
    ids = np.full((B, S), 100, np.int64)
    ids[:, 4:4 + cfg.num_image_token] = cfg.img_context_token_id
    labels = np.where(np.arange(S)[None] > S // 2, ids, e_it.IGNORE_INDEX)
    batch = {"input_ids": torch.from_numpy(ids), "labels": torch.from_numpy(labels),
             "segment_ids": torch.zeros((B, S), dtype=torch.int32),
             "positions": torch.arange(S)[None].expand(B, S).contiguous(),
             "pixel_values": torch.zeros((B, cfg.force_image_size, cfg.force_image_size, 3))}
    losses = []
    for m in (None, mesh):
        params = weights.init_params(cfg, 0, dtype=torch.float32, device=cpu)
        params["llm"] = lora.add_lora(params["llm"], cfg.llm, torch.Generator().manual_seed(1),
                                      rank=tc.lora_rank, alpha=tc.lora_alpha)
        axes = spmd.engine_logical_axes(cfg, params) if m is not None else None
        state, frozen, tx = e_it.create_train_state(params, tc, m, axes)
        step = e_it.make_train_step(cfg, tc, tx, policy=FP32_POLICY, mesh=m)
        state, metrics = step(state, frozen, batch)
        losses.append(float(metrics["loss"]))
    if not (np.isfinite(losses[1]) and abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])):
        raise AssertionError(f"sharded e-IT loss {losses[1]} against the unsharded {losses[0]}")
    _say(f"train step OK on {n} ranks, loss={losses[1]:.6f} (unsharded {losses[0]:.6f})")

    # ---- Ulysses over a dedicated seq axis
    if n >= 2:
        from callireader_tpu_torch.kernels.attention import attention_reference

        smesh = spmd.make_mesh({"data": n // 2, "seq": 2}, device="cpu")
        g = torch.Generator().manual_seed(2)
        q = torch.randn((2, 4, 64, 16), generator=g)
        k = torch.randn((2, 2, 64, 16), generator=g)
        v = torch.randn((2, 2, 64, 16), generator=g)
        part = [ulysses.split_for_sequence_parallel(t, smesh, dim=2) for t in (q, k, v)]
        out = spmd.all_gather(ulysses.ulysses_attention(*part, smesh, causal=True), smesh, "seq", 2)
        err = float((out - attention_reference(q, k, v, causal=True)).abs().max())
        if err > 1e-5:
            raise AssertionError(f"Ulysses max err {err}")
        _say(f"ulysses SP attention OK (sp=2), max err {err:.2e}")

    if n >= 8:
        _inference_stages(cfg, n)

    # ---- expert parallelism: MoE grads over an expert axis
    if n >= 4:
        from callireader_tpu_torch.core import partition
        from callireader_tpu_torch.models import moe

        mcfg = moe.moe_tiny()
        emesh = spmd.make_mesh({"data": n // 4, "expert": 4}, device="cpu")
        whole = moe.init_params(mcfg, torch.Generator().manual_seed(3), torch.float32, cpu)
        local = spmd.shard_tree(whole, moe.logical_axes(mcfg), emesh)
        mids = torch.from_numpy(np.random.RandomState(0).randint(
            0, mcfg.llm.vocab_size, (2 * (n // 4), 16)))
        _, g_ref = moe.loss_and_grads(whole, mcfg, mids, policy=FP32_POLICY)
        loss, g = moe.loss_and_grads(local, mcfg, mids, policy=FP32_POLICY, mesh=emesh)
        specs = spmd.flat_specs(whole, moe.logical_axes(mcfg), emesh)
        err = max(float((g[k] - partition.local_shard(g_ref[k], specs[k], emesh)).abs().max())
                  for k in g)
        if not (np.isfinite(float(loss)) and err <= 1e-5):
            raise AssertionError(f"MoE expert-parallel grads off by {err}")
        _say(f"MoE expert-parallel grad OK (ep=4), max err {err:.2e} against the unsharded grads")


def _inference_stages(cfg, n: int) -> None:
    import numpy as np
    import torch

    from callireader_tpu_torch.core.dtypes import FP32_POLICY
    from callireader_tpu_torch.models import internlm2, internvit, projector
    from callireader_tpu_torch.parallel import spmd
    from callireader_tpu_torch.runtime import generate as gen
    from callireader_tpu_torch.runtime import weights
    from callireader_tpu_torch.runtime.engine import CalliReaderEngine
    from callireader_tpu_torch.runtime.paged_cache import PagedBatcher
    from callireader_tpu_torch.runtime.serving import ContinuousBatcher, Request
    from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer

    cpu = torch.device("cpu")
    imesh = spmd.make_mesh({"data": 2, "fsdp": 2, "tensor": 2, "seq": 1}, device="cpu")
    full = weights.init_params(cfg, 5, dtype=torch.float32, device=cpu)
    llm_p = full["llm"]
    llm_sh = spmd.shard_tree(llm_p, spmd.llm_logical_axes(cfg.llm, llm_p), imesh)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(10, 900, (2, 16)))
    e = internlm2.embed_tokens(llm_p, ids, torch.float32)
    gc = gen.GenerateConfig(max_new_tokens=6, eos_token_ids=(-1,))
    mask = torch.ones((2, 16), dtype=torch.int32)
    t_ref, _ = gen.generate_from_embeds(llm_p, cfg.llm, e, mask, gen_cfg=gc, max_cache_len=64,
                                        policy=FP32_POLICY)
    t_sh, _ = gen.generate_from_embeds(llm_sh, cfg.llm, e, mask, gen_cfg=gc, max_cache_len=64,
                                       policy=FP32_POLICY, mesh=imesh)
    if not torch.equal(t_ref, t_sh):
        raise AssertionError("sharded generate gave other tokens")
    rows = [internlm2.embed_tokens(llm_p, torch.from_numpy(rng.randint(10, 900, (1, 5))),
                                   torch.float32)[0].numpy() for _ in range(3)]

    def served(batcher):
        for uid, row in enumerate(rows):
            batcher.submit(Request(uid=uid, embeds=row, max_new_tokens=4, eos_token_ids=(-1,)))
        return {r.uid: r.tokens for r in batcher.run()}

    base = served(ContinuousBatcher(llm_p, cfg.llm, num_slots=2, max_len=256, policy=FP32_POLICY))
    b = ContinuousBatcher(llm_sh, cfg.llm, num_slots=2, max_len=256, policy=FP32_POLICY, mesh=imesh)
    if served(b) != base:
        raise AssertionError("the sharded batcher gave other tokens")
    _say(f"sharded inference OK: generate token-parity on {imesh.shape}, batcher kv-shard "
         f"{b.cache_k.shape[2]}/{cfg.llm.num_key_value_heads} heads/rank")

    rng3 = np.random.RandomState(4)
    prefix_ids = [1] + list(rng3.randint(2, 900, 19))
    prompts = [prefix_ids + list(rng3.randint(2, 900, k)) for k in (3, 6)] + [[1, 9, 2, 7]]

    def emb(p_ids):
        return internlm2.embed_tokens(llm_p, torch.tensor([p_ids]), torch.float32)[0].numpy()

    def run_paged(p, m, register):
        pb = PagedBatcher(p, cfg.llm, num_slots=3, num_pages=16, page_size=64, max_pages_per_slot=4,
                          policy=FP32_POLICY, cache_dtype=torch.float32, mesh=m)
        if register and pb.register_prefix(emb(prefix_ids), quantum=4) != 20:
            raise AssertionError("the prefix did not register")
        for uid, p_ids in enumerate(prompts):
            pb.submit(Request(uid=uid, embeds=emb(p_ids), max_new_tokens=4, eos_token_ids=(-1,)))
        return {r.uid: r.tokens for r in pb.run()}, pb.prefix_hits

    base_toks, _ = run_paged(llm_p, None, False)
    shard_toks, hits = run_paged(llm_sh, imesh, True)
    if hits != 2 or shard_toks != base_toks:
        raise AssertionError(f"paged serving: {hits} hits, tokens {shard_toks} against {base_toks}")
    _say(f"paged serving OK on {imesh.shape}: prefix-cache hits {hits}, token parity with the "
         f"unsharded unregistered run")

    vit_axes = internvit.logical_axes(cfg.vision)
    vit_sh = spmd.shard_tree(full["vision"], vit_axes, imesh)
    tiles = torch.randn((2, cfg.force_image_size, cfg.force_image_size, 3),
                        generator=torch.Generator().manual_seed(9))
    ref = projector.extract_feature(full["projector"], internvit.forward(
        full["vision"], cfg.vision, tiles, policy=FP32_POLICY), cfg, policy=FP32_POLICY)
    vit_whole = spmd.gather_tree(vit_sh, spmd.tree_specs(full["vision"], vit_axes, imesh), imesh)
    got = projector.extract_feature(full["projector"], internvit.forward(
        vit_whole, cfg.vision, tiles, policy=FP32_POLICY), cfg, policy=FP32_POLICY)
    verr = float((got - ref).abs().max())
    if verr > 1e-3:
        raise AssertionError(f"sharded ViT encode off by {verr}")
    _say(f"sharded ViT encode OK on {imesh.shape} (the blocks gathered per encode), "
         f"max err {verr:.2e}")

    emesh = spmd.make_mesh({"data": 4, "fsdp": 2}, device="cpu")
    tok = InternLM2Tokenizer()
    pages = [np.random.RandomState(3 + i).randint(100, 255, (80, 60, 3)).astype(np.uint8)
             for i in range(6)]
    boxes = [[[8.0, 8.0, 24.0, 24.0], [33.0, 18.0, 49.0, 34.0]]] * 6
    outs = []
    for m in (None, emesh):
        eng = CalliReaderEngine(cfg, weights.init_params(cfg, 7, dtype=torch.float32, device=cpu),
                                tok, device="cpu", policy=FP32_POLICY, mesh=m)
        outs.append(eng.batch_chat_ocr(pages, ["读出图中所有文字。"] * 6, max_new_tokens=4,
                                       ordered_lists=boxes))
    if outs[0] != outs[1]:
        raise AssertionError("data-sharded eval gave other responses")
    _say("data-sharded eval OK: 6 rows padded to 8 over data=4, 2 rows a data rank, responses "
         "equal to the unsharded engine's")


if __name__ == "__main__":
    _rank_main()
