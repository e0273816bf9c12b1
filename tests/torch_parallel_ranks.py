"""Rank-side checks of tests/test_torch_parallel.py and tests/test_torch_ulysses.py.

Each function runs on every rank of a gloo world of CPU ranks
(callireader_tpu_torch.parallel.dryrun.run_world) and returns what the
test process holds against the JAX package; this module imports no JAX.
Inputs arrive as numpy arrays made from seeds in the test process.
"""

import numpy as np
import torch
import torch.distributed as dist

from callireader_tpu_torch.core import partition
from callireader_tpu_torch.core.config import get_config
from callireader_tpu_torch.core.dtypes import FP32_POLICY
from callireader_tpu_torch.kernels.attention import attention_reference
from callireader_tpu_torch.models import internlm2, moe
from callireader_tpu_torch.parallel import spmd, ulysses
from callireader_tpu_torch.parallel.tp_attention import (
    flash_attention_tp, flash_decode_tp, paged_flash_decode_tp)
from callireader_tpu_torch.runtime import generate as gen
from callireader_tpu_torch.runtime.paged_cache import PagedBatcher
from callireader_tpu_torch.runtime.serving import ContinuousBatcher, Request
from callireader_tpu_torch.train import e_it, lora, moe_io

# the 8b-width model's new tokens: each step gathers its fsdp leaves over gloo
WIDE_TOKENS = 2


def _t(x):
    if isinstance(x, dict):
        return {k: _t(v) for k, v in x.items()}
    return torch.from_numpy(np.asarray(x))


def _heads(x, mesh, dim):
    return partition.local_shard(x, (None,) * dim + ("tensor",), mesh)


def wide_llm(cfg, seed: int):
    """The depth-cut model at the 8b's per-layer widths, drawn leaf by leaf
    from one torch generator (the test process draws the same)."""
    g = torch.Generator().manual_seed(seed)
    L, E, M = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    q, kv, V = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim, \
        cfg.vocab_size
    shapes = {"tok_embeddings": (V, E), "wq": (L, E, q), "wk": (L, E, kv), "wv": (L, E, kv),
              "wo": (L, q, E), "w1": (L, E, M), "w3": (L, E, M), "w2": (L, M, E),
              "output": (V, E)}
    for name, shape in shapes.items():
        yield name, torch.randn(shape, generator=g) * 0.02


def wide_tree(cfg, leaves):
    L, E = cfg.num_hidden_layers, cfg.hidden_size
    top = {"tok_embeddings", "output"}
    tree = {"layers": {"attn_norm": torch.ones((L, E)), "ffn_norm": torch.ones((L, E))},
            "norm": torch.ones((E,))}
    for name, leaf in leaves:
        (tree if name in top else tree["layers"])[name] = leaf
    return tree


def parallel_checks(p):
    rank = dist.get_rank()
    out = {}
    # ---- refusals: a mesh that is not the world's size
    for name, make in (("mesh", lambda: partition.make_mesh({"tensor": 3})),
                       ("spmd", lambda: spmd.make_mesh({"data": 2, "tensor": 4}, device="cpu"))):
        try:
            make()
            out[f"refused_{name}"] = False
        except ValueError:
            out[f"refused_{name}"] = True
    from callireader_tpu_torch.cli import common

    try:
        common.make_mesh("tensor=8", "cpu")
        out["refused_cli"] = False
    except ValueError:
        out["refused_cli"] = True

    # ---- the head-sharded kernel wrappers at tensor = 2 and 4
    q, k, v = _t(p["q"]), _t(p["k"]), _t(p["v"])
    seg = _t(p["seg"])
    qd, ck, cv, valid = _t(p["qd"]), _t(p["ck"]), _t(p["cv"]), _t(p["valid"])
    kp, vp, table, pvalid = _t(p["kpool"]), _t(p["vpool"]), _t(p["table"]), _t(p["pvalid"])
    for t in (2, 4):
        mesh = spmd.make_mesh({"data": 4 // t, "tensor": t}, device="cpu")
        a = flash_attention_tp(_heads(q, mesh, 1), _heads(k, mesh, 1), _heads(v, mesh, 1), mesh,
                               causal=True, q_segment_ids=seg, kv_segment_ids=seg)
        d = flash_decode_tp(_heads(qd, mesh, 1), _heads(ck, mesh, 2), _heads(cv, mesh, 2),
                            int(p["layer"]), valid, mesh)
        pg = paged_flash_decode_tp(_heads(qd, mesh, 1), _heads(kp, mesh, 2), _heads(vp, mesh, 2),
                                   int(p["layer"]), table, pvalid, mesh)
        for key, blk in (("attn", a), ("decode", d), ("paged", pg)):
            out[f"{key}{t}"] = spmd.all_gather(blk, mesh, "tensor", 1)

    # ---- token ids over fsdp=2, tensor=2 (the tiny LLM)
    cfg = get_config("callireader-tiny").llm
    mesh = spmd.make_mesh({"data": 1, "fsdp": 2, "tensor": 2, "seq": 1}, device="cpu")
    llm = _t(p["llm"])
    sh = spmd.shard_tree(llm, spmd.llm_logical_axes(cfg, llm), mesh)
    out["wq_block"] = tuple(sh["layers"]["wq"].shape)
    gc = gen.GenerateConfig(max_new_tokens=8, eos_token_ids=(-1,))
    out["generate"] = gen.generate_from_embeds(
        sh, cfg, _t(p["embeds"]), torch.ones(p["embeds"].shape[:2], dtype=torch.int32),
        gen_cfg=gc, max_cache_len=64, policy=FP32_POLICY, mesh=mesh)[0]

    def submit(b, rows, n):
        for uid, row in enumerate(rows):
            b.submit(Request(uid=uid, embeds=row, max_new_tokens=n, eos_token_ids=(-1,)))
        return {r.uid: list(r.tokens) for r in b.run()}

    cb = ContinuousBatcher(sh, cfg, num_slots=2, max_len=256, policy=FP32_POLICY, mesh=mesh)
    out["batcher"] = submit(cb, p["batch_rows"], 6)
    out["batcher_kv_heads"] = cb.cache_k.shape[2]
    pb = PagedBatcher(sh, cfg, num_slots=3, num_pages=16, page_size=64, max_pages_per_slot=4,
                      policy=FP32_POLICY, cache_dtype=torch.float32, mesh=mesh)
    out["prefix_len"] = pb.register_prefix(p["prefix_rows"], quantum=4)
    out["paged_batcher"] = submit(pb, p["paged_rows"], 5)
    out["prefix_hits"] = pb.prefix_hits

    # ---- the 8b's per-layer widths at depth 2, f32, odd vocab, over fsdp=2, tensor=2
    wcfg = internlm2_cfg(p["wide"])
    wide = wide_tree(wcfg, ((n, partition.local_shard(x, _spec(wcfg, n, mesh), mesh).clone())
                            for n, x in wide_llm(wcfg, int(p["wide_seed"]))))
    out["wide_wq_block"] = tuple(wide["layers"]["wq"].shape)
    ids = _t(p["wide_ids"])
    e = internlm2.embed_tokens(wide, ids, torch.float32, mesh, wcfg)
    out["wide_generate"] = gen.generate_from_embeds(
        wide, wcfg, e, torch.ones(ids.shape, dtype=torch.int32),
        gen_cfg=gen.GenerateConfig(max_new_tokens=WIDE_TOKENS, eos_token_ids=(-1,)),
        max_cache_len=64, policy=FP32_POLICY, mesh=mesh)[0]
    del wide

    # ---- expert parallelism over data=2, expert=2
    mcfg = moe.moe_tiny()
    emesh = spmd.make_mesh({"data": 2, "expert": 2}, device="cpu")
    whole = moe.init_params(mcfg, torch.Generator().manual_seed(int(p["moe_seed"])),
                            torch.float32, "cpu")
    local = spmd.shard_tree(e_it.clone_tree(whole, False), moe.logical_axes(mcfg), emesh)
    local = e_it.clone_tree(local, False)
    moe_io.save_sharded(p["moe_dir"], local, mcfg, emesh)
    ids = _t(p["moe_ids"])
    _, g_ref = moe.loss_and_grads(whole, mcfg, ids, policy=FP32_POLICY)
    _, g = moe.loss_and_grads(local, mcfg, ids, policy=FP32_POLICY, mesh=emesh)
    specs = spmd.flat_specs(whole, moe.logical_axes(mcfg), emesh)
    out["moe_grad_err"] = max(float((g[n] - partition.local_shard(g_ref[n], specs[n], emesh))
                                    .abs().max()) for n in g)
    out["moe_w1_block"] = tuple(local["layers"]["w1"].shape)
    init, step = moe.make_train_step(mcfg, 1e-3, policy=FP32_POLICY, mesh=emesh)
    opt = init(local)
    out["moe_losses"] = [float(step(local, opt, ids)) for _ in range(2)]
    one = spmd.make_mesh({"data": 4, "expert": 1}, device="cpu")
    back = moe_io.restore_sharded(p["moe_dir"], e_it.clone_tree(whole, False), mcfg, one)
    out["moe_restored_equal"] = all(torch.equal(a, b) for a, b in zip(
        e_it.flatten(back).values(), e_it.flatten(whole).values()))
    out["rank"] = rank
    return out


def internlm2_cfg(d):
    import dataclasses

    return dataclasses.replace(get_config("callireader-tiny").llm, **{k: int(v) for k, v in d.items()})


def _spec(cfg, name, mesh):
    axes = internlm2.logical_axes(cfg)
    a = axes.get(name, axes["layers"].get(name))
    L, E, M, V = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    q, kv = cfg.num_attention_heads * cfg.head_dim, cfg.num_key_value_heads * cfg.head_dim
    shape = {"tok_embeddings": (V, E), "output": (V, E), "wq": (L, E, q), "wk": (L, E, kv),
             "wv": (L, E, kv), "wo": (L, q, E), "w1": (L, E, M), "w3": (L, E, M),
             "w2": (L, M, E)}[name]
    return partition.spec_for_shape(shape, a, mesh=mesh)


def _seq_part(x, mesh, dim=2):
    return ulysses.split_for_sequence_parallel(x, mesh, dim=dim)


def ulysses_checks(p):
    out = {}
    # ---- the attention at sp = 2 and 4, and the inner-SP split (Hq=2 over sp=4)
    for name, sp in (("sp2", 2), ("sp4", 4), ("inner", 4)):
        mesh = spmd.make_mesh({"data": 4 // sp, "seq": sp}, device="cpu")
        q, k, v, w = (_t(p[name][x]) for x in ("q", "k", "v", "w"))
        parts = [_seq_part(x, mesh).clone().requires_grad_(True) for x in (q, k, v)]
        o = ulysses.ulysses_attention(*parts, mesh, causal=True)
        (o * _seq_part(w, mesh)).sum().backward()
        out[name] = {"out": spmd.all_gather(o.detach(), mesh, "seq", 2),
                     **{f"d{n}": spmd.all_gather(x.grad, mesh, "seq", 2)
                        for n, x in zip("qkv", parts)}}
        # the gradients of the same loss through the unsharded plain attention
        ref = [x.clone().requires_grad_(True) for x in (q, k, v)]
        (attention_reference(*ref, causal=True) * w).sum().backward()
        out[name]["ref"] = {f"d{n}": x.grad for n, x in zip("qkv", ref)}
        # the token-weighted loss over the seq ranks: rank r adds r + 1 over 2 tokens
        r = mesh.rank("seq")
        out[name]["loss"] = float(ulysses.reduce_sequence_parallel_loss(
            torch.tensor(float(r + 1)), torch.tensor(2), mesh))

    # ---- the e-IT step with seq=2 (and data=2) against the unsharded step
    cfg = get_config("callireader-tiny")
    tc = e_it.TrainConfig(learning_rate=5e-3, total_steps=10, warmup_ratio=0.0, remat=False,
                          lora_rank=4, lora_alpha=8.0)
    mesh = spmd.make_mesh({"data": 2, "fsdp": 1, "tensor": 1, "seq": 2}, device="cpu")
    batch = _t(p["eit_batch"])
    results = {}
    for m in (None, mesh):
        from callireader_tpu_torch.runtime import weights

        params = weights.init_params(cfg, 0, dtype=torch.float32, device="cpu")
        params["llm"] = lora.add_lora(params["llm"], cfg.llm, torch.Generator().manual_seed(1),
                                      rank=tc.lora_rank, alpha=tc.lora_alpha)
        axes = None if m is None else spmd.engine_logical_axes(cfg, params)
        state, frozen, tx = e_it.create_train_state(params, tc, m, axes)
        loss_fn = e_it.make_loss_fn(cfg, tc, policy=FP32_POLICY, mesh=m, use_flash=False)
        if m is None:
            flat = e_it.flatten(state.trainable)
            loss, metrics = loss_fn(e_it.merge_params(state.trainable, frozen), batch)
            grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()),
                                                       allow_unused=True, materialize_grads=True)))
        else:
            loss, metrics, grads = e_it.sharded_grads(loss_fn, state, frozen, batch)
        results["sharded" if m is not None else "plain"] = (
            float(metrics["loss"]), {k: v for k, v in grads.items() if "_lora_" in k})
        step = e_it.make_train_step(cfg, tc, tx, policy=FP32_POLICY, mesh=m, use_flash=False)
        state, metrics = step(state, frozen, batch)
        results[("sharded" if m is not None else "plain") + "_a"] = \
            e_it.gather_state(state).trainable["llm"]["layers"]["wq_lora_b"].detach()
    out["eit"] = results
    return out
