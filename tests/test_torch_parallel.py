"""The port's parallel layer (core/partition.py, parallel/spmd.py,
parallel/tp_attention.py, the sharded model, generate and batchers, expert
parallelism and the sharded MoE checkpoint) against the JAX package on the
CPU.

The multi-rank checks run in one gloo world of 4 CPU ranks for the module
(``run_world``, tests/torch_parallel_ranks.py, one thread a rank); the JAX
side runs on the conftest's 8 virtual devices through its plain routes
(interpret-mode Pallas for the ``*_tp`` wrappers, ``use_flash=False`` for
the models). Inputs are drawn from seeds in this process.

Tolerances: partition specs, logical-axes trees and every rank's block of a
sharded tree equal JAX's exactly (bit for bit for the blocks, f32); the
head-sharded attention, decode and paged decode, gathered over "tensor",
within f32 atol 1e-5 of JAX's ``*_tp``; token ids equal exactly; the
expert-parallel grads within 1e-5 (abs) of the unsharded port's, and the
sharded MoE checkpoint restores bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from callireader_tpu.core import partition as jpart
from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.models import internlm2 as jllm
from callireader_tpu.models import internvit as jvit
from callireader_tpu.models import llava as jllava
from callireader_tpu.models import moe as jmoe
from callireader_tpu.models import projector as jproj
from callireader_tpu.models import resampler as jres
from callireader_tpu.parallel import spmd as jspmd
from callireader_tpu.parallel import tp_attention as jtp
from callireader_tpu.runtime import generate as jgen
from callireader_tpu.runtime import quantize as jquant
from callireader_tpu.runtime.paged_cache import PagedBatcher as JPaged
from callireader_tpu.runtime.serving import ContinuousBatcher as JBatcher
from callireader_tpu.runtime.serving import Request as JRequest
from callireader_tpu.train import lora as jlora
from callireader_tpu_torch.core import partition as tpart
from callireader_tpu_torch.core.config import get_config
from callireader_tpu_torch.models import internlm2 as tllm
from callireader_tpu_torch.models import internvit as tvit
from callireader_tpu_torch.models import llava as tllava
from callireader_tpu_torch.models import moe as tmoe
from callireader_tpu_torch.models import projector as tproj
from callireader_tpu_torch.models import resampler as tres
from callireader_tpu_torch.parallel import spmd as tspmd
from callireader_tpu_torch.parallel.dryrun import run_world
from callireader_tpu_torch.runtime import quantize as tquant
from callireader_tpu_torch.runtime.weights import from_jax_params
from callireader_tpu_torch.train import lora as tlora
from callireader_tpu_torch.train import moe_io as tio

import torch_parallel_ranks as ranks

HERE = os.path.dirname(os.path.abspath(__file__))
ATOL = 1e-5
JCFG = callireader_tiny()
TCFG = get_config("callireader-tiny")
MESHES = ({"data": 8, "fsdp": 1, "tensor": 1, "seq": 1},
          {"data": 2, "fsdp": 2, "tensor": 2, "seq": 1},
          {"data": 4, "fsdp": 1, "tensor": 2, "seq": 1})
WIDE = dict(vocab_size=9253, hidden_size=4096, intermediate_size=14336, num_hidden_layers=2,
            num_attention_heads=32, num_key_value_heads=8, max_position_embeddings=32768)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _virtual(shape, r):
    coords = np.unravel_index(r, tuple(shape.values()))
    return tpart.Mesh.virtual(shape, dict(zip(shape, (int(c) for c in coords))))


# ------------------------------------------------------------------ specs, axes, blocks


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: ",".join(f"{k}={v}" for k, v in s.items()))
@pytest.mark.parametrize("axes", [("stack", "embed", "mlp"), ("vocab", "embed"), ("stack", "qkv", "embed"),
                                  ("batch", "seq"), ("expert", "embed", None), None])
def test_resolve_spec_matches_jax(shape, axes):
    jm = jpart.make_mesh(shape)
    got = tpart.resolve_spec(axes, mesh=_virtual(shape, 0))
    assert got == tuple(jpart.resolve_spec(axes, mesh=jm))


@pytest.mark.parametrize("shape,axes", [((92553, 64), ("vocab", "embed")),
                                        ((92554, 64), ("vocab", "embed")),
                                        ((2, 63, 128), ("stack", "embed", "mlp"))])
def test_spec_for_shape_replicates_indivisible(shape, axes):
    mesh = MESHES[1]
    got = tpart.spec_for_shape(shape, axes, mesh=_virtual(mesh, 0))
    assert got == tuple(jpart.spec_for_shape(shape, axes, mesh=jpart.make_mesh(mesh)))


@pytest.fixture(scope="module")
def jparams():
    """The engine tree (the port's seed-0 draw, which has the JAX tree's
    structure and shapes) as JAX arrays."""
    from callireader_tpu_torch.runtime.weights import init_params

    tree = init_params(TCFG, 0, dtype=torch.float32, device="cpu")
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def _lora(p):
    p = dict(p)
    p["llm"] = jlora.add_lora(p["llm"], JCFG.llm, jax.random.PRNGKey(1), rank=4, alpha=8)
    return p


def _int8(p, fused=False, vit=False):
    p = dict(p)
    p["llm"] = jquant.quantize_llm_int8(p["llm"])
    if fused:
        p["llm"] = jquant.fuse_llm_int8(p["llm"])
    if vit:
        p["vision"] = jquant.quantize_vit_int8(p["vision"])
    return p


TREES = {"dense": lambda p: p, "lora": _lora, "int8": _int8,
         "int8_fused": lambda p: _int8(p, fused=True), "int8_all": lambda p: _int8(p, vit=True)}


@pytest.mark.parametrize("variant", list(TREES))
def test_engine_logical_axes_match_jax(jparams, variant):
    jp = TREES[variant](jparams)
    tp = _np(jp)
    assert tspmd.engine_logical_axes(TCFG, tp) == jspmd.engine_logical_axes(JCFG, jp)


@pytest.mark.parametrize("name", ["internlm2", "internvit", "projector", "resampler",
                                  "resampler_out", "moe", "llava_projector", "lora"])
def test_model_logical_axes_match_jax(name):
    res_out = dataclasses.replace(JCFG.resampler, out_dim=64)
    pairs = {
        "internlm2": (tllm.logical_axes(TCFG.llm), jllm.logical_axes(JCFG.llm)),
        "internvit": (tvit.logical_axes(TCFG.vision), jvit.logical_axes(JCFG.vision)),
        "projector": (tproj.logical_axes(TCFG), jproj.logical_axes(JCFG)),
        "resampler": (tres.logical_axes(TCFG.resampler), jres.logical_axes(JCFG.resampler)),
        "resampler_out": (tres.logical_axes(dataclasses.replace(TCFG.resampler, out_dim=64)),
                          jres.logical_axes(res_out)),
        "moe": (tmoe.logical_axes(tmoe.moe_tiny()), jmoe.logical_axes(jmoe.moe_tiny())),
        "llava_projector": (tllava.projector_logical_axes(3), jllava.projector_logical_axes(3)),
        "lora": (tlora.lora_logical_axes(tllm.logical_axes(TCFG.llm)),
                 jlora.lora_logical_axes(jllm.logical_axes(JCFG.llm))),
    }
    assert pairs[name][0] == pairs[name][1]


@pytest.mark.parametrize("fused", [False, True])
def test_quantized_logical_axes_match_jax(jparams, fused):
    jp = _int8(jparams, fused=fused, vit=True)
    tp = _np(jp)
    assert tquant.quantized_logical_axes(tllm.logical_axes(TCFG.llm), tp["llm"]) == \
        jquant.quantized_logical_axes(jllm.logical_axes(JCFG.llm), jp["llm"])
    assert tquant.quantized_vit_logical_axes(tvit.logical_axes(TCFG.vision), tp["vision"]) == \
        jquant.quantized_vit_logical_axes(jvit.logical_axes(JCFG.vision), jp["vision"])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: ",".join(f"{k}={v}" for k, v in s.items()))
def test_shard_tree_blocks_equal_jax_shards(jparams, shape):
    """Every rank's block of every leaf (engine tree with LoRA) equals the
    JAX NamedSharding's shard on the device at the same mesh position."""
    jp = _lora(jparams)
    jm = jpart.make_mesh(shape)
    jsh = jspmd.shard_tree(jp, jspmd.engine_logical_axes(JCFG, jp), jm)
    tp = from_jax_params(_np(jp), device="cpu")
    axes = tspmd.engine_logical_axes(TCFG, tp)
    jleaves = jax.tree_util.tree_leaves(jsh)
    devices = jax.devices()
    for r in range(len(devices)):
        local = jax.tree_util.tree_leaves(tspmd.shard_tree(tp, axes, _virtual(shape, r)))
        assert len(local) == len(jleaves)
        for got, arr in zip(local, jleaves):
            want = next(s.data for s in arr.addressable_shards if s.device == devices[r])
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_parse_mesh_fills_data():
    assert tspmd.parse_mesh("tensor=4,fsdp=2", 16) == {"tensor": 4, "fsdp": 2, "data": 2}
    assert tspmd.parse_mesh("tensor=1", 1) == {"tensor": 1, "data": 1}
    assert tspmd.parse_mesh("data=2,seq=4", 8, fill="data") == {"data": 2, "seq": 4}
    with pytest.raises(ValueError):
        tspmd.parse_mesh("tensor", 4)


def test_local_shard_cuts_rank_blocks():
    x = torch.arange(48.0).reshape(4, 12)
    shape = {"data": 2, "tensor": 3}
    blocks = [tpart.local_shard(x, ("data", "tensor"), _virtual(shape, r)) for r in range(6)]
    rows = [torch.cat(blocks[i * 3:(i + 1) * 3], dim=1) for i in range(2)]
    assert torch.equal(torch.cat(rows), x)
    # a dim over two axes (the batch rows over data x fsdp): in rank order
    shape = {"data": 2, "fsdp": 2, "tensor": 2}
    rows = [tspmd.shard_batch({"input_ids": x}, _virtual(shape, r))["input_ids"]
            for r in range(0, 8, 2)]
    assert all(b.shape == (1, 12) for b in rows) and torch.equal(torch.cat(rows), x)


# ------------------------------------------------------------------ the gloo world


def _wide_cfg():
    return dataclasses.replace(JCFG.llm, **WIDE)


def _wide_jax_params(seed):
    cfg = _wide_cfg()
    tree = ranks.wide_tree(cfg, ranks.wide_llm(cfg, seed))
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.RandomState(0)
    B, Hq, Hkv, S, D = 2, 8, 4, 128, 32
    seg = np.zeros((B, S), np.int32)
    seg[1, :20] = -1
    L, P, page, NP = 2, 3, 16, 6
    valid = (rng.rand(B, S) > 0.3).astype(np.int32)
    table = rng.permutation(NP)[:B * P].reshape(B, P).astype(np.int32)
    pvalid = np.zeros((B, P, page), np.int32)
    pvalid[0, :2] = 1
    pvalid[1, 0, :5] = 1
    pvalid[1, 2, 3:9] = 1
    f = lambda *s: rng.randn(*s).astype(np.float32)
    llm = _np(jllm.init_params(jax.random.PRNGKey(0), JCFG.llm, dtype=jnp.float32))
    ids = rng.randint(10, 900, (2, 16)).astype(np.int32)
    embed = lambda x: np.asarray(jllm.embed_tokens(llm, jnp.asarray(np.asarray(x)[None]),
                                                   jnp.float32))[0]
    prefix = [1] + list(rng.randint(2, 900, 19))
    payload = {
        "q": f(B, Hq, S, D), "k": f(B, Hkv, S, D), "v": f(B, Hkv, S, D), "seg": seg,
        "qd": f(B, Hq, 1, D), "ck": f(L, B, Hkv, S, D), "cv": f(L, B, Hkv, S, D),
        "valid": valid, "layer": 1, "kpool": f(L, NP, Hkv, page, D),
        "vpool": f(L, NP, Hkv, page, D), "table": table, "pvalid": pvalid,
        "llm": llm,
        "embeds": np.asarray(jllm.embed_tokens(llm, jnp.asarray(ids), jnp.float32)),
        "batch_rows": [embed(rng.randint(10, 900, n)) for n in (5, 9, 3)],
        "prefix_rows": embed(prefix),
        "paged_rows": [embed(prefix + list(rng.randint(2, 900, n))) for n in (3, 6)]
        + [embed([1, 9, 2, 7])],
        "wide": WIDE, "wide_seed": 7,
        "wide_ids": rng.randint(10, 9000, (1, 32)).astype(np.int64),
        "moe_seed": 3, "moe_ids": rng.randint(0, 512, (4, 16)).astype(np.int64),
        "moe_dir": str(tmp_path_factory.mktemp("moe_ckpt")),
    }
    out = run_world(4, "torch_parallel_ranks:parallel_checks", payload, sys_path=[HERE],
                    timeout=600)
    return payload, out


def test_world_mesh_refusals(world):
    _, out = world
    for r in out:
        assert r["refused_mesh"] and r["refused_spmd"] and r["refused_cli"]


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("kind", ["attn", "decode", "paged"])
def test_tp_attention_matches_jax(world, kind, t):
    p, out = world
    jm = jpart.make_mesh({"data": 8 // t, "tensor": t})
    j = {k: jnp.asarray(p[k]) for k in ("q", "k", "v", "seg", "qd", "ck", "cv", "valid",
                                        "kpool", "vpool", "table", "pvalid")}
    if kind == "attn":
        want = jtp.flash_attention_tp(j["q"], j["k"], j["v"], jm, causal=True,
                                      q_segment_ids=j["seg"], kv_segment_ids=j["seg"],
                                      interpret=True)
    elif kind == "decode":
        want = jtp.flash_decode_tp(j["qd"], j["ck"], j["cv"], jnp.int32(p["layer"]), j["valid"],
                                   jm, interpret=True)
    else:
        want = jtp.paged_flash_decode_tp(j["qd"], j["kpool"], j["vpool"], jnp.int32(p["layer"]),
                                         j["table"], j["pvalid"], jm, interpret=True)
    for r in out:
        np.testing.assert_allclose(r[f"{kind}{t}"].numpy(), np.asarray(want), rtol=0, atol=ATOL)


def test_sharded_generate_token_ids(world):
    p, out = world
    gc = jgen.GenerateConfig(max_new_tokens=8, eos_token_ids=(-1,))
    want, _ = jgen.generate_from_embeds(p["llm"], JCFG.llm, jnp.asarray(p["embeds"]),
                                        jnp.ones((2, 16), jnp.int32), gen_cfg=gc, max_cache_len=64,
                                        policy=J_FP32, use_flash=False)
    for r in out:
        np.testing.assert_array_equal(r["generate"].numpy(), np.asarray(want))
        # wq (L, E, Hq*D) shards over fsdp (E) and tensor (Hq*D)
        E, N = JCFG.llm.hidden_size, JCFG.llm.num_attention_heads * JCFG.llm.head_dim
        assert r["wq_block"] == (JCFG.llm.num_hidden_layers, E // 2, N // 2)


def _served(batcher, rows, n):
    for uid, row in enumerate(rows):
        batcher.submit(JRequest(uid=uid, embeds=row, max_new_tokens=n, eos_token_ids=(-1,)))
    return {r.uid: list(r.tokens) for r in batcher.run()}


def test_sharded_batcher_token_ids(world):
    p, out = world
    want = _served(JBatcher(p["llm"], JCFG.llm, num_slots=2, max_len=256, policy=J_FP32,
                            use_flash=False), p["batch_rows"], 6)
    for r in out:
        assert r["batcher"] == want
        assert r["batcher_kv_heads"] == JCFG.llm.num_key_value_heads // 2


def test_sharded_paged_batcher_prefix_hit_token_ids(world):
    p, out = world
    want = _served(JPaged(p["llm"], JCFG.llm, num_slots=3, num_pages=16, page_size=64,
                          max_pages_per_slot=4, policy=J_FP32, use_flash=False,
                          cache_dtype=jnp.float32), p["paged_rows"], 5)
    for r in out:
        assert r["prefix_len"] == 20 and r["prefix_hits"] == 2
        assert r["paged_batcher"] == want


def test_8b_width_sharded_generate_token_ids(world):
    """The 8b's per-layer widths (4096 / 14336, 32:8 heads) at depth 2 over
    fsdp=2, tensor=2, the odd 9253-row vocab replicated over "tensor":
    the token ids of JAX's unsharded generate."""
    p, out = world
    cfg = _wide_cfg()
    params = _wide_jax_params(p["wide_seed"])
    ids = jnp.asarray(p["wide_ids"], jnp.int32)
    e = jllm.embed_tokens(params, ids, jnp.float32)
    want, _ = jgen.generate_from_embeds(
        params, cfg, e, jnp.ones(ids.shape, jnp.int32),
        gen_cfg=jgen.GenerateConfig(max_new_tokens=ranks.WIDE_TOKENS, eos_token_ids=(-1,)),
        max_cache_len=64,
        policy=J_FP32, use_flash=False)
    del params
    for r in out:
        np.testing.assert_array_equal(r["wide_generate"].numpy(), np.asarray(want))
        assert r["wide_wq_block"] == (2, 4096 // 2, 4096 // 2)


def test_moe_expert_parallel_step(world):
    _, out = world
    for r in out:
        loss1, loss2 = r["moe_losses"]
        assert np.isfinite(loss1) and loss2 < loss1
        assert r["moe_grad_err"] <= ATOL
        X, E, M = 4, 64, 128
        assert r["moe_w1_block"] == (2, X // 2, E, M)


def test_moe_sharded_checkpoint_round_trip(world):
    p, out = world
    cfg = tmoe.moe_tiny()
    whole = tmoe.init_params(cfg, torch.Generator().manual_seed(p["moe_seed"]), torch.float32,
                             "cpu")
    assert sorted(f for f in os.listdir(p["moe_dir"]) if f.startswith("experts-")) == \
        ["experts-00000-of-00002.pt", "experts-00001-of-00002.pt"]
    back = tio.restore_sharded(p["moe_dir"], whole, cfg)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(whole)):
        assert torch.equal(a, b)
    assert all(r["moe_restored_equal"] for r in out)


def test_dryrun_multichip_4(capfd):
    from callireader_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4)
    text = capfd.readouterr().out
    for stage in ("train step OK", "ulysses SP attention OK", "MoE expert-parallel grad OK",
                  "[dryrun] PASS"):
        assert stage in text


@pytest.mark.parametrize("shape", [{"data": 4, "fsdp": 1, "tensor": 2, "seq": 1},
                                   {"data": 2, "fsdp": 1, "tensor": 1, "seq": 4}],
                         ids=["data4_tensor2", "data2_seq4"])
def test_shard_batch_blocks_match_jax(shape):
    """Token arrays by rows over "data" (and the sequence over "seq" where
    asked), payloads whole: each rank's block equals the JAX shard on the
    device at its mesh position (the port also splits rows over "fsdp",
    of size 1 here)."""
    seq = shape["seq"] > 1
    rng = np.random.RandomState(5)
    batch = {"input_ids": rng.randint(0, 100, (8, 16)).astype(np.int32),
             "pixel_values": rng.rand(8, 4, 4, 3).astype(np.float32)}
    jm = jpart.make_mesh(shape)
    jb = jspmd.shard_batch(dict(batch), jm, seq_sharded=seq)
    for r, d in enumerate(jax.devices()):
        tb = tspmd.shard_batch(dict(batch), _virtual(shape, r), seq_sharded=seq)
        for k in batch:
            want = next(s.data for s in jb[k].addressable_shards if s.device == d)
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(want))
