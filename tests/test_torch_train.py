"""The port's e-IT trainer against the JAX package on the CPU.

Same parameters (``init_all_params`` + ``add_lora`` in JAX, moved by
``from_jax_params``), same numpy batches, tiny config, FP32 policy; the JAX
side runs its reference attention (``use_flash=False``), the port its
trainable attention's plain version. Tolerances (fp32, summation order only):
- LoRA forward logits: 1e-4 max abs (tests/test_torch_models.py's bar);
- merge_lora: 1e-6;
- loss: 1e-5 relative; grads: 1e-5 max abs + 1e-4 relative per leaf;
- learning rate: 1e-6 relative (optax computes it in fp32);
- four accumulated train steps: losses and grad norms 1e-4 relative, every
  trainable leaf 1e-6 max abs (Adam moves each element by ~lr = 5e-3);
- data: token ids, labels, pseudo rows and the collated arrays identical;
  pixels within 1e-6 (the port's uint8 tiles normalised on the device against
  the JAX float32 tiles of the same PNG).
The train CLI runs end to end with ``--device cpu``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.models import internlm2 as jllm
from callireader_tpu.runtime import quantize as jquant
from callireader_tpu.runtime.engine import init_all_params
from callireader_tpu.runtime.tokenizer import InternLM2Tokenizer as JTokenizer
from callireader_tpu.train import data as jdata
from callireader_tpu.train import e_it as jeit
from callireader_tpu.train import lora as jlora
from callireader_tpu_torch.cli import train as train_cli
from callireader_tpu_torch.configs import get_config as t_get_recipe
from callireader_tpu_torch.core import config as tconfig
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.models import internlm2 as tllm
from callireader_tpu_torch.models import internvit as tvit
from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer as TTokenizer
from callireader_tpu_torch.runtime.weights import from_jax_params
from callireader_tpu_torch.train import checkpoint as tckpt
from callireader_tpu_torch.train import data as tdata
from callireader_tpu_torch.train import e_it as teit
from callireader_tpu_torch.train import lora as tlora
from callireader_tpu_torch.utils import profiling as tprof

JCFG = callireader_tiny()
TCFG = tconfig.callireader_tiny()
TOKENIZER = "callireader_tpu/assets/tokenizer.model"


def _t(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _flat(tree):
    """A JAX tree with None holes -> {"a/b": torch tensor}."""
    return {k: torch.from_numpy(np.array(v)) for k, v in teit.flatten(tree).items()}


def _jax_params(seed=0, rank=4, active_b=True, qlora=False):
    """init_all_params + add_lora (fp32), B drawn from numpy so every adapter
    is active (a's gradient is zero while B is)."""
    params = init_all_params(jax.random.PRNGKey(seed), JCFG, dtype=jnp.float32)
    params["llm"] = jlora.add_lora(params["llm"], JCFG.llm, jax.random.PRNGKey(seed + 1),
                                   rank=rank, alpha=2.0 * rank)
    if active_b:
        rng = np.random.default_rng(seed)
        layers = dict(params["llm"]["layers"])
        for k in layers:
            if k.endswith("_lora_b"):
                layers[k] = jnp.asarray(rng.standard_normal(layers[k].shape, dtype=np.float32) * 0.02)
        params["llm"] = dict(params["llm"], layers=layers)
    if qlora:
        params["llm"] = jquant.quantize_llm_int8(params["llm"])
    return params


def _batch(seed=0, B=2, S=64, pixels=True, pseudo=True):
    """A collated-style numpy batch: image slots after BOS, pseudo slots after
    them, supervised second half, the second row right-padded (-1 segments)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, 1000, (B, S)).astype(np.int32)
    nit, n_ps = JCFG.num_image_token, 6
    if pixels:
        ids[:, 1:1 + nit] = JCFG.img_context_token_id
    if pseudo:
        ids[:, 1 + nit:1 + nit + n_ps] = JCFG.aligned_token_id
    labels = np.where(np.arange(S)[None] >= S // 2, ids, jeit.IGNORE_INDEX).astype(np.int32)
    seg = np.zeros((B, S), np.int32)
    pad = S - 9
    seg[1, pad:], ids[1, pad:], labels[1, pad:] = -1, 2, jeit.IGNORE_INDEX
    pos = np.where(seg >= 0, np.arange(S)[None], 0).astype(np.int32)
    batch = {"input_ids": ids, "labels": labels, "segment_ids": seg, "positions": pos}
    if pixels:
        size = JCFG.force_image_size
        batch["pixel_values"] = rng.integers(0, 256, (B, size, size, 3), dtype=np.uint8)
    if pseudo:
        batch["pseudo_embeds"] = rng.standard_normal((B * n_ps, JCFG.llm.hidden_size),
                                                     dtype=np.float32)
    return batch


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ------------------------------------------------------------------ (b) LoRA


@pytest.mark.parametrize("remat", [False, True])
def test_lora_forward_matches_jax(remat):
    params = _jax_params()["llm"]
    b = _batch(pixels=False, pseudo=False)
    want = jllm.forward(params, JCFG.llm, input_ids=jnp.asarray(b["input_ids"]),
                        positions=jnp.asarray(b["positions"]),
                        segment_ids=jnp.asarray(b["segment_ids"]), policy=J_FP32, use_flash=False)
    got = tllm.forward(_t(params), TCFG.llm, input_ids=torch.from_numpy(b["input_ids"]),
                       positions=torch.from_numpy(b["positions"]),
                       segment_ids=torch.from_numpy(b["segment_ids"]), policy=T_FP32, remat=remat)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_merge_lora_matches_jax():
    params = _jax_params()["llm"]
    want = jlora.merge_lora(params)
    got = tlora.merge_lora(_t(params))
    assert sorted(got["layers"]) == sorted(want["layers"])
    assert not any("_lora_" in k or k == "lora_scale" for k in got["layers"])
    for k in want["layers"]:
        np.testing.assert_allclose(got["layers"][k].numpy(), np.asarray(want["layers"][k]),
                                   atol=1e-6, rtol=0, err_msg=k)


def test_add_lora_shapes_and_init():
    llm = _t(jllm.init_params(jax.random.PRNGKey(0), JCFG.llm, jnp.float32))
    out = tlora.add_lora(llm, TCFG.llm, torch.Generator().manual_seed(0), rank=8, alpha=16.0)
    layers, L = out["layers"], TCFG.llm.num_hidden_layers
    assert tlora.lora_param_names() == jlora.lora_param_names()
    for name in tlora.DEFAULT_TARGETS:
        _, d_in, d_out = layers[name].shape
        a, b = layers[f"{name}_lora_a"], layers[f"{name}_lora_b"]
        assert a.shape == (L, d_in, 8) and b.shape == (L, 8, d_out)
        assert a.dtype == b.dtype == torch.float32 and not b.any()
        assert abs(a.std().item() * 8 - 1) < 0.15  # N(0, 1) / r
    assert torch.equal(layers["lora_scale"], torch.full((L,), 2.0))
    assert "wq_lora_a" not in llm["layers"]  # a new tree


# --------------------------------------------------------- (c) loss and grads


def test_eit_loss_and_grads_match_jax():
    params = _jax_params()
    batch = _batch()
    tc = jeit.TrainConfig()
    j_train, j_frozen = jeit.partition_params(params, tc)

    def loss_fn(trainable):
        return jeit.eit_loss(jeit.merge_params(trainable, j_frozen), JCFG,
                             {k: jnp.asarray(v) for k, v in batch.items()},
                             policy=J_FP32, use_flash=False, remat=False)

    (j_loss, j_metrics), j_grads = jax.value_and_grad(loss_fn, has_aux=True)(j_train)
    j_grads = _flat(j_grads)

    t_params = _t(params)
    t_train, t_frozen = teit.partition_params(t_params, teit.TrainConfig())
    flat = teit.flatten(t_train)
    assert sorted(flat) == sorted(j_grads)  # LoRA a/b of 7 targets + the projector
    assert not any(k.endswith("lora_scale") for k in flat)
    for leaf in flat.values():
        leaf.requires_grad_(True)
    loss, metrics = teit.eit_loss(teit.merge_params(t_train, t_frozen), TCFG, _tb(batch),
                                  policy=T_FP32, remat=True)
    grads = dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    assert int(metrics["n_tokens"]) == int(j_metrics["n_tokens"])
    for k, g in grads.items():
        want = j_grads[k].numpy()
        assert np.abs(want).max() > 0, k
        np.testing.assert_allclose(g.numpy(), want, atol=1e-5 * np.abs(want).max(), rtol=1e-4,
                                   err_msg=k)
    assert all(t.grad is None for t in teit.flatten(t_frozen).values())


# ---------------------------------------------------------- (d) schedule, steps


@pytest.mark.parametrize("total,warmup_ratio", [(40, 0.0), (100, 0.03), (7, 0.5)])
def test_lr_schedule_matches_optax(total, warmup_ratio):
    tc = teit.TrainConfig(learning_rate=5e-5, total_steps=total, warmup_ratio=warmup_ratio)
    warmup = max(1, int(total * warmup_ratio))
    want = optax.warmup_cosine_decay_schedule(0.0, 5e-5, warmup, total, 0.0)
    sched = teit.lr_schedule(tc)
    assert sched(0) == 0.0  # the first update runs at lr 0
    for count in range(total + 3):
        np.testing.assert_allclose(sched(count), float(want(count)), rtol=1e-6, atol=1e-12)


def test_lr_schedule_refuses_no_decay():
    with pytest.raises(ValueError):
        teit.lr_schedule(teit.TrainConfig(total_steps=1))


@pytest.mark.parametrize("qlora", [False, True])
def test_train_steps_match_jax(qlora):
    """Four micro-steps with grad_accum=2 (two updates: the first at lr 0)
    from the same params and batches: losses, grad norms (of each micro
    batch, before clipping), MultiSteps counters and every trainable leaf
    after every step. qlora: int8 frozen base (tests/test_train.py:200)."""
    params = _jax_params(qlora=qlora)
    kw = dict(learning_rate=5e-3, total_steps=10, warmup_ratio=0.0, grad_accum=2, grad_clip=0.5)
    j_state, j_frozen, tx = jeit.create_train_state(params, jeit.TrainConfig(remat=False, **kw))
    j_step = jax.jit(jeit.make_train_step(JCFG, jeit.TrainConfig(remat=False, **kw), tx,
                                          policy=J_FP32, use_flash=False))
    t_cfg = teit.TrainConfig(remat=True, **kw)
    t_state, t_frozen, t_tx = teit.create_train_state(_t(params), t_cfg)
    t_step = teit.make_train_step(TCFG, t_cfg, t_tx, policy=T_FP32)
    if qlora:
        assert "wq_q" in t_frozen["llm"]["layers"] and t_frozen["llm"]["layers"]["wq_q"].dtype == torch.int8
        q_before = t_frozen["llm"]["layers"]["wq_q"].clone()
    for i in range(4):
        batch = _batch(seed=i % 2)
        j_state, j_m = j_step(j_state, j_frozen, {k: jnp.asarray(v) for k, v in batch.items()})
        t_state, t_m = t_step(t_state, t_frozen, _tb(batch))
        np.testing.assert_allclose(t_m["loss"].item(), float(j_m["loss"]), rtol=1e-4)
        np.testing.assert_allclose(t_m["grad_norm"].item(), float(j_m["grad_norm"]), rtol=1e-4)
        assert t_state.step == int(j_state.step) == i + 1
        assert t_state.opt_state["gradient_step"] == int(j_state.opt_state.gradient_step)
        want = _flat(j_state.trainable)
        for k, v in teit.flatten(t_state.trainable).items():
            np.testing.assert_allclose(v.detach().numpy(), want[k].numpy(), atol=1e-6, rtol=0,
                                       err_msg=f"step {i + 1} {k}")
    moved = teit.flatten(t_state.trainable)["llm/layers/wq_lora_b"]
    assert not torch.equal(moved, _t(params)["llm"]["layers"]["wq_lora_b"])
    if qlora:
        assert torch.equal(t_frozen["llm"]["layers"]["wq_q"], q_before)


def test_int8_base_under_autograd_takes_the_differentiable_form(monkeypatch):
    """A 128-wide int8 base (K, N multiples of 128) at 2 x 16 = 32 rows: an
    inference forward sends its projections to the int8 kernels' wrappers, a
    forward whose activations autograd tracks (LoRA trained over the int8
    base) takes the XLA form, which autograd can differentiate. The vocab is
    padded (200 -> 256 rows), so the backward also runs through the logits'
    pad mask."""
    import dataclasses

    from callireader_tpu_torch.runtime import quantize as tquant
    from callireader_tpu_torch.runtime.weights import _Init, init_llm

    cfg = dataclasses.replace(TCFG.llm, hidden_size=128, intermediate_size=256,
                              num_attention_heads=4, num_key_value_heads=2, vocab_size=200)
    llm = init_llm(_Init(torch.Generator().manual_seed(0), "cpu", torch.float32), cfg)
    llm = tquant.quantize_llm_int8(tlora.add_lora(llm, cfg, torch.Generator().manual_seed(1),
                                                  rank=4, alpha=8.0))
    llm, cfg = tllm.pad_vocab(llm, cfg, 128)
    calls = {"kn": 0, "nt": 0}
    for key, name in (("kn", "int8_matmul"), ("nt", "int8_matmul_nt")):
        orig = getattr(tllm, name)

        def spy(*a, _orig=orig, _key=key):
            calls[_key] += 1
            return _orig(*a)

        monkeypatch.setattr(tllm, name, spy)
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 200, (2, 16)))
    with torch.no_grad():
        want = tllm.forward(llm, cfg, input_ids=ids, policy=T_FP32)
    kn = 5 * cfg.num_hidden_layers  # wk and wv are 64 wide: those two take the XLA form
    assert calls == {"kn": kn, "nt": 1}
    b = llm["layers"]["wq_lora_b"].requires_grad_(True)  # B = 0: A's gradient is 0
    got = tllm.forward(llm, cfg, input_ids=ids, policy=T_FP32, remat=True)
    # under autograd only layer 0's wq sees an activation nothing trainable
    # feeds (the frozen embeddings): its product needs no gradient
    assert calls == {"kn": kn + 1, "nt": 1}
    assert (got[..., 200:] == torch.finfo(torch.float32).min).all()
    torch.log_softmax(got, -1)[..., :200].mean().backward()
    assert b.grad is not None and torch.isfinite(b.grad).all() and b.grad.abs().sum() > 0
    np.testing.assert_allclose(got.detach().numpy(), want.numpy(), atol=1e-4, rtol=0)


def test_optimizer_clips_like_optax():
    """Updates without accumulation against optax's chain on a toy tree:
    clip_by_global_norm scales by max_norm / norm (no epsilon), AdamW's
    decay reaches every leaf, the schedule advances once per update."""
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((5, 3), dtype=np.float32),
              "b": rng.standard_normal((3,), dtype=np.float32)}
    tc = teit.TrainConfig(learning_rate=0.1, total_steps=10, warmup_ratio=0.0, grad_clip=1.0)
    jtx = jeit.make_optimizer(jeit.TrainConfig(learning_rate=0.1, total_steps=10,
                                               warmup_ratio=0.0, grad_clip=1.0))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    j_opt = jtx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ttx = teit.make_optimizer(tc)
    t_opt = ttx.init(tp)
    for i in range(4):
        scale = 3.0 if i % 2 else 0.01  # clipped, then not
        grads = {k: rng.standard_normal(v.shape, dtype=np.float32) * scale
                 for k, v in params.items()}
        upd, j_opt = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, j_opt, jp)
        jp = optax.apply_updates(jp, upd)
        ttx.update({k: torch.from_numpy(v) for k, v in grads.items()}, t_opt, tp)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0)
    assert t_opt["count"] == 4


# --------------------------------------------------------------------- (e) data


def _write_dataset(root, n=3):
    """n samples: a PNG for JAX and the same pixels as .npy for the port; the
    embedding as .npy (odd samples as a torch file)."""
    from PIL import Image

    rng = np.random.default_rng(0)
    j_ann, t_ann = [], []
    for i in range(n):
        h, w = (90, 200) if i % 2 else (300, 120)
        y, x = np.mgrid[:h, :w]
        page = np.stack([(x * 3 + y) % 256, (y * 5) % 256, (x * y) % 256], -1).astype(np.uint8)
        Image.fromarray(page).save(root / f"p{i}.png")
        np.save(root / f"p{i}.npy", page)
        emb = rng.standard_normal((2, 3, JCFG.llm.hidden_size), dtype=np.float32)
        if i % 2:
            torch.save(torch.from_numpy(emb), root / f"e{i}.pt")
            emb_name = f"e{i}.pt"
        else:
            np.save(root / f"e{i}.npy", emb)
            emb_name = f"e{i}.npy"
        conv = [{"from": "human", "value": "读出图中所有文字。"},
                {"from": "gpt", "value": "春眠不觉晓" * (i + 1)},
                {"from": "human", "value": "再读一遍"}, {"from": "gpt", "value": "处处闻啼鸟"}]
        j_ann.append({"image": f"p{i}.png", "embedding": emb_name, "conversations": conv})
        t_ann.append(dict(j_ann[-1], image=f"p{i}.npy"))
    (root / "j.json").write_text(json.dumps(j_ann, ensure_ascii=False))
    (root / "t.jsonl").write_text("".join(json.dumps(a, ensure_ascii=False) + "\n" for a in t_ann))


def test_dataset_collate_and_loader_match_jax(tmp_path):
    _write_dataset(tmp_path)
    jds = jdata.EITDataset(str(tmp_path / "j.json"), JCFG, JTokenizer(TOKENIZER),
                           image_root=str(tmp_path))
    tds = tdata.EITDataset(str(tmp_path / "t.jsonl"), TCFG, TTokenizer(TOKENIZER),
                           image_root=str(tmp_path))
    assert len(tds) == len(jds) == 3 and tds.lengths() == jds.lengths()

    def same(t, j):
        assert sorted(t) == sorted(j)
        for k in j:
            if k == "pixel_values":
                got = tvit.normalize_uint8(torch.from_numpy(t[k])).numpy()
                np.testing.assert_allclose(got, j[k], atol=1e-6, rtol=0)
            else:
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)

    samples = [tds[i] for i in range(3)]
    for i, s in enumerate(samples):
        assert s["pixel_values"].dtype == np.uint8
        same(s, jds[i])
    same(tdata.collate(samples), jdata.collate([jds[i] for i in range(3)]))
    text = [{k: s[k] for k in ("input_ids", "labels")} for s in samples]
    for target in (64, 4096):
        same(tdata.pack_samples(text, target), jdata.pack_samples(text, target))
    for seed in (0, 3):
        t_batches = list(tdata.data_loader(tds, 2, shuffle_seed=seed))
        j_batches = list(jdata.data_loader(jds, 2, shuffle_seed=seed))
        assert len(t_batches) == len(j_batches) == tdata.batches_per_epoch(3, 2)
        for t, j in zip(t_batches, j_batches):
            same(t, j)


@pytest.mark.parametrize("n,batch", [(37, 4), (8, 2), (3, 5)])
def test_grouping_and_epoch_arithmetic_match_jax(n, batch):
    lengths = list(np.random.default_rng(n).integers(10, 100, n))
    for seed in (0, 7):
        assert tdata.length_grouped_indices(lengths, batch, seed=seed) == \
            [int(i) for i in jdata.length_grouped_indices(lengths, batch, seed=seed)]
    for drop_last in (True, False):
        assert tdata.batches_per_epoch(n, batch, drop_last=drop_last) == \
            jdata.batches_per_epoch(n, batch, drop_last=drop_last)


def test_dataset_refuses_undecodable_image(tmp_path):
    (tmp_path / "a.json").write_text(json.dumps([{"image": "p.png", "conversations": [
        {"from": "human", "value": "x"}, {"from": "gpt", "value": "y"}]}]))
    ds = tdata.EITDataset(str(tmp_path / "a.json"), TCFG, TTokenizer(TOKENIZER),
                          image_root=str(tmp_path), max_refetch=1)
    with pytest.raises(ValueError, match=r"\.npy"):
        ds[0]


# --------------------------------------------------------- checkpoint, recipes


def test_train_state_and_params_roundtrip(tmp_path):
    params = _t(_jax_params(rank=2))
    tc = teit.TrainConfig(total_steps=10, grad_accum=2)
    state, frozen, tx = teit.create_train_state(params, tc)
    step = teit.make_train_step(TCFG, tc, tx, policy=T_FP32)
    for i in range(3):
        state, _ = step(state, frozen, _tb(_batch(seed=i)))
    tckpt.save_train_state(str(tmp_path / "s"), state, metadata={"iter": 1, "seed": 5})
    template, _, _ = teit.create_train_state(_t(_jax_params(seed=3, rank=2)), tc)
    back = tckpt.restore_train_state(str(tmp_path / "s"), template)
    assert back.step == 3 and back.opt_state["mini_step"] == 1 and back.opt_state["count"] == 1
    live, got = ({k: v for k, v in teit.flatten(st.__dict__).items() if torch.is_tensor(v)}
                 for st in (state, back))
    assert sorted(live) == sorted(got) and all(torch.equal(live[k], got[k]) for k in live)
    assert all(t.requires_grad for t in teit.flatten(back.trainable).values())
    assert json.loads((tmp_path / "s" / "metadata.json").read_text()) == {"iter": 1, "seed": 5}
    tckpt.save_params(str(tmp_path / "p"), params["projector"])
    zeros = {k: torch.zeros_like(v) for k, v in params["projector"].items()}
    again = tckpt.restore_params(str(tmp_path / "p"), zeros)
    assert all(torch.equal(again[k], params["projector"][k]) for k in zeros)


def test_recipe_and_throughput_match_jax():
    from callireader_tpu.configs import get_config as j_get_recipe

    assert t_get_recipe("e_it") == j_get_recipe("e_it")
    assert t_get_recipe("dpo_internlm2_7b") == j_get_recipe("dpo_internlm2_7b")
    with pytest.raises(ValueError):
        t_get_recipe("no_such_recipe")
    thr = tprof.TrainThroughput()
    stats = thr.step(100)
    assert thr.tokens == 100 and stats["tokens_per_sec"] > 0
    spans = tprof.Spans()
    with spans.span("step"):
        pass
    spans.add("step", 0.5)
    assert spans.counts["step"] == 2 and "step" in spans.report()


# ----------------------------------------------------------------------- (f) CLI


def _cli_data(root, n=2):
    rng = np.random.default_rng(0)
    ann = []
    for i in range(n):
        np.save(root / f"s{i}.npy", rng.integers(0, 255, (64, 48, 3), dtype=np.uint8))
        np.save(root / f"e{i}.npy", rng.standard_normal((2, 3, JCFG.llm.hidden_size),
                                                        dtype=np.float32))
        ann.append({"image": f"s{i}.npy", "embedding": f"e{i}.npy", "conversations": [
            {"from": "human", "value": "读出图中所有文字。"},
            {"from": "gpt", "value": "春眠不觉晓处处闻啼鸟"}]})
    (root / "ann.jsonl").write_text("".join(json.dumps(a, ensure_ascii=False) + "\n" for a in ann))
    return root / "ann.jsonl"


def _cli(root, out, *extra):
    argv = ["--data", str(root / "ann.jsonl"), "--image-root", str(root), "--out", str(out),
            "--config", "e_it", "--preset", "callireader-tiny", "--random-init", "--device", "cpu",
            "--lora-rank", "4", "--lora-alpha", "8", "--log-interval", "1", *extra]
    train_cli.main(argv)
    return [json.loads(line) for line in open(out / "train_log.jsonl")]


def test_train_cli_end_to_end_and_resume(tmp_path):
    """Two samples in one batch a step, accumulation 1, a high lr: the loss
    falls; checkpoints every 2 iterations keep one; a run resumed from
    iteration 4 takes iteration 5 exactly as the uninterrupted run did (same
    state, same data position)."""
    _cli_data(tmp_path)
    common = ("--max-iters", "5", "--grad-accum", "1", "--lr", "1e-2")
    recs = _cli(tmp_path, tmp_path / "a", *common, "--ckpt-interval", "2")
    assert [r["iter"] for r in recs] == [1, 2, 3, 4, 5]
    losses = [r["loss"] for r in recs]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0] - 0.05, losses
    assert (tmp_path / "a" / "iter_4" / "state.pt").exists() and not (tmp_path / "a" / "iter_2").exists()
    assert json.loads((tmp_path / "a" / "final" / "metadata.json").read_text()) == \
        {"iter": 5, "seed": 42}
    resumed = _cli(tmp_path, tmp_path / "b", *common, "--ckpt-interval", "0",
                   "--resume", str(tmp_path / "a" / "iter_4"))
    assert [r["iter"] for r in resumed] == [5]
    np.testing.assert_allclose(resumed[0]["loss"], recs[-1]["loss"], rtol=1e-5)
    np.testing.assert_allclose(resumed[0]["grad_norm"], recs[-1]["grad_norm"], rtol=1e-5)


def test_train_cli_qlora_cpu(tmp_path):
    _cli_data(tmp_path)
    recs = _cli(tmp_path, tmp_path / "q", "--max-iters", "2", "--qlora")
    assert len(recs) == 2 and np.all(np.isfinite([r["loss"] for r in recs]))
    state = torch.load(tmp_path / "q" / "final" / "state.pt", weights_only=True)
    lora = [v for k, v in state["tensors"].items() if k.startswith("trainable/") and "_lora_" in k]
    assert lora and all(v.dtype == torch.bfloat16 for v in lora)


def test_train_cli_eval_chat(tmp_path, capsys):
    """--eval-chat-interval 1: a sample answer after each update
    (tests/test_torch_agent_modes.py holds the answers against JAX's)."""
    _cli_data(tmp_path)
    capsys.readouterr()
    _cli(tmp_path, tmp_path / "c", "--max-iters", "2", "--grad-accum", "1",
         "--eval-chat-interval", "1")
    lines = [ln for ln in capsys.readouterr().err.splitlines() if ln.startswith("[eval-chat")]
    assert [ln.split("]")[0] for ln in lines] == ["[eval-chat @1", "[eval-chat @2"]


@pytest.mark.parametrize("extra", [
    (),  # without a checkpoint, --random-init is required
])
def test_train_cli_refuses_what_is_not_ported(extra):
    argv = ["--data", "x.jsonl", "--preset", "callireader-tiny", "--device", "cpu", *extra]
    with pytest.raises(SystemExit):
        train_cli.main(argv)
