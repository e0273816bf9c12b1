"""The port's library models, models/llava.py and models/moe.py, with
train/moe_io.py, against the JAX package on the CPU at small sizes, from the
same parameters (``from_jax_params``) in fp32.

Tolerances: the splice, labels and mask equal JAX's exactly (the image rows
are the features themselves); losses, logits, router probabilities, the aux
loss and every grad leaf within 1e-5 relative (L2 over the tensor) of the
JAX value; the top-k routing indices equal. moe_io's round trips are bit
exact in both directions between the packages. The port's own inits hold
the JAX tree, shapes, dtypes and N(0, 0.02) statistics.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.models import llava as jllava
from callireader_tpu.models import moe as jmoe
from callireader_tpu.train import moe_io as jio
from callireader_tpu_torch.core.config import callireader_tiny as t_tiny
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.models import llava as tllava
from callireader_tpu_torch.models import moe as tmoe
from callireader_tpu_torch.runtime.weights import from_jax_params
from callireader_tpu_torch.train import moe_io as tio

REL = 1e-5


def _small(cfg):
    return dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, vocab_size=512))


JCFG, TCFG = _small(callireader_tiny()), _small(t_tiny())


def _t(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _ids(B, S, vocab, positions, seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, (B, S)).astype(np.int32)
    for b, p in enumerate(positions):
        ids[b, p] = jllava.IMAGE_TOKEN_INDEX
    labels = rng.randint(0, vocab, (B, S)).astype(np.int32)
    labels[:, :2] = -100
    return ids, labels


# ------------------------------------------------------------------ llava


@pytest.fixture(scope="module")
def llava_params():
    return jllava.init_llava_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)


def test_splice_labels_and_mask_equal_jax(llava_params):
    B, S, n_patch = 3, 7, 5
    ids, labels = _ids(B, S, JCFG.llm.vocab_size, (2, 0, 6))
    ids[2, 3] = jllava.IMAGE_TOKEN_INDEX  # a second placeholder: the first one counts
    feats = np.random.RandomState(1).standard_normal((B, n_patch, JCFG.llm.hidden_size)).astype(
        np.float32)
    want = jllava.prepare_inputs_labels_for_multimodal(
        llava_params["llm"], JCFG.llm, jnp.asarray(ids), jnp.asarray(feats), jnp.asarray(labels),
        compute_dtype=jnp.float32)
    got = tllava.prepare_inputs_labels_for_multimodal(
        _t(llava_params["llm"]), TCFG.llm, torch.from_numpy(ids), torch.from_numpy(feats),
        torch.from_numpy(labels), compute_dtype=torch.float32)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (B, S - 1 + n_patch, JCFG.llm.hidden_size)
    assert tllava.prepare_inputs_labels_for_multimodal(
        _t(llava_params["llm"]), TCFG.llm, torch.from_numpy(ids), torch.from_numpy(feats),
        compute_dtype=torch.float32)[1] is None


@pytest.mark.parametrize("select", ["patch", "cls_patch"])
def test_project_and_select_equal_jax(llava_params, select):
    hidden = np.random.RandomState(2).standard_normal((2, 17, JCFG.vision.hidden_size)).astype(
        np.float32)
    want = jllava.project(llava_params["projector"], jllava.select_features(jnp.asarray(hidden),
                                                                            select))
    got = tllava.project(_t(llava_params["projector"]),
                         tllava.select_features(torch.from_numpy(hidden), select))
    assert _rel(got.numpy(), want) <= REL


@pytest.mark.parametrize("freeze_vit", [True, False])
def test_llava_loss_and_grads_equal_jax(llava_params, freeze_vit):
    B, S = 2, 9
    ids, labels = _ids(B, S, JCFG.llm.vocab_size, (3, 1), seed=3)
    px = np.random.RandomState(4).randint(0, 256, (B, JCFG.vision.image_size,
                                                   JCFG.vision.image_size, 3)).astype(np.uint8)
    train = ("projector", "llm") if freeze_vit else ("projector", "llm", "vit")

    def jloss(p):
        full = {**llava_params, **p}
        return jllava.llava_loss(full, JCFG, jnp.asarray(px), jnp.asarray(ids), jnp.asarray(labels),
                                 policy=J_FP32, freeze_vit=freeze_vit, use_flash=False)

    jl, jg = jax.value_and_grad(jloss)({k: llava_params[k] for k in train})
    tparams = _t(llava_params)
    leaves = {}
    for name in train:
        flat, _ = jax.tree_util.tree_flatten_with_path(jg[name])
        for path, _ in flat:
            node = tparams[name]
            for k in path:
                node = node[k.key if hasattr(k, "key") else k.idx]
            node.requires_grad_(True)
            leaves[(name,) + tuple(path)] = (node, _)
    tl = tllava.llava_loss(tparams, TCFG, torch.from_numpy(px), torch.from_numpy(ids),
                           torch.from_numpy(labels), policy=T_FP32, freeze_vit=freeze_vit)
    grads = torch.autograd.grad(tl, [n for n, _ in leaves.values()])
    assert abs(float(tl.detach()) - float(jl)) <= REL * abs(float(jl))
    for (key, (_, want)), g in zip(leaves.items(), grads):
        assert _rel(g.numpy(), want) <= REL, key


def test_llava_init_holds_the_jax_tree(llava_params):
    got = tllava.init_llava_params(TCFG, torch.Generator().manual_seed(0), dtype=torch.float32,
                                   device="cpu")
    want = jax.tree_util.tree_map(np.asarray, llava_params)
    jflat, jdef = jax.tree_util.tree_flatten(want)
    tflat, tdef = jax.tree_util.tree_flatten(got)
    assert tdef == jdef
    for g, w in zip(tflat, jflat):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
    for layer in got["projector"]["layers"]:
        assert abs(float(layer["kernel"].std()) - 0.02) < 2e-3
        assert not layer["bias"].any()
    bf = tllava.init_projector(torch.Generator().manual_seed(1), 8, 16, 3, device="cpu")
    assert [tuple(l["kernel"].shape) for l in bf["layers"]] == [(8, 16), (16, 16), (16, 16)]
    assert bf["layers"][0]["kernel"].dtype == torch.bfloat16


# ------------------------------------------------------------------ moe


@pytest.fixture(scope="module")
def moe_params():
    return jmoe.init_params(jax.random.PRNGKey(0), jmoe.moe_tiny(), jnp.float32)


def _layer0(params):
    return {k: v[0] for k, v in params["layers"].items()}


def test_moe_mlp_and_routing_equal_jax(moe_params):
    jcfg, tcfg = jmoe.moe_tiny(), tmoe.moe_tiny()
    x = np.random.RandomState(5).standard_normal((2, 8, jcfg.llm.hidden_size)).astype(np.float32)
    jout, jprobs = jmoe._moe_mlp(_layer0(moe_params), jnp.asarray(x), jcfg, J_FP32)
    tout, tprobs = tmoe._moe_mlp(_layer0(_t(moe_params)), torch.from_numpy(x), tcfg, T_FP32)
    assert _rel(tout.numpy(), jout) <= REL and _rel(tprobs.numpy(), jprobs) <= REL
    _, jidx = jax.lax.top_k(jprobs, jcfg.num_experts_per_tok)
    _, tidx = torch.topk(tprobs, tcfg.num_experts_per_tok, dim=-1)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


@pytest.mark.parametrize("use_flash", [None, False])
@pytest.mark.parametrize("segments", [False, True])
def test_moe_forward_and_aux_equal_jax(moe_params, use_flash, segments):
    jcfg, tcfg = jmoe.moe_tiny(), tmoe.moe_tiny()
    ids = np.random.RandomState(6).randint(0, jcfg.llm.vocab_size, (2, 16)).astype(np.int32)
    seg = np.array([[0] * 9 + [1] * 7, [0] * 16], np.int32) if segments else None
    jl, jaux = jmoe.forward(moe_params, jcfg, input_ids=jnp.asarray(ids),
                            segment_ids=None if seg is None else jnp.asarray(seg),
                            policy=J_FP32, use_flash=False, return_aux_loss=True)
    tl, taux = tmoe.forward(_t(moe_params), tcfg, input_ids=torch.from_numpy(ids),
                            segment_ids=None if seg is None else torch.from_numpy(seg),
                            policy=T_FP32, use_flash=use_flash, return_aux_loss=True)
    assert tl.shape == (2, 16, jcfg.llm.vocab_size)
    assert _rel(tl.numpy(), jl) <= REL
    assert abs(float(taux) - float(jaux)) <= REL * abs(float(jaux))
    no_aux = tmoe.forward(_t(moe_params), tcfg, input_ids=torch.from_numpy(ids),
                          segment_ids=None if seg is None else torch.from_numpy(seg),
                          policy=T_FP32, use_flash=use_flash)
    assert torch.equal(no_aux, tl)


def test_moe_single_expert_equals_dense_swiglu():
    cfg = dataclasses.replace(tmoe.moe_tiny(), num_experts=1, num_experts_per_tok=1)
    params = tmoe.init_params(cfg, torch.Generator().manual_seed(0), torch.float32, device="cpu")
    x = torch.randn((1, 4, cfg.llm.hidden_size), generator=torch.Generator().manual_seed(2))
    p0 = _layer0(params)
    out, probs = tmoe._moe_mlp(p0, x, cfg, T_FP32)
    from callireader_tpu_torch.models.internlm2 import rms_norm

    h = rms_norm(x, p0["ffn_norm"], cfg.llm.rms_norm_eps, T_FP32)
    dense = x + (torch.nn.functional.silu(h @ p0["w1"][0]) * (h @ p0["w3"][0])) @ p0["w2"][0]
    torch.testing.assert_close(out, dense, atol=1e-5, rtol=0)
    torch.testing.assert_close(probs, torch.ones_like(probs), atol=1e-6, rtol=0)


def test_moe_aux_loss_and_init():
    cfg = tmoe.moe_tiny()
    X = cfg.num_experts
    probs = torch.eye(X).repeat(8, 1)
    assert abs(float(tmoe.load_balancing_loss(probs, cfg)) - 1.0) < 1e-6
    rnd = torch.softmax(torch.randn(64, X, generator=torch.Generator().manual_seed(3)), -1)
    want = jmoe.load_balancing_loss(jnp.asarray(rnd.numpy()), jmoe.moe_tiny())
    assert abs(float(tmoe.load_balancing_loss(rnd, cfg)) - float(want)) <= REL * float(want)
    got = tmoe.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = jmoe.init_params(jax.random.PRNGKey(0), jmoe.moe_tiny())
    jflat, jdef = jax.tree_util.tree_flatten(want)
    tflat, tdef = jax.tree_util.tree_flatten(got)
    assert tdef == jdef
    for g, w in zip(tflat, jflat):
        assert tuple(g.shape) == w.shape and g.dtype == torch.bfloat16
    assert abs(float(got["layers"]["w1"].float().std()) - 0.02) < 1e-3
    assert torch.equal(got["norm"], torch.ones_like(got["norm"]))


def test_moe_io_round_trips_cross_the_packages_bit_exact(moe_params, tmp_path):
    cfg, jcfg = tmoe.moe_tiny(), jmoe.moe_tiny()
    tparams = _t(moe_params)
    jsd = jio.moe_to_hf_experts(moe_params, jcfg)
    tsd = tio.moe_to_hf_experts(tparams, cfg)
    assert sorted(tsd) == sorted(jsd)
    for k in jsd:
        np.testing.assert_array_equal(tsd[k], np.asarray(jsd[k]))
    for n in (1, 2, 4):
        jm, tm = jio.merge_expert_shards(jsd, n), tio.merge_expert_shards(tsd, n)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_array_equal(tm[k], jm[k])
        # each package splits what the other merged
        for back in (tio.split_expert_shards(jm, n), jio.split_expert_shards(tm, n)):
            for k in jsd:
                np.testing.assert_array_equal(back[k], np.asarray(jsd[k]))
    for leaves in (tio.hf_experts_to_moe(jsd, cfg), jio.hf_experts_to_moe(tsd, jcfg)):
        for name in ("w1", "w3", "w2", "router"):
            np.testing.assert_array_equal(leaves[name], np.asarray(moe_params["layers"][name]))
    with pytest.raises(ValueError):
        tio.merge_expert_shards(tsd, 3)
    tio.save_sharded(str(tmp_path / "moe"), tparams)
    template = jax.tree_util.tree_map(lambda t: torch.zeros_like(t, dtype=torch.bfloat16), tparams)
    restored = tio.restore_sharded(str(tmp_path / "moe"), template)
    assert restored["layers"]["w1"].dtype == torch.bfloat16
    torch.testing.assert_close(restored["layers"]["w1"],
                               tparams["layers"]["w1"].to(torch.bfloat16), atol=0, rtol=0)
