"""The CalliAlign trainer of the port (train/callialign_train.py, its script
scripts/train_callialign.py, the seed-0 draws of runtime/weights.py and the
LoRA / remat / plain-attention arguments of models/internvit.py and
models/resampler.py) against the JAX package on the CPU, at the tiny preset.

Tolerances, each test stating its own:
  - the seed-0 helpers equal ``init_params``'s leaves bit for bit;
  - the data (glyphs, views, batches, the vocab) is byte-equal, Pillow's
    rotate, min / max filters and Gaussian blur included: 0 pixels off;
  - the forwards hold JAX's within 1e-5 relative L2 (float32), their grads
    within 1e-4; grads with remat equal those without bit for bit;
  - merges within 1e-6 relative L2 (the two einsums sum the rank in other
    orders); assets cross both ways bit for bit;
  - one step from the same trainable and batch: the loss within 1e-5
    relative, the accuracies equal, the updated trainable within 1e-5
    relative L2 over the tree and 2e-4 a leaf (Adam divides a gradient by its
    own size plus 1e-8, so a gradient near zero moves its update by
    the packages' summation-order differences); the eval functions' ids
    equal, their means equal;
  - the schedules equal optax's within 1e-6 relative or two float32 ulps of
    the peak rate.
"""

import dataclasses
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image, ImageFilter

from callireader_tpu.core.config import callireader_tiny as j_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.models import internvit as jvit
from callireader_tpu.models import resampler as jres
from callireader_tpu.runtime.tokenizer import InternLM2Tokenizer as JTok
from callireader_tpu.train import callialign_train as jca
from callireader_tpu_torch.core.config import ResamplerConfig, VisionConfig, callireader_tiny
from callireader_tpu_torch.core.config import get_config
from callireader_tpu_torch.core.dtypes import FP32_POLICY
from callireader_tpu_torch.models import internvit, resampler
from callireader_tpu_torch.runtime import weights
from callireader_tpu_torch.runtime.engine import CalliReaderEngine
from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer
from callireader_tpu_torch.runtime.weights import from_jax_params
from callireader_tpu_torch.scripts import train_callialign as script
from callireader_tpu_torch.train import callialign_train as ca
from callireader_tpu_torch.train import e_it
from callireader_tpu_torch.vision import resample as rs

REPO = Path(__file__).resolve().parents[1]
TINY = callireader_tiny()
JTINY = j_tiny()
REL = 1e-5
# a compact tower at test widths, projecting to the tiny LLM's hidden size
SMALL_V3 = dict(
    char_vision=VisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                             num_attention_heads=4, image_size=56, patch_size=14),
    resampler=ResamplerConfig(dim=32, depth=2, dim_head=8, heads=4, num_learns=3, ff_mult=2,
                              out_dim=64),
)
CLASSES = [11, 22, 33]  # token ids -> class indices 0, 1, 2 (the sub-table CE)
CHARS = "书法永"


def _j2t(tree):
    return from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _flat_np(tree):
    return {k: _np(v) for k, v in e_it.flatten(_as_torch(tree)).items()}


def _as_torch(tree):
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _assert_trees_close(got, want, leaf_rel, tree_rel=REL):
    g, w = _flat_np(got), _flat_np(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        assert _rel(g[k], w[k]) <= leaf_rel, (k, _rel(g[k], w[k]))
    assert _rel(np.concatenate([g[k].ravel() for k in w]),
                np.concatenate([w[k].ravel() for k in w])) <= tree_rel


def _assert_trees_equal(got, want):
    g, w = _flat_np(got), _flat_np(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].dtype == w[k].dtype and np.array_equal(g[k], w[k]), k


@pytest.fixture(scope="module")
def toks():
    return JTok(str(REPO / "callireader_tpu/assets/tokenizer.model")), InternLM2Tokenizer()


# ------------------------------------------------------------------ seed-0 draws


@pytest.mark.parametrize("variant", ["preset", "llm_deeper", "vit_deeper", "llm_int8"])
def test_seed0_helpers_equal_init_params(variant):
    """The trainer's seed-0 helpers draw the engine's leaves bit for bit, and
    the resampler and the VQ table stay those of the preset when the LLM or
    the tile tower is one layer deeper, or the LLM is drawn as int8."""
    cfg, int8 = TINY, variant == "llm_int8"
    if variant == "llm_deeper":
        cfg = dataclasses.replace(TINY, llm=dataclasses.replace(TINY.llm, num_hidden_layers=3))
    elif variant == "vit_deeper":
        cfg = dataclasses.replace(TINY, vision=dataclasses.replace(TINY.vision, num_hidden_layers=3))
    full = weights.init_params(cfg, 0, dtype=torch.bfloat16,
                               device="cpu", llm_int8=int8)
    res = ca.base_resampler_params(TINY.resampler, torch.bfloat16, "cpu")
    table = ca.align_table(TINY.llm.vocab_size, TINY.llm.hidden_size, torch.bfloat16, "cpu")
    _assert_trees_equal(full["resampler"], res)
    assert torch.equal(full["align"]["normed_emb"], table)
    _assert_trees_equal(full["vision"], ca.base_vision_params(cfg, torch.bfloat16, "cpu"))
    _assert_trees_equal(full["projector"], weights.draw_projector(cfg, 0, dtype=torch.bfloat16,
                                                                  device="cpu"))
    if variant == "llm_deeper":  # the tile tower is the preset's too
        _assert_trees_equal(full["vision"], ca.base_vision_params(TINY, torch.bfloat16, "cpu"))


def test_component_seeds_never_collide():
    """``draw_key`` is one to one over seeds, components, leaves and blocks,
    and every key fits the generator's uint64 seed."""
    seeds = {weights.component_generator(s, n, "cpu").initial_seed()
             for s in range(64) for n in weights.COMPONENT_SLOTS}
    assert len(seeds) == 64 * len(weights.COMPONENT_SLOTS)
    edges = (0, 1, weights.MAX_SEED - 1)
    keys = {weights.draw_key(s, n, leaf, block) for s in edges for n in weights.COMPONENT_SLOTS
            for leaf in (0, 1, weights.LEAF_SPAN - 1) for block in (0, 1, weights.BLOCK_SPAN - 1)}
    assert len(keys) == 3 * len(weights.COMPONENT_SLOTS) * 9 and max(keys) < 2**64
    with pytest.raises(ValueError, match="seed"):
        weights.component_generator(weights.MAX_SEED, "llm", "cpu")


# ------------------------------------------------------------------ models


def _vit_case():
    vcfg = JTINY.vision
    base = jca.base_vision_params(JTINY, jnp.float32)
    lora = jca.init_vit_lora(jax.random.PRNGKey(4), base["layers"], rank=4)
    lora = {k: v if k.endswith("_a") else jax.random.normal(jax.random.PRNGKey(6), v.shape) * 0.02
            for k, v in lora.items()}
    x = np.random.RandomState(0).randint(0, 256, (2, 56, 56, 3)).astype(np.uint8)
    return vcfg, base, lora, x


def test_vit_forward_lora_remat_matches_jax():
    """internvit.forward with lora, remat and the plain attention against the
    JAX forward (rel L2 1e-5), its grads against jax.grad's (1e-4); the grads
    with remat equal those without bit for bit."""
    vcfg, jbase, jlora, x = _vit_case()
    want = jvit.forward(jbase, vcfg, jnp.asarray(x), policy=J_FP32, use_flash=False, lora=jlora,
                        remat=True, attn_impl="reference")
    base, lora = _j2t(jbase), e_it.clone_tree(_j2t(jlora), True)
    tx = torch.from_numpy(x)
    got = internvit.forward(base, TINY.vision, tx, policy=FP32_POLICY, lora=lora, remat=True,
                            attn_impl="reference")
    assert _rel(got.detach().numpy(), want) <= REL
    wout = np.random.RandomState(1).randn(*want.shape).astype(np.float32)
    jgrad = jax.grad(lambda lo: jnp.sum(jvit.forward(
        jbase, vcfg, jnp.asarray(x), policy=J_FP32, use_flash=False, lora=lo, remat=True,
        attn_impl="reference") * wout))(jlora)

    def grads(remat):
        out = internvit.forward(base, TINY.vision, tx, policy=FP32_POLICY, lora=lora, remat=remat,
                                attn_impl="reference")
        g = torch.autograd.grad((out * torch.from_numpy(wout)).sum(), list(lora.values()))
        return dict(zip(lora, g))

    with_remat, without = grads(True), grads(False)
    for k in lora:
        assert torch.equal(with_remat[k], without[k]), k
        assert _rel(with_remat[k].numpy(), jgrad[k]) <= 1e-4, k
    # the defaults keep the inference forward as it was: no LoRA, the wrapper
    no_lora = internvit.forward(base, TINY.vision, tx, policy=FP32_POLICY)
    jno = jvit.forward(jbase, vcfg, jnp.asarray(x), policy=J_FP32, use_flash=False)
    assert _rel(no_lora.numpy(), jno) <= REL


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_resampler_forward_lora_matches_jax(policy):
    """resampler.forward with LoRA against the JAX forward: rel L2 1e-5 in
    float32, 1e-2 in bf16 (the two packages round other intermediates)."""
    cfg = JTINY.resampler
    base = jca.base_resampler_params(cfg, jnp.float32)
    lora = jca.init_lora(jax.random.PRNGKey(1), base["layers"], rank=4)
    lora = {k: v if k.endswith("_a") else jax.random.normal(jax.random.PRNGKey(3), v.shape) * 0.02
            for k, v in lora.items()}
    x = np.random.RandomState(2).randn(2, 16, cfg.dim).astype(np.float32)
    if policy == "fp32":
        jp, tp, tol = J_FP32, FP32_POLICY, REL
    else:
        from callireader_tpu.core.dtypes import DEFAULT_POLICY as jp
        from callireader_tpu_torch.core.dtypes import DEFAULT_POLICY as tp
        tol = 1e-2
    want = jres.forward(base, cfg, jnp.asarray(x), policy=jp, lora=lora)
    got = resampler.forward(_j2t(base), TINY.resampler, torch.from_numpy(x), policy=tp,
                            lora=_j2t(lora))
    assert _rel(got.float().numpy(), np.asarray(want, np.float32)) <= tol
    plain = resampler.forward(_j2t(base), TINY.resampler, torch.from_numpy(x), policy=FP32_POLICY)
    assert _rel(plain.numpy(), jres.forward(base, cfg, jnp.asarray(x), policy=J_FP32)) <= REL


# ------------------------------------------------------------------ data


def test_vocab_glyphs_batches_equal_jax(toks):
    jt, tt = toks
    vocab = ca.single_char_vocab(tt)
    assert vocab == jca.single_char_vocab(jt) and len(vocab) > 7000
    for ch in "书法一鿿":
        g = ca.glyph_for_char(ch)
        assert g.dtype == np.uint8 and np.array_equal(g, jca.glyph_for_char(ch))
    crops = [ca.glyph_for_char(ch)[: 30 + 9 * i] for i, ch in enumerate(CHARS)]
    for size in (448, 224, 56):
        for a, b in zip(ca.pack_raw_batch(crops, size), jca.pack_raw_batch(crops, size)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    tsamp = ca.BatchSampler(None, vocab[:40], np.random.RandomState(5))
    jsamp = jca.BatchSampler(None, vocab[:40], np.random.RandomState(5))
    for _ in range(2):
        for a, b in zip(tsamp.sample(6), jsamp.sample(6)):
            assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", range(6))
def test_augment_luma_equals_jax_pillow(case):
    """augment_luma against JAX's Pillow version with the same RandomState:
    the same views byte for byte over 40 crops (rotation, rescale, min / max
    filters and blur each taken many times: 0 pixels off, 0 grey levels),
    and the same next draw afterwards."""
    rng = np.random.RandomState(100 + case)
    rt, rj = np.random.RandomState(case), np.random.RandomState(case)
    strength = (1.0, 1.5, 0.5)[case % 3]
    for i in range(40):
        if i % 3:
            crop = ca.glyph_for_char(chr(0x4E00 + 97 * i + case))
        else:
            crop = rng.randint(0, 256, (rng.randint(12, 200), rng.randint(12, 200))).astype(np.uint8)
        box = None
        if case % 2:
            h, w = crop.shape
            box = (h // 8, w // 8, h - h // 8, w - w // 8)
        a = ca.augment_luma(crop, rt, box=box, strength=strength)
        b = jca.augment_luma(crop, rj, box=box, strength=strength)
        assert a.dtype == np.uint8 and a.shape == b.shape and np.array_equal(a, b), i
        assert max(a.shape) <= ca.RAW_BUCKET
    assert rt.rand() == rj.rand()


@pytest.mark.parametrize("op", ["rotate", "min", "max", "blur"])
def test_pillow_ops_byte_equal(op):
    """vision/resample's Pillow ops against Pillow on 60 random grey images
    (1-150 px a side, rotations in +-10 degrees, blur radii 0.3-3): 0 pixels
    off."""
    rng = np.random.RandomState(7)
    for _ in range(60):
        a = rng.randint(0, 256, (rng.randint(1, 150), rng.randint(1, 150))).astype(np.uint8)
        im = Image.fromarray(a)
        if op == "rotate":
            ang = rng.uniform(-10, 10)
            want = im.rotate(ang, resample=Image.BILINEAR, expand=True, fillcolor=255)
            got = rs.pil_rotate(a, ang, fillcolor=255)
        elif op == "blur":
            r = rng.uniform(0.3, 3.0)
            want, got = im.filter(ImageFilter.GaussianBlur(r)), rs.pil_gaussian_blur(a, r)
        else:
            f = ImageFilter.MinFilter(3) if op == "min" else ImageFilter.MaxFilter(3)
            want, got = im.filter(f), rs.pil_rank_filter(a, 3, op)
        want = np.asarray(want)
        assert got.dtype == np.uint8 and got.shape == want.shape and np.array_equal(got, want)


# ------------------------------------------------------------------ merges and assets


def _trained_jax(rank=4):
    """A v2 trained tree of the JAX package over its tiny seed-0 draws, with
    non-zero B factors."""
    rbase = jca.base_resampler_params(JTINY.resampler, jnp.float32)
    vbase = jca.base_vision_params(JTINY, jnp.float32)
    nz = lambda t, s: {k: v if k.endswith("_a") else  # noqa: E731
                       jax.random.normal(jax.random.PRNGKey(s), v.shape) * 0.02
                       for k, v in t.items()}
    trained = {
        "small": jca.small_leaves(rbase),
        "lora": nz(jca.init_lora(jax.random.PRNGKey(1), rbase["layers"], rank), 3),
        "vit_small": jca.vit_small_leaves(vbase),
        "vit_lora": nz(jca.init_vit_lora(jax.random.PRNGKey(4), vbase["layers"], rank), 6),
    }
    return rbase, vbase, trained


def test_merges_match_jax():
    """merge_full / merge_full_vision (and the small-leaf helpers) on a tree
    carried across: rel L2 1e-6 a leaf."""
    rbase, vbase, trained = _trained_jax()
    t = _j2t(trained)
    _assert_trees_close(ca.merge_full(_j2t(rbase), t, torch.float32),
                        jca.merge_full(rbase, trained, jnp.float32), 1e-6, 1e-6)
    _assert_trees_close(ca.merge_full_vision(_j2t(vbase), t, torch.float32, lora_scale=0.5),
                        jca.merge_full_vision(vbase, trained, jnp.float32, lora_scale=0.5),
                        1e-6, 1e-6)
    _assert_trees_equal(ca.small_leaves(_j2t(rbase)), jca.small_leaves(rbase))
    _assert_trees_equal(ca.vit_small_leaves(_j2t(vbase)), jca.vit_small_leaves(vbase))


@pytest.mark.parametrize("version,writer", [(2, "jax"), (2, "torch"), (3, "jax"), (3, "torch")])
def test_assets_cross_packages(tmp_path, version, writer):
    """A v2 or v3 asset written by one package reads in the other to the
    same leaves bit for bit (v2: fp16 LoRA, fp32 small leaves; v3: the fp16
    stack)."""
    path = str(tmp_path / "ca.npz")
    meta = {"rank": 4, "lora_scale": 1.0}
    if version == 2:
        _, _, trained = _trained_jax()
        (jca.save_asset if writer == "jax" else ca.save_asset)(
            path, jax.device_get(trained) if writer == "jax" else _j2t(trained), meta)
        got, gmeta = ca.load_asset(path, device="cpu")
        want, wmeta = jca.load_asset(path)
        assert ca.asset_version(path) == jca.asset_version(path) == 2
    else:
        cfg = dataclasses.replace(JTINY, **_jax_small_v3())
        stack = jca.init_v3_params(jax.random.PRNGKey(2), cfg)
        (jca.save_v3_asset if writer == "jax" else ca.save_v3_asset)(
            path, jax.device_get(stack) if writer == "jax" else _j2t(stack), meta)
        got, gmeta = ca.load_v3_asset(path, torch.float32, "cpu")
        want, wmeta = jca.load_v3_asset(path, jnp.float32)
        assert ca.asset_version(path) == 3
    assert gmeta == wmeta and gmeta["version"] == version
    _assert_trees_equal(got, want)


def _jax_small_v3():
    from callireader_tpu.core.config import ResamplerConfig as JRes
    from callireader_tpu.core.config import VisionConfig as JVis

    return dict(char_vision=JVis(**dataclasses.asdict(SMALL_V3["char_vision"])),
                resampler=JRes(**dataclasses.asdict(SMALL_V3["resampler"])))


def test_v2_asset_overlays_like_jax(tmp_path, monkeypatch):
    """overlay_trained_assets takes a v1 / v2 asset through apply_asset, as
    the JAX _overlay_trained_assets does: the merged resampler and char ViT
    over the port's seed-0 draws, the engine's char encode through
    ``char_vision`` and the tile encode through ``vision``. The tiny preset
    stands in for the 4096-wide one (its resampler is the default there)."""
    _, _, trained = _trained_jax()
    jca.save_asset(str(tmp_path / "callialign.npz"), jax.device_get(trained),
                   {"rank": 4, "lora_scale": 1.0})
    monkeypatch.setattr(weights, "ASSETS_DIR", tmp_path)
    monkeypatch.setattr(weights, "ResamplerConfig", lambda: TINY.resampler)
    cfg = dataclasses.replace(TINY, llm=dataclasses.replace(TINY.llm, hidden_size=4096))
    params = weights.init_params(TINY, 0, dtype=torch.float32,
                                 device="cpu")
    out_cfg, loaded = weights.overlay_trained_assets(params, cfg, dtype=torch.float32,
                                                     device="cpu", names=("callialign",))
    assert loaded == ["callialign"] and out_cfg == cfg
    t, _ = ca.load_asset(str(tmp_path / "callialign.npz"), device="cpu")
    _assert_trees_equal(params["resampler"], ca.merge_full(
        ca.base_resampler_params(TINY.resampler, torch.float32, "cpu"), t, torch.float32))
    _assert_trees_equal(params["char_vision"], ca.merge_full_vision(
        ca.base_vision_params(TINY, torch.float32, "cpu"), t, torch.float32))
    want = jca.apply_asset(JTINY, str(tmp_path / "callialign.npz"), jnp.float32)
    assert set(want) == {"resampler", "char_vision"}
    for k in want:
        assert sorted(e_it.flatten(params[k])) == sorted(_flat_np(want[k]))
    eng = CalliReaderEngine(TINY, params, None, device="cpu", policy=FP32_POLICY)
    x = torch.from_numpy(np.random.RandomState(0).randint(0, 256, (1, 56, 56, 3)).astype(np.uint8))
    chars = eng._char_encode(x)
    assert torch.equal(chars, eng._encode_tower(params["char_vision"], params["projector"],
                                                TINY.vision, x))
    assert not torch.equal(chars, eng._vision_encode(x))


# ------------------------------------------------------------------ steps


def _v2_case():
    frozen = jca.build_frozen(JTINY, jnp.float32, class_token_ids=CLASSES)
    base = jca.base_resampler_params(JTINY.resampler, jnp.float32)
    trainable = {
        "small": jca.small_leaves(base),
        "lora": jca.init_lora(jax.random.PRNGKey(1), base["layers"], rank=4),
        "vit_small": jca.vit_small_leaves(frozen["vision"]),
        "vit_lora": jca.init_vit_lora(jax.random.PRNGKey(2), frozen["vision"]["layers"], rank=4),
        "logit_scale": jnp.asarray(np.log(1 / 0.07), jnp.float32),
        "aux": jca.init_aux_head(jax.random.PRNGKey(3), JTINY, len(CLASSES)),
    }
    crops = [ca.glyph_for_char(ch) for ch in CHARS]
    raw, src, tgt = ca.pack_raw_batch(crops, input_size=TINY.force_image_size)
    return frozen, base, trainable, (raw, src, tgt, np.arange(len(CLASSES), dtype=np.int32))


def _v3_case():
    jcfg = dataclasses.replace(JTINY, **_jax_small_v3())
    tcfg = dataclasses.replace(TINY, **SMALL_V3)
    trainable = {
        "stack": jca.init_v3_params(jax.random.PRNGKey(5), jcfg),
        "logit_scale": jnp.asarray(np.log(1 / 0.07), jnp.float32),
        "aux": jca.init_aux_head(jax.random.PRNGKey(6), jcfg, len(CLASSES),
                                 dim=jcfg.resampler.dim),
    }
    frozen = jca.build_v3_frozen(jcfg, class_token_ids=CLASSES)
    crops = [ca.glyph_for_char(ch)[4:60, 2:70] for ch in CHARS]
    raw, src, tgt = ca.pack_raw_batch(crops, input_size=56)
    return jcfg, tcfg, frozen, trainable, (raw, src, tgt, np.arange(len(CLASSES), dtype=np.int32))


def _check_step(tout, jout):
    (ttrain, _, tl, tacc, taux), (jtrain, _, jl, jacc, jaux) = tout, jout
    assert abs(float(tl) - float(jl)) <= REL * abs(float(jl))
    assert float(tacc) == float(jacc) and float(taux) == float(jaux)
    _assert_trees_close(ttrain, jtrain, leaf_rel=2e-4)


def test_v2_step_matches_jax():
    """One make_step_fn step from the same trainable, frozen tree and batch
    as JAX's (optax.adam(3e-3) against the port's Optimizer at a constant
    3e-3)."""
    frozen, base, trainable, batch = _v2_case()
    # carried across before the JAX step donates the trainable (whose float32
    # small leaves are the frozen tree's own arrays)
    ttrain = e_it.clone_tree(_j2t(trainable), True)
    tfrozen, tbase = _j2t(frozen), _j2t(base)
    jstep = jca.make_step_fn(JTINY, 56, J_FP32, optax.adam(3e-3), use_flash=False)
    jout = jstep(trainable, optax.adam(3e-3).init(trainable), frozen, base,
                 tuple(jnp.asarray(a) for a in batch))
    tx = e_it.Optimizer(lambda count: 3e-3)
    tstep = ca.make_step_fn(TINY, 56, FP32_POLICY, tx)
    tout = tstep(ttrain, tx.init(e_it.flatten(ttrain)), tfrozen, tbase,
                 tuple(torch.from_numpy(a) for a in batch))
    assert tout[0] is ttrain  # updated in place
    _check_step(tout, jout)


def test_v3_step_matches_jax():
    jcfg, tcfg, frozen, trainable, batch = _v3_case()
    ttrain = e_it.clone_tree(_j2t(trainable), True)
    jstep = jca.make_v3_step_fn(jcfg, J_FP32, optax.adam(3e-3))
    jout = jstep(trainable, optax.adam(3e-3).init(trainable), frozen,
                 tuple(jnp.asarray(a) for a in batch))
    tx = e_it.Optimizer(lambda count: 3e-3)
    tout = ca.make_v3_step_fn(tcfg, FP32_POLICY, tx)(
        ttrain, tx.init(e_it.flatten(ttrain)), _j2t(frozen),
        tuple(torch.from_numpy(a) for a in batch))
    _check_step(tout, jout)


def test_eval_fns_match_jax():
    """Both eval functions' per_tok, per_char and ids against JAX's over the
    full 92554-row table."""
    frozen, base, trainable, (raw, src, tgt, labels) = _v2_case()
    labels = np.asarray(CLASSES, np.int32)
    jout = jca.make_eval_fn(JTINY, 56, J_FP32, use_flash=False)(
        trainable, frozen, base, *(jnp.asarray(a) for a in (raw, src, tgt, labels)))
    tout = ca.make_eval_fn(TINY, 56, FP32_POLICY)(
        _j2t(trainable), _j2t(frozen), _j2t(base),
        *(torch.from_numpy(a) for a in (raw, src, tgt, labels)))
    jcfg, tcfg, vfrozen, vtrain, (vraw, vsrc, vtgt, _) = _v3_case()
    jv = jca.make_v3_eval_fn(jcfg, J_FP32)(vtrain["stack"], vfrozen["table_n"],
                                            *(jnp.asarray(a) for a in (vraw, vsrc, vtgt, labels)))
    tv = ca.make_v3_eval_fn(tcfg, FP32_POLICY)(
        _j2t(vtrain["stack"]), _j2t(vfrozen["table_n"]),
        *(torch.from_numpy(a) for a in (vraw, vsrc, vtgt, labels)))
    for t, j in ((tout, jout), (tv, jv)):
        assert float(t[0]) == float(j[0]) and float(t[1]) == float(j[1])
        assert np.array_equal(t[2].numpy(), np.asarray(j[2]))


def test_tiny_two_class_run_learns():
    """The JAX test_train_step_learns_tiny on the port: 100 steps of the v2
    step on two glyphs drive the InfoNCE loss below a tenth of the first and
    both accuracies to 1, starting from the port's own seed-0 draws."""
    frozen = ca.build_frozen(TINY, torch.float32, class_token_ids=[11, 22], device="cpu")
    base = ca.base_resampler_params(TINY.resampler, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(1)
    trainable = {
        "small": ca.small_leaves(base),
        "lora": ca.init_lora(gen, base["layers"], rank=4),
        "vit_small": ca.vit_small_leaves(frozen["vision"]),
        "vit_lora": ca.init_vit_lora(gen, frozen["vision"]["layers"], rank=4),
        "logit_scale": torch.tensor(np.log(1 / 0.07), dtype=torch.float32),
        "aux": ca.init_aux_head(gen, TINY, 2, device="cpu"),
    }
    tx = e_it.Optimizer(lambda count: 3e-3)
    opt = tx.init(e_it.flatten(trainable))
    step = ca.make_step_fn(TINY, 56, FP32_POLICY, tx)
    raw, src, tgt = ca.pack_raw_batch([ca.glyph_for_char("书"), ca.glyph_for_char("法")],
                                      input_size=56)
    batch = tuple(torch.from_numpy(a) for a in (raw, src, tgt, np.asarray([0, 1], np.int32)))
    first = None
    for _ in range(100):
        trainable, opt, loss, acc, aux_acc = step(trainable, opt, frozen, base, batch)
        first = float(loss) if first is None else first
    assert float(loss) < first * 0.1
    assert float(acc) == 1.0 and float(aux_acc) == 1.0


@pytest.mark.parametrize("steps,warmup,lr", [(6000, 300, 2e-3), (40, 4, 2e-3), (2, 1, 1e-3)])
def test_v3_schedule_equals_optax(steps, warmup, lr):
    got = ca.v3_optimizer(lr, steps, warmup, 1e-4).schedule
    want = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1), lr * 0.05)
    for count in range(steps + 5):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6, atol=2 ** -22 * lr)
    legacy = e_it.warmup_cosine_schedule(lr, warmup, max(steps, warmup + 1))
    zero_end = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    assert all(abs(legacy(c) - float(zero_end(c))) <= 2 ** -22 * lr for c in range(steps + 5))


# ------------------------------------------------------------------ the script


def test_script_main_raises_without_the_fixture(toks):
    """main and the fixture readers name the absent page."""
    assert not ca.FIXTURE_IMG.exists()
    with pytest.raises(FileNotFoundError, match="examples/0.jpg"):
        script.main(["--device", "cpu", "--steps", "1"])
    for read in (ca.fixture_samples, lambda t: ca.fixture_detector_samples(t, device="cpu")):
        with pytest.raises(FileNotFoundError, match="examples/0.jpg"):
            read(toks[1])


def test_script_loop_writes_an_asset_overlay_reads(tmp_path, monkeypatch, toks, capsys):
    """The script's glyph-only loop at tiny arguments (a compact tower at
    test widths): the [step]-free run prints its [eval], [ckpt] and [done]
    lines and writes a v3 asset whose stack overlay_trained_assets puts over
    the 2b preset, fp16-rounded bit for bit, with the asset's architecture."""
    _, tok = toks
    out = tmp_path / "callialign.npz"
    args = script.parse_args(["--steps", "3", "--batch", "4", "--synth-chars", "3",
                              "--synth-views", "2", "--fixed-views", "2", "--eval-every", "2",
                              "--out", str(out), "--device", "cpu"])
    cfg = dataclasses.replace(TINY, **SMALL_V3)
    data = script.build_data(args, tok, 56, [], [])
    assert sorted(data.eval_sets) == ["synth"] and len(data.pool[0]) == 6
    res = script.train_loop(args, cfg, data, torch.device("cpu"))
    printed = capsys.readouterr().out
    assert "[eval 2]" in printed and "[eval 3]" in printed and "[ckpt] saved" in printed
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    monkeypatch.setattr(weights, "ASSETS_DIR", tmp_path)
    params = {}
    got_cfg, loaded = weights.overlay_trained_assets(params, get_config("callireader-2b"),
                                                     dtype=torch.float32, device="cpu",
                                                     names=("callialign",))
    assert loaded == ["callialign"]
    assert got_cfg.char_vision == cfg.char_vision and got_cfg.resampler == cfg.resampler
    want = {k: v.detach().half().float() for k, v in e_it.flatten(res["trainable"]["stack"]).items()}
    got = e_it.flatten(params)
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want)
    shutil.rmtree(tmp_path, ignore_errors=True)
