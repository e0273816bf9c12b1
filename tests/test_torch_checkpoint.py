"""Reference-checkpoint I/O of the port against the JAX package and the
``safetensors`` library on the CPU, at the tiny preset.

- runtime/safetensors_io.py against the library, both ways, for every dtype
  it covers (with a ``__metadata__`` header, a 0-d and an empty tensor);
- runtime/weights.convert_reference_checkpoint on a JAX export of an fp32
  tree (values not bf16-exact), and on its BF16 copy, against
  ``from_jax_params`` of the JAX converter's output;
- runtime/detector_weights.convert_yolov8 on an ultralytics dict with
  random BatchNorm statistics;
- train/checkpoint's export against the JAX export of the same tree (the
  same files, weight map and tensors; plain, LoRA and int8 QLoRA trees), and
  read back by the JAX converter;
- cli/common.build_engine(checkpoint_dir=...) against the JAX build_engine and
  engine (batch_chat_ocr token ids, bf16 and int8; the components drawn at
  random and the assets overlaid), cli/convert.py, cli.train's
  ``export_official`` and ``--checkpoint`` / ``--no-trained-assets`` on
  every CLI.

Every comparison of weights is bit-exact (tolerance 0 on every leaf); token
ids must be equal. The engines compare under the fp32 compute policy (bf16
weights, fp32 arithmetic: the argmax of the logits does not hang on the
accumulation order of bf16 products). LoRA adapters are drawn on a dyadic
grid small enough that every product and sum of the merge is exact in fp32,
so that XLA's and torch's summation orders give the same bits.
"""

import dataclasses
import functools
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from callireader_tpu.cli import common as jcommon
from callireader_tpu.core import config as jconfig
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.runtime import detector_weights as jdet
from callireader_tpu.runtime import quantize as jq
from callireader_tpu.runtime import weights as jw
from callireader_tpu.runtime.engine import init_all_params
from callireader_tpu.train import checkpoint as jckpt
from callireader_tpu_torch.cli import chat as tchat
from callireader_tpu_torch.cli import common as tcommon
from callireader_tpu_torch.cli import convert as tconvert
from callireader_tpu_torch.cli import get_embeddings as tget
from callireader_tpu_torch.cli import inference as tinf
from callireader_tpu_torch.cli import serve as tserve
from callireader_tpu_torch.cli import train as ttrain
from callireader_tpu_torch.core import config as tconfig
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.runtime import detector_weights as tdet
from callireader_tpu_torch.runtime import safetensors_io as sio
from callireader_tpu_torch.runtime import weights as tw
from callireader_tpu_torch.train import checkpoint as tckpt
from callireader_tpu_torch.train import e_it

REPO = Path(__file__).resolve().parents[1]
PRESET = "callireader-tiny"
CFG, TCFG = jconfig.callireader_tiny(), tconfig.callireader_tiny()
SHARD = 1 << 21  # small enough that the tiny export spans several shards
QUESTIONS = ["读出图中所有文字。", "这幅书法作品内容是什么？"]
LORA_RANK, LORA_ALPHA = 4, 8.0
LORA_TARGETS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")


def _flat(tree):
    return e_it.flatten(tree)


def _t(tree):
    return tw.from_jax_params(jax.tree_util.tree_map(np.asarray, tree), device="cpu")


def assert_trees_equal(got, want):
    """Two trees of torch tensors: the same leaves, each of the same dtype,
    shape and bits."""
    fg, fw = _flat(got), _flat(want)
    assert sorted(fg) == sorted(fw)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype and fg[k].shape == fw[k].shape, k
        assert torch.equal(fg[k], fw[k]), k


def _load_any(path):
    """A shard (by the library) or a torch side file -> {name: tensor}."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return obj["model"] if path.endswith("best.pt") else obj


def assert_dirs_equal(got_dir, want_dir):
    """Two exported directories: the same files, the same index, and equal
    tensors (dtype, shape, bits) in every shard and side file."""
    rel = lambda d: sorted(str(p.relative_to(d)) for p in Path(d).rglob("*") if p.is_file())
    assert rel(got_dir) == rel(want_dir)
    for name in rel(want_dir):
        g, w = os.path.join(got_dir, name), os.path.join(want_dir, name)
        if name.endswith(".json"):
            assert json.load(open(g)) == json.load(open(w)), name
            continue
        tg, tw_ = _load_any(g), _load_any(w)
        assert sorted(tg) == sorted(tw_), name
        for k in tw_:
            assert tg[k].dtype == tw_[k].dtype and tg[k].shape == tw_[k].shape, (name, k)
            assert torch.equal(tg[k], tw_[k]), (name, k)


# ------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def jtree():
    """The JAX tiny tree in fp32 (values not bf16-exact)."""
    return init_all_params(jax.random.PRNGKey(3), CFG, dtype=jnp.float32)


@pytest.fixture(scope="module")
def ckpt(jtree, tmp_path_factory):
    """A complete reference checkpoint of ``jtree`` written by the JAX
    package, over several shards."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    jckpt.export_full_reference_checkpoint(jtree, CFG, d, max_shard_bytes=SHARD)
    return d


@pytest.fixture(scope="module")
def ckpt_bf16(ckpt, tmp_path_factory):
    """Its BF16 copy (JAX consolidate_safetensors_dtype), side files beside."""
    d = str(tmp_path_factory.mktemp("jax_ckpt_bf16"))
    jckpt.consolidate_safetensors_dtype(ckpt, d, dtype="bfloat16", max_shard_bytes=SHARD)
    shutil.copytree(os.path.join(ckpt, "params"), os.path.join(d, "params"))
    return d


def _dyadic_lora(layers_shapes, seed):
    """LoRA leaves (numpy fp32) on the grid k / 64, |k| <= 8: the merge's
    products and sums are exact in fp32."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in LORA_TARGETS:
        L, d_in, d_out = layers_shapes[name]
        out[f"{name}_lora_a"] = rng.integers(-8, 9, (L, d_in, LORA_RANK)).astype(np.float32) / 64
        out[f"{name}_lora_b"] = rng.integers(-8, 9, (L, LORA_RANK, d_out)).astype(np.float32) / 64
    out["lora_scale"] = np.full((L,), LORA_ALPHA / LORA_RANK, np.float32)
    return out


def _with_lora(jtree, kind):
    """(JAX tree, port tree): ``jtree`` plain, with fp32 LoRA leaves, or with
    an int8 base (the JAX quantizer) under bf16 LoRA leaves (QLoRA)."""
    tree = jax.tree_util.tree_map(np.asarray, jtree)
    if kind == "plain":
        return tree, _t(tree)
    llm = dict(tree["llm"])
    shapes = {n: llm["layers"][n].shape for n in LORA_TARGETS}
    lora = _dyadic_lora(shapes, seed=1)
    if kind == "qlora":
        llm = jax.tree_util.tree_map(np.asarray, jq.quantize_llm_int8(llm))
        lora = {k: v.astype(jnp.bfloat16) for k, v in lora.items()}
    llm["layers"] = {**llm["layers"], **lora}
    tree = {**tree, "llm": llm}
    return tree, _t(tree)


# ------------------------------------------------------------ safetensors_io

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I8": torch.int8,
    "I32": torch.int32, "I64": torch.int64, "U8": torch.uint8, "BOOL": torch.bool,
}


def _tensors(dtype, seed=0):
    g = torch.Generator().manual_seed(seed)

    def draw(shape):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g).to(dtype)
        if dtype == torch.bool:
            return torch.randint(0, 2, shape, generator=g).bool()
        lo, hi = (0, 256) if dtype == torch.uint8 else (-100, 100)
        return torch.randint(lo, hi, shape, generator=g).to(dtype)

    return {"matrix": draw((5, 7)), "scalar": draw(()), "empty": draw((0, 3)),
            "vector": draw((11,))}


@pytest.mark.parametrize("direction", ["library->port", "port->library"])
@pytest.mark.parametrize("fmt", list(DTYPES))
def test_safetensors_io_against_library(tmp_path, fmt, direction):
    st = pytest.importorskip("safetensors.torch")
    from safetensors import safe_open

    tensors = _tensors(DTYPES[fmt], seed=len(fmt))
    meta = {"format": "pt", "note": fmt}
    path = str(tmp_path / "x.safetensors")
    if direction == "library->port":
        st.save_file(tensors, path, metadata=meta)
        got = sio.load_file(path)
        assert sio.read_metadata(path) == meta
    else:
        sio.save_file(tensors, path, metadata=meta)
        got = st.load_file(path)
        with safe_open(path, framework="pt") as f:
            assert f.metadata() == meta
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape and torch.equal(got[k], v), k
    raw = open(path, "rb").read()
    assert (8 + int.from_bytes(raw[:8], "little")) % 8 == 0  # header padded to 8 bytes


def test_safetensors_io_unaligned_and_sharded(tmp_path):
    """A tensor whose bytes do not start at a multiple of its width (the
    writer keeps the given order) reads back equal in both readers; a capped
    set splits where the JAX exporter splits, with its index; an index that
    names a missing tensor raises."""
    st = pytest.importorskip("safetensors.torch")
    tensors = {"a": torch.arange(3, dtype=torch.int8), "b": torch.randn(4, 5),
               "c": torch.randn(6).bfloat16()}
    sio.save_file(tensors, str(tmp_path / "u.safetensors"))
    for got in (sio.load_file(str(tmp_path / "u.safetensors")),
                st.load_file(str(tmp_path / "u.safetensors"))):
        assert all(torch.equal(got[k], v) for k, v in tensors.items())

    entries = [sio.Entry.of(f"t{i}", torch.full((n,), float(i))) for i, n in
               enumerate((100, 300, 50, 400, 10))]
    files = sio.write_sharded(str(tmp_path / "s"), entries, max_shard_bytes=1600)
    index = json.load(open(tmp_path / "s" / sio.INDEX_FILE))
    shard = [f"model-0000{i}-of-00004.safetensors" for i in (1, 2, 3, 4)]
    assert [os.path.basename(f) for f in files] == shard
    assert index == {"metadata": {"total_size": 4 * 860}, "weight_map": {
        "t0": shard[0], "t1": shard[0], "t2": shard[1], "t3": shard[2], "t4": shard[3]}}
    loaded = tw.load_safetensors_dir(str(tmp_path / "s"))
    assert all(torch.equal(loaded[f"t{i}"], e.make()) for i, e in enumerate(entries))
    index["weight_map"]["t5"] = shard[3]
    json.dump(index, open(tmp_path / "s" / sio.INDEX_FILE, "w"))
    with pytest.raises(KeyError, match="t5"):
        tw.load_safetensors_dir(str(tmp_path / "s"))


# ------------------------------------------------------------ loading


@pytest.mark.parametrize("stored", ["fp32", "bf16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["to_fp32", "to_bf16"])
def test_convert_reference_checkpoint_matches_jax(request, stored, dtype):
    """Every component of the port's conversion is bit-equal to the JAX
    converter's output, from the fp32 export and from its BF16 copy, cast to
    fp32 or bf16 (the detector and OrderFormer stay fp32)."""
    d = request.getfixturevalue("ckpt" if stored == "fp32" else "ckpt_bf16")
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _t(jw.convert_reference_checkpoint(d, CFG, dtype=jdtype))
    got = tw.convert_reference_checkpoint(d, TCFG, dtype=dtype, device="cpu")
    assert sorted(got) == ["align", "detector", "llm", "orderformer", "projector", "resampler",
                           "vision"]
    assert_trees_equal(got, want)
    assert got["detector"]["backbone"]["stem"]["w"].dtype == torch.float32


def test_bf16_shards_stay_bf16_on_the_host(ckpt_bf16):
    sd = tw.load_safetensors_dir(ckpt_bf16)
    assert {t.dtype for t in sd.values()} == {torch.bfloat16}


def test_convert_yolov8_matches_jax(jtree, tmp_path):
    """An ultralytics state dict with random, non-identity BatchNorm
    statistics folds to the same bits in both packages, from the dict and
    from a best.pt file."""
    sd = jckpt.detector_to_ultralytics_sd(jax.tree_util.tree_map(np.asarray, jtree["detector"]))
    rng = np.random.default_rng(5)
    for k, v in list(sd.items()):
        if k.endswith(".bn.weight"):
            sd[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k.endswith((".bn.bias", ".bn.running_mean")):
            sd[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        elif k.endswith(".bn.running_var"):
            sd[k] = rng.uniform(0.2, 2.0, v.shape).astype(np.float32)
    flat = {k[len("model."):]: v for k, v in sd.items()}
    want = _t(jdet.convert_yolov8(flat))
    assert_trees_equal(_t(tdet.convert_yolov8(flat)), want)
    path = str(tmp_path / "best.pt")
    torch.save({"model": {k: torch.tensor(v) for k, v in sd.items()}}, path)
    assert_trees_equal(_t(tdet.load_detector(path)), _t(jdet.load_detector(path)))


# ------------------------------------------------------------ export


@pytest.mark.parametrize("kind", ["plain", "lora", "qlora"])
def test_export_matches_jax(jtree, tmp_path, kind):
    """The port's export of a tree equals the JAX export of the same tree,
    file for file and tensor for tensor: the full directory for a plain and a
    LoRA tree (adapters merged), the safetensors set for an int8 QLoRA tree
    (dequantized to bf16, then merged)."""
    jt, tt = _with_lora(jtree, kind)
    want, got = str(tmp_path / "jax"), str(tmp_path / "port")
    if kind == "qlora":
        jckpt.export_reference_format(jt, CFG, want, max_shard_bytes=SHARD)
        tckpt.export_reference_format(tt, TCFG, got, max_shard_bytes=SHARD)
    else:
        jckpt.export_full_reference_checkpoint(jt, CFG, want, max_shard_bytes=SHARD)
        tckpt.export_full_reference_checkpoint(tt, TCFG, got, max_shard_bytes=SHARD)
    assert len(json.load(open(os.path.join(got, sio.INDEX_FILE)))["weight_map"]) > 50
    assert_dirs_equal(got, want)


@pytest.mark.parametrize("shard", [None, SHARD])
def test_port_export_reads_back_in_jax(jtree, tmp_path, shard):
    """A7 round trip: the port writes the reference layout, the JAX converter
    reads back the tree the port started from."""
    tckpt.export_full_reference_checkpoint(_t(jtree), TCFG, str(tmp_path), max_shard_bytes=shard)
    n_files = len(list(tmp_path.glob("*.safetensors")))
    assert n_files == (1 if shard is None else 5)
    back = _t(jw.convert_reference_checkpoint(str(tmp_path), CFG, dtype=jnp.float32))
    assert_trees_equal(back, _t(jtree))


# ------------------------------------------------------------ build_engine


def _page(seed, w, h):
    rng = np.random.default_rng(seed)
    page = np.full((h, w, 3), 236, np.uint8)
    page += rng.integers(0, 16, page.shape, dtype=np.uint8)
    boxes = []
    for c in range(2):
        for r in range(3):
            x0, y0 = 6 + c * 30, 6 + r * 28
            bw, bh = int(rng.integers(14, 24)), int(rng.integers(14, 24))
            page[y0:y0 + bh, x0:x0 + bw] = rng.integers(10, 70, (bh, bw, 3), dtype=np.uint8)
            boxes.append([float(x0), float(y0), float(x0 + bw), float(y0 + bh)])
    return page, boxes


@pytest.mark.parametrize("quant", [None, "int8"])
def test_build_engine_from_checkpoint_matches_jax(ckpt, quant):
    """build_engine(checkpoint_dir=...) with no trained assets: the same
    bf16 (or quantized, padded and fused int8) tree as the JAX build_engine's,
    and the same batch_chat_ocr token ids (8 tokens)."""
    jeng = jcommon.build_engine(preset=PRESET, checkpoint_dir=ckpt, trained_assets=False,
                                quant=quant)
    teng = tcommon.build_engine(preset=PRESET, checkpoint_dir=ckpt, trained_assets=False,
                                quant=quant, device="cpu")
    assert teng.random_components == [] and teng.assets == []
    assert teng.cfg == dataclasses.replace(
        TCFG, llm=tconfig.LLMConfig(**dataclasses.asdict(jeng.cfg.llm)))
    assert_trees_equal(teng.params, _t(jeng.params))
    jeng.policy, teng.policy = J_FP32, T_FP32
    (p0, b0), (p1, b1) = _page(0, 70, 96), _page(1, 100, 90)
    jrows = jeng.batch_build_rows([p0, p1], QUESTIONS, ordered_lists=[b0, b1])
    jprep = jeng.batch_prepare([], [], prepared_rows=jrows, max_new_tokens=8,
                               repetition_penalty=1.5)
    tprep = teng.batch_prepare([p0, p1], QUESTIONS, ordered_lists=[b0, b1], max_new_tokens=8,
                               repetition_penalty=1.5)
    assert (tprep["lengths"].numpy() == np.asarray(jprep["lengths"])).all()
    assert (tprep["tokens"].numpy() == np.asarray(jprep["tokens"])).all()
    assert teng.batch_decode(tprep) == jeng.batch_decode(jprep)


@pytest.fixture
def assets_preset(monkeypatch):
    """The tiny preset with the shipped detector's and OrderFormer's
    architecture, registered in both packages: the trained assets fit it."""
    name = "callireader-tiny-assets"
    for mod in (jconfig, tconfig):
        monkeypatch.setitem(mod.PRESETS, name, lambda mod=mod: dataclasses.replace(
            mod.callireader_tiny(), detector=mod.DetectorConfig(),
            orderformer=mod.OrderFormerConfig()))
    return name


@pytest.mark.parametrize("drop", [(), ("resampler",)])
def test_missing_components_and_overlays_match_jax(assets_preset, tmp_path, monkeypatch, capsys,
                                                   drop):
    """A checkpoint without side files (and without the resampler): the
    components the port draws at random are the JAX build_engine's missing set,
    and the trained assets overlay the same components (the JAX
    ``replaceable`` rule), with and without --no-trained-assets."""
    cfg = tconfig.get_config(assets_preset)
    params = tw.init_params(cfg, 7, dtype=torch.float32,
                            device="cpu")
    for name in drop:
        params.pop(name)
    tckpt.export_reference_format(params, cfg, str(tmp_path))
    seen = {}
    overlay = jcommon._overlay_trained_assets

    def spy(params, cfg, replaceable):
        seen["replaceable"] = set(replaceable)
        return overlay(params, cfg, replaceable)

    monkeypatch.setattr(jcommon, "_overlay_trained_assets", spy)
    capsys.readouterr()
    jcommon.build_engine(preset=assets_preset, checkpoint_dir=str(tmp_path))
    err = capsys.readouterr().err
    jloaded = {n for n in ("detector", "orderformer") if f"trained {n} loaded" in err}
    assert seen["replaceable"] == {"detector", "orderformer", *drop}
    assert jloaded == {"detector", "orderformer"}
    seed0 = tw.init_params(cfg, 0, dtype=torch.bfloat16,
                           device="cpu")
    for trained in (True, False):
        eng = tcommon.build_engine(preset=assets_preset, checkpoint_dir=str(tmp_path),
                                   trained_assets=trained, device="cpu")
        assert set(eng.random_components) == seen["replaceable"]
        assert set(eng.assets) == (jloaded if trained else set())
        for name in eng.random_components:
            if name not in eng.assets:
                assert_trees_equal(eng.params[name], seed0[name])
        assert_trees_equal(eng.params["llm"], tw.tree_to(params["llm"], torch.bfloat16, "cpu"))


# ------------------------------------------------------------ cli/convert.py


def _run_convert(argv, via):
    if via == "main":
        tconvert.main(argv)
        return
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-m", "callireader_tpu_torch", "convert", *argv], cwd=REPO,
                   env=env, check=True, capture_output=True, timeout=300)


@pytest.mark.parametrize("mode,via", [("split", "main"), ("consolidate-bf16", "main"),
                                      ("consolidate-fp16", "main"), ("split", "module"),
                                      ("consolidate-bf16", "module")])
def test_convert_split_and_consolidate_match_jax(ckpt, tmp_path, mode, via):
    """``convert split`` / ``consolidate`` on the JAX export write what JAX
    consolidate_safetensors_dtype writes, in-process and through
    ``python -m callireader_tpu_torch convert``."""
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    if mode == "split":
        _run_convert(["split", ckpt, got, "--max-shard-size", "1MB"], via)
        jckpt.consolidate_safetensors_dtype(ckpt, want, dtype=None, max_shard_bytes=1 << 20)
    else:
        dtype = {"bf16": "bfloat16", "fp16": "float16"}[mode.split("-")[1]]
        _run_convert(["consolidate", ckpt, got, "--dtype", dtype], via)
        jckpt.consolidate_safetensors_dtype(ckpt, want, dtype=dtype)
    assert_dirs_equal(got, want)


def _adapter_state(port_tree, tmp_path):
    """A cli.train checkpoint of dyadic LoRA leaves and a moved projector
    (``state.pt``), and the JAX tree holding the same leaves."""
    params = {**port_tree, "llm": {**port_tree["llm"]}}
    shapes = {n: tuple(params["llm"]["layers"][n].shape) for n in LORA_TARGETS}
    lora = {k: torch.from_numpy(v) for k, v in _dyadic_lora(shapes, seed=2).items()}
    params["llm"]["layers"] = {**params["llm"]["layers"], **lora}
    params["projector"] = {**params["projector"],
                           "fc1_bias": params["projector"]["fc1_bias"] + 1 / 64}
    tc = e_it.TrainConfig(lora_rank=LORA_RANK, lora_alpha=LORA_ALPHA)
    trainable, _ = e_it.partition_params(params, tc)
    tckpt.save_train_state(str(tmp_path / "adapter"), e_it.TrainState(trainable, {}, 0))
    jtree = jax.tree_util.tree_map(lambda t: t.numpy(), params)
    return str(tmp_path / "adapter"), jtree


@pytest.mark.parametrize("mode", ["export", "export-no-merge", "merge", "merge-adapter"])
def test_convert_export_and_merge_match_jax(jtree, tmp_path, mode):
    """``convert export`` / ``merge`` on a params checkpoint of the port
    (``save_params``; for ``merge --adapter``, a base and a cli.train
    checkpoint) write what the JAX export writes for the same tree."""
    jt, tt = _with_lora(jtree, "lora" if mode != "merge-adapter" else "plain")
    tckpt.save_params(str(tmp_path / "params"), tt)
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    argv = ["--preset", PRESET, "--checkpoint", str(tmp_path / "params"), "--out", got,
            "--device", "cpu"]
    if mode.startswith("export"):
        extra = ["--no-merge-lora"] if mode == "export-no-merge" else []
        tconvert.main(["export", *argv, "--max-shard-size", "2MB", *extra])
        jckpt.export_reference_format(jt, CFG, want, max_shard_bytes=SHARD,
                                      merge_lora_first=not extra)
    else:
        if mode == "merge-adapter":
            adapter, jt = _adapter_state(tt, tmp_path)
            argv += ["--adapter", adapter, "--lora-rank", str(LORA_RANK),
                     "--lora-alpha", str(LORA_ALPHA)]
        tconvert.main(["merge", *argv])
        jckpt.export_reference_format(jt, CFG, want)
    assert_dirs_equal(got, want)


# ------------------------------------------------------------ the CLIs


def _train_data(root):
    rng = np.random.default_rng(0)
    ann = []
    for i in range(2):
        np.save(root / f"s{i}.npy", rng.integers(0, 255, (64, 48, 3), dtype=np.uint8))
        np.save(root / f"e{i}.npy", rng.standard_normal((2, 3, CFG.llm.hidden_size),
                                                        dtype=np.float32))
        ann.append({"image": f"s{i}.npy", "embedding": f"e{i}.npy", "conversations": [
            {"from": "human", "value": QUESTIONS[0]}, {"from": "gpt", "value": "春眠不觉晓"}]})
    (root / "ann.jsonl").write_text("".join(json.dumps(a, ensure_ascii=False) + "\n" for a in ann))


def test_train_cli_from_checkpoint_writes_export_official(ckpt, tmp_path):
    """cli.train --checkpoint D trains on the loaded base and ends with
    <out>/export_official, which the JAX converter reads back to the merged
    LLM of the final checkpoint (merge_lora(merge_params(final state)))."""
    _train_data(tmp_path)
    out = tmp_path / "out"
    ttrain.main(["--data", str(tmp_path / "ann.jsonl"), "--image-root", str(tmp_path),
                 "--out", str(out), "--config", "e_it", "--preset", PRESET, "--checkpoint", ckpt,
                 "--device", "cpu", "--max-iters", "2", "--grad-accum", "1", "--lr", "1e-2",
                 "--lora-rank", str(LORA_RANK), "--lora-alpha", str(LORA_ALPHA)])
    base = tcommon.build_engine(preset=PRESET, checkpoint_dir=ckpt, device="cpu").params
    base_llm = {**base["llm"], "layers": dict(base["llm"]["layers"])}
    merged = tcommon.merge_adapter(base, TCFG, str(out / "final"), LORA_RANK, LORA_ALPHA, "cpu")
    back = _t(jw.convert_reference_checkpoint(str(out / "export_official"), CFG,
                                              dtype=jnp.float32))
    assert sorted(back) == ["align", "llm", "projector", "resampler", "vision"]
    assert_trees_equal(back["llm"], jax.tree_util.tree_map(lambda t: t.float(), merged["llm"]))
    assert not torch.equal(merged["llm"]["layers"]["wq"], base_llm["layers"]["wq"])


def _page_files(root):
    page, boxes = _page(0, 70, 96)
    np.save(root / "page.npy", page)
    h, w = page.shape[:2]
    shapes = [{"points": [[x0 / w, y0 / h], [x1 / w, y1 / h]]} for x0, y0, x1, y1 in boxes]
    (root / "page.json").write_text(json.dumps({"shapes": shapes}))
    (root / "req.jsonl").write_text(json.dumps({"id": "a", "question": "你好",
                                                "max_new_tokens": 4}) + "\n")
    return str(root / "page.npy")


CLI_RUNS = {
    "inference": lambda p, d: (tinf, ["--tgt", p]),
    "inference-no-trained-assets": lambda p, d: (tinf, ["--tgt", p, "--no-trained-assets"]),
    "chat": lambda p, d: (tchat, ["--image", p, "--max-new-tokens", "4"]),
    "serve": lambda p, d: (tserve, ["--input", str(d / "req.jsonl"), "--output",
                                    str(d / "out.jsonl"), "--slots", "2", "--max-len", "512"]),
    "serve-no-trained-assets": lambda p, d: (tserve, [
        "--input", str(d / "req.jsonl"), "--output", str(d / "out.jsonl"), "--slots", "2",
        "--max-len", "512", "--paged", "--no-trained-assets"]),
    "get_embeddings": lambda p, d: (tget, ["--data", str(d), "--out", str(d / "emb")]),
}


@pytest.mark.parametrize("cli", list(CLI_RUNS))
def test_cli_boots_from_checkpoint(ckpt, tmp_path, monkeypatch, capsys, cli):
    """Each CLI with --checkpoint (no --random-init) builds its engine from
    the checkpoint (every component loaded, none drawn at random), passes
    --no-trained-assets on, and runs: a page read, a chat turn, a served
    request, a page's pseudo embeddings."""
    page = _page_files(tmp_path)
    built = []
    build = tcommon.build_engine

    def spy(**kw):
        eng = build(**kw)
        monkeypatch.setattr(eng, "chat_ocr", functools.partial(eng.chat_ocr, max_new_tokens=4))
        built.append((kw, eng))
        return eng

    monkeypatch.setattr(tcommon, "build_engine", spy)
    monkeypatch.setattr("sys.stdin", io.StringIO("你好\nEXIT\n"))
    monkeypatch.chdir(tmp_path)
    module, argv = CLI_RUNS[cli](page, tmp_path)
    module.main([*argv, "--preset", PRESET, "--checkpoint", ckpt, "--device", "cpu"])
    (kw, eng), = built
    assert kw["checkpoint_dir"] == ckpt and not kw["random_init_ok"]
    assert kw.get("trained_assets", True) == ("no-trained-assets" not in cli)
    assert eng.random_components == []
    want = tw.convert_reference_checkpoint(ckpt, TCFG, dtype=torch.bfloat16, device="cpu")
    assert_trees_equal(eng.params["vision"], want["vision"])
    out = capsys.readouterr().out
    if cli.startswith("inference"):
        assert "Assistant:" in out
    elif cli == "chat":
        assert "assistant>" in out
    elif cli.startswith("serve"):
        rec, = [json.loads(line) for line in open(tmp_path / "out.jsonl")]
        assert rec["id"] == "a" and rec["n_tokens"] == 4
    else:
        assert np.load(tmp_path / "emb" / "page.npy").shape[1] == CFG.llm.hidden_size
