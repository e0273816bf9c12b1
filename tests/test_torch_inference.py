"""The port's inference surface against the JAX package on the tiny preset
(CPU, fp32, the same parameters carried across with from_jax_params):
single-image chat_ocr (use_p, hard_vq, drop_zero, region_wise), chat,
dynamic_chat, batch_chat, beam search, the sampling filter, cli.inference,
cli.chat's stream_generate, get_embeddings, the e-IT adapter merge, apis and
the mode table.

Both engines get the same reading-order boxes in place of the untrained
detector's. Generated token ids must be identical; pseudo embeddings agree
to 1e-4 (fp32 through the char tower and the resampler, rounding order
differs between XLA and torch); merged bf16 LoRA weights within one bf16 ulp.
"""

import functools
import io
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from callireader_tpu.cli import chat as jchat
from callireader_tpu.cli import common as jcommon
from callireader_tpu.cli import get_embeddings as jget
from callireader_tpu.cli import inference as jinf
from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.runtime import generate as jgen
from callireader_tpu.runtime.engine import CalliReaderEngine as JEngine
from callireader_tpu.runtime.engine import init_all_params
from callireader_tpu.runtime.tokenizer import InternLM2Tokenizer as JTok
from callireader_tpu.train import lora as jlora
from callireader_tpu_torch import __main__ as tmain
from callireader_tpu_torch import apis
from callireader_tpu_torch.cli import chat as tchat
from callireader_tpu_torch.cli import common as tcommon
from callireader_tpu_torch.cli import get_embeddings as tget
from callireader_tpu_torch.cli import inference as tinf
from callireader_tpu_torch.core.config import callireader_tiny as t_tiny
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.runtime import generate as tgen
from callireader_tpu_torch.runtime.engine import CalliReaderEngine as TEngine
from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer as TTok
from callireader_tpu_torch.runtime.weights import from_jax_params

QUESTION = "读出图中所有文字。"
T = 4  # new tokens a test


def _page(seed, w=70, h=96):
    rng = np.random.default_rng(seed)
    page = np.full((h, w, 3), 236, np.uint8)
    page += rng.integers(0, 16, page.shape, dtype=np.uint8)
    for c in range(2):
        for r in range(3):
            x0, y0 = 6 + c * 30, 6 + r * 28
            page[y0:y0 + 18, x0:x0 + 16] = rng.integers(10, 70, (18, 16, 3), dtype=np.uint8)
    return page


def _boxes(image):
    """Reading-order char boxes that fit the image (a full page or a crop)."""
    h, w = image.shape[:2]
    return [[float(x0), float(y0), float(min(x0 + 16, w)), float(min(y0 + 18, h))]
            for x0 in range(6, w - 12, 30) for y0 in range(6, h - 12, 28)]


class Recorder:
    """Wraps a module's generate entry points: keeps each call's token ids."""

    def __init__(self, monkeypatch, module):
        self.calls = []
        for name in ("generate_from_embeds", "beam_generate_from_embeds"):
            orig = getattr(module, name)

            def rec(*a, _orig=orig, **kw):
                tokens, lengths = _orig(*a, **kw)
                t, n = np.asarray(tokens), np.asarray(lengths)
                self.calls.append([t[i, :n[i]].tolist() for i in range(t.shape[0])])
                return tokens, lengths

            monkeypatch.setattr(module, name, rec)


@pytest.fixture(scope="module")
def engines():
    cfg = callireader_tiny()
    params = init_all_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    jeng = JEngine(cfg, params, JTok("callireader_tpu/assets/tokenizer.model"),
                   policy=J_FP32, use_flash=False)
    teng = TEngine(t_tiny(), from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                             device="cpu"), TTok(), device="cpu", policy=T_FP32,
                   device_tile_pages=True)
    for eng in (jeng, teng):
        eng.sort_boxes = _boxes
    return jeng, teng


@pytest.fixture
def recorders(monkeypatch):
    return Recorder(monkeypatch, jgen), Recorder(monkeypatch, tgen)


def _same_tokens(recorders):
    jrec, trec = recorders
    assert jrec.calls and jrec.calls == trec.calls, (jrec.calls, trec.calls)


@pytest.mark.parametrize("opts", [
    dict(),
    dict(use_p=False),
    dict(hard_vq=True, repetition_penalty=1.0),
    dict(drop_zero=True),
])
def test_chat_ocr_tokens_match_jax(engines, recorders, opts):
    jeng, teng = engines
    page = _page(0)
    jr, jh = jeng.chat_ocr(page, QUESTION, max_new_tokens=T, return_history=True, **opts)
    tr, th = teng.chat_ocr(page, QUESTION, max_new_tokens=T, return_history=True, **opts)
    _same_tokens(recorders)
    assert (tr, th) == (jr, jh)


def test_chat_ocr_history_and_region_wise_match_jax(engines, recorders, monkeypatch):
    jeng, teng = engines
    page = _page(1)
    q = "读出区域 4 60 2 70 的文字"
    assert teng.chat_ocr(page, q, region_wise=True, max_new_tokens=T) == \
        jeng.chat_ocr(page, q, region_wise=True, max_new_tokens=T)
    _, jh = jeng.chat_ocr(page, QUESTION, max_new_tokens=T, return_history=True)
    _, th = teng.chat_ocr(page, QUESTION, max_new_tokens=T, return_history=True)
    assert teng.chat_ocr(page, "作者是谁？", history=th, max_new_tokens=T) == \
        jeng.chat_ocr(page, "作者是谁？", history=jh, max_new_tokens=T)
    _same_tokens(recorders)
    # no character in the region: the early answer, no generation
    for eng in (jeng, teng):
        monkeypatch.setattr(eng, "sort_boxes", lambda image: [])
    n_calls = len(recorders[1].calls)
    assert teng.chat_ocr(page, q, region_wise=True, return_history=True) == \
        jeng.chat_ocr(page, q, region_wise=True, return_history=True) == ("检测失败", None)
    assert len(recorders[1].calls) == n_calls


def test_chat_dynamic_chat_batch_chat_match_jax(engines, recorders):
    jeng, teng = engines
    pages = [_page(2), _page(3, w=100, h=90)]
    assert teng.chat(pages[0], "你好", max_new_tokens=T) == \
        jeng.chat(pages[0], "你好", max_new_tokens=T)
    assert teng.chat(None, "你好", max_new_tokens=T) == jeng.chat(None, "你好", max_new_tokens=T)
    assert teng.dynamic_chat(pages[1], QUESTION, max_new_tokens=T) == \
        jeng.dynamic_chat(pages[1], QUESTION, max_new_tokens=T)
    assert teng.batch_chat(pages, [QUESTION, "你好"], max_new_tokens=T) == \
        jeng.batch_chat(pages, [QUESTION, "你好"], max_new_tokens=T)
    _same_tokens(recorders)
    assert len(recorders[1].calls) == 4 and len(recorders[1].calls[-1]) == 2


@pytest.mark.parametrize("opts", [dict(use_p=False), dict(drop_zero=True), dict(hard_vq=True)])
def test_batch_api_options_match_jax(engines, recorders, monkeypatch, opts):
    """The batch API's use_p / drop_zero / hard_vq, both engines tiling on
    the device."""
    jeng, teng = engines
    monkeypatch.setattr(jeng, "device_tile_pages", True)
    pages = [_page(13), _page(14, w=100, h=90)]
    ordered = [_boxes(p) for p in pages]
    jrows = jeng.batch_build_rows(pages, [QUESTION, "你好"], ordered_lists=ordered, **opts)
    jtext = jeng.batch_decode(jeng.batch_prepare([], [], prepared_rows=jrows, max_new_tokens=T))
    ttext = teng.batch_chat_ocr(pages, [QUESTION, "你好"], ordered_lists=ordered,
                                max_new_tokens=T, **opts)
    _same_tokens(recorders)
    assert ttext == jtext


@pytest.mark.parametrize("k", [2, 3])
def test_beam_search_matches_jax(engines, recorders, k):
    jeng, teng = engines
    page = _page(4)
    assert teng.chat_ocr(page, QUESTION, num_beams=k, max_new_tokens=5) == \
        jeng.chat_ocr(page, QUESTION, num_beams=k, max_new_tokens=5)
    _same_tokens(recorders)


@pytest.mark.parametrize("kw", [
    dict(top_k=5),
    dict(top_p=0.8),
    dict(temperature=0.7, top_k=40, top_p=0.9),
    dict(temperature=1.3, top_p=0.5),
])
def test_sampling_filter_matches_jax_and_draws_inside_it(monkeypatch, kw):
    logits = np.random.default_rng(0).standard_normal((3, 200)).astype(np.float32) * 3
    logits[1, :4] = logits[1, 4]  # ties at the cutoff
    seen = {}

    def capture(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jcfg = jgen.GenerateConfig(do_sample=True, **kw)
    jgen._sample(jnp.asarray(logits), jcfg, jax.random.PRNGKey(0))
    tcfg = tgen.GenerateConfig(do_sample=True, **kw)
    filtered = tgen._filter_logits(torch.from_numpy(logits), tcfg).numpy()
    kept = np.isfinite(filtered)
    assert (kept == np.isfinite(seen["logits"])).all()
    np.testing.assert_allclose(filtered[kept], seen["logits"][kept], rtol=1e-6)

    draws = [tgen._sample(torch.from_numpy(logits), tcfg,
                          torch.Generator().manual_seed(s)).numpy() for s in range(64)]
    again = tgen._sample(torch.from_numpy(logits), tcfg, torch.Generator().manual_seed(0)).numpy()
    assert (again == draws[0]).all()
    assert all(kept[np.arange(3), d].all() for d in draws)
    assert len({tuple(d) for d in draws}) > 1


def test_sampled_generate_is_reproducible(engines):
    _, teng = engines
    cfg = teng.cfg.llm
    emb = teng.params["llm"]["tok_embeddings"][torch.tensor([[1, 5, 9]])]
    mask = torch.ones((1, 3), dtype=torch.int32)
    gcfg = tgen.GenerateConfig(max_new_tokens=5, eos_token_ids=(-1,), do_sample=True,
                               top_p=0.9, top_k=50)

    def run(seed):
        return tgen.generate_from_embeds(teng.params["llm"], cfg, emb, mask, gen_cfg=gcfg,
                                         max_cache_len=16, policy=T_FP32,
                                         generator=torch.Generator().manual_seed(seed))[0]

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))


def _png(path, seed, w=70, h=96):
    Image.fromarray(_page(seed, w, h)).save(path)
    return str(path)


def test_inference_cli_matches_jax(engines, tmp_path, monkeypatch, capsys):
    """Single-image and folder mode: the same printed text and results JSON
    (an unreadable page becomes "ERROR!" in both)."""
    jeng, teng = engines
    monkeypatch.setattr(jcommon, "build_engine", lambda **kw: jeng)
    monkeypatch.setattr(tcommon, "build_engine", lambda **kw: teng)
    for eng in (jeng, teng):
        monkeypatch.setattr(eng, "chat_ocr", functools.partial(eng.chat_ocr, max_new_tokens=T))
    pages = tmp_path / "pages"
    pages.mkdir()
    single = _png(pages / "a.png", 5)
    _png(pages / "b.png", 6, w=90, h=80)
    monkeypatch.chdir(tmp_path)
    out = {}
    for name, main in (("jax", jinf.main), ("port", tinf.main)):
        argv = ["--random-init", "--preset", "callireader-tiny", "--repetition_penalty", "1.5"]
        main(["--tgt", single, *argv])
        main(["--tgt", str(pages), "--save_name", name, *argv])
        out[name] = (capsys.readouterr().out,
                     json.loads((tmp_path / "results" / f"{name}_result.json").read_text()))
    assert out["port"] == out["jax"]
    assert "Single image recognition mode." in out["port"][0]
    assert len(out["port"][1]) == 2

    np.save(pages / "c.npy", _page(7))  # a page the port reads and the JAX CLI does not list
    monkeypatch.setattr(teng, "chat_ocr", lambda *a, **kw: 1 / 0)
    tinf.main(["--tgt", str(pages), "--save_name", "err", "--random-init"])
    recs = json.loads((tmp_path / "results" / "err_result.json").read_text())
    assert [r["response"] for r in recs] == ["ERROR!"] * 3


@pytest.mark.parametrize("flag", [["--mesh", "tensor=4"], []])
def test_inference_cli_refuses_what_is_not_ported(tmp_path, capsys, flag):
    """Without ``--random-init`` or a checkpoint the CLI exits; a ``--mesh``
    whose size is not the world's (a world of 1 without torchrun) too."""
    import torch.distributed as dist

    argv = ["--tgt", str(tmp_path), "--preset", "callireader-tiny", "--device", "cpu", *flag]
    if flag:
        argv.append("--random-init")
    try:
        with pytest.raises(SystemExit):
            tinf.main(argv)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert ("does not match 1 ranks" if flag else "--random-init") in capsys.readouterr().err


def test_stream_generate_matches_jax(engines, monkeypatch):
    jeng, teng = engines
    page = _page(8)
    printed = {}
    for name, fn, eng in (("jax", jchat.stream_generate, jeng),
                          ("port", tchat.stream_generate, teng)):
        buf = io.StringIO()
        monkeypatch.setattr("sys.stdout", buf)
        r1, h = fn(eng, QUESTION, None, image=page, max_new_tokens=6, repetition_penalty=1.5)
        r2, h = fn(eng, "作者是谁？", h, max_new_tokens=6, stop_words=("谁",))
        printed[name] = (buf.getvalue(), r1, r2, h)
        monkeypatch.undo()
    assert printed["port"] == printed["jax"]
    # --agent runs (tests/test_torch_agent_modes.py holds it against JAX's)
    monkeypatch.setattr(tcommon, "build_engine", lambda **kw: teng)
    monkeypatch.setattr("sys.stdin", io.StringIO("1+1等于几？\nEXIT\n"))
    buf = io.StringIO()
    monkeypatch.setattr("sys.stdout", buf)
    tchat.main(["--agent", "--random-init", "--device", "cpu", "--max-new-tokens", "2"])
    monkeypatch.undo()
    assert buf.getvalue().count("assistant> ") == 1


def test_get_embeddings_matches_jax(engines, tmp_path, monkeypatch):
    jeng, teng = engines
    data = tmp_path / "data"
    data.mkdir()
    Image.fromarray(_page(9)).save(data / "p0.jpg", quality=95)
    np.save(data / "p1.npy", _page(10))
    shapes = [{"points": [[b[0] / 70, b[1] / 96], [b[2] / 70, b[3] / 96]]} for b in _boxes(_page(9))]
    for name in ("p0", "p1"):
        (data / f"{name}.json").write_text(json.dumps({"shapes": shapes}))
    labelme = {"shapes": shapes}
    for opts in (dict(drop_zero=True), dict(drop_zero=False, hard_vq=True)):
        want = jget.extract_embedding_for_image(jeng, str(data / "p0.jpg"), labelme, **opts)
        got = tget.extract_embedding_for_image(teng, str(data / "p0.jpg"), labelme, **opts)
        assert got.shape == want.shape and got.shape[0] > 0
        np.testing.assert_allclose(got, want, atol=1e-4)
    monkeypatch.setattr(jcommon, "build_engine", lambda **kw: jeng)
    monkeypatch.setattr(tcommon, "build_engine", lambda **kw: teng)
    jget.main(["--data", str(data), "--out", str(tmp_path / "j"), "--random-init"])
    tget.main(["--data", str(data), "--out", str(tmp_path / "t"), "--random-init"])
    tget.main(["--data", str(data), "--out", str(tmp_path / "pt"), "--random-init",
               "--format", "pt"])
    assert sorted(os.listdir(tmp_path / "j")) == ["p0.npy"]
    assert sorted(os.listdir(tmp_path / "t")) == ["p0.npy", "p1.npy"]  # .npy pages too
    np.testing.assert_allclose(np.load(tmp_path / "t" / "p0.npy"),
                               np.load(tmp_path / "j" / "p0.npy"), atol=1e-4)
    np.testing.assert_array_equal(torch.load(tmp_path / "pt" / "p1.pt").numpy(),
                                  np.load(tmp_path / "t" / "p1.npy"))


def _train_adapter(root):
    rng = np.random.default_rng(0)
    ann = []
    for i in range(2):
        np.save(root / f"s{i}.npy", rng.integers(0, 255, (64, 48, 3), dtype=np.uint8))
        np.save(root / f"e{i}.npy", rng.standard_normal((6, 64), dtype=np.float32))
        ann.append({"image": f"s{i}.npy", "embedding": f"e{i}.npy", "conversations": [
            {"from": "human", "value": QUESTION}, {"from": "gpt", "value": "春眠不觉晓"}]})
    (root / "ann.jsonl").write_text("".join(json.dumps(a, ensure_ascii=False) + "\n" for a in ann))
    out = apis.finetune(str(root / "ann.jsonl"), image_root=str(root), out_dir=str(root / "out"),
                        preset="callireader-tiny", max_iters=2, batch_size=1, lora_rank=4,
                        lora_alpha=8.0, learning_rate=1e-2, device="cpu")
    return Path(out) / "final"


def test_adapter_merge_matches_jax_merge_lora(tmp_path):
    """--adapter: the LoRA values of a cli.train run (through apis.finetune)
    merged into the seed-0 base as the JAX merge_lora merges them; the
    projector restored; the int8 build quantizes the merged weights and
    answers."""
    final = _train_adapter(tmp_path)
    saved = torch.load(final / "state.pt", weights_only=True)["tensors"]
    kw = dict(preset="callireader-tiny", random_init_ok=True, adapter_path=str(final),
              lora_rank=4, lora_alpha=8.0, device="cpu")
    eng = tcommon.build_engine(**kw)
    base = tcommon.build_engine(preset="callireader-tiny", random_init_ok=True, device="cpu")
    # the bf16 base leaves, exactly, and the checkpoint's fp32 adapters
    layers = {k: jnp.asarray(v.float().numpy()).astype(jnp.bfloat16)
              for k, v in base.params["llm"]["layers"].items()}
    for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        for ab in ("a", "b"):
            layers[f"{name}_lora_{ab}"] = jnp.asarray(
                saved[f"trainable/llm/layers/{name}_lora_{ab}"].numpy())
    assert float(jnp.abs(layers["wq_lora_b"]).max()) > 0
    layers["lora_scale"] = jnp.full((layers["wq"].shape[0],), 2.0, jnp.float32)
    want = jlora.merge_lora({"layers": layers})["layers"]
    got = eng.params["llm"]["layers"]
    assert not any("_lora_" in k for k in got)
    for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        # fp32 sums in another order, one bf16 rounding: within one bf16 ulp
        np.testing.assert_allclose(got[name].float().numpy(),
                                   np.asarray(want[name].astype(jnp.float32)), rtol=2**-8,
                                   atol=1e-7, err_msg=name)
    for k, v in saved.items():
        if k.startswith("trainable/projector/"):
            leaf = functools.reduce(lambda t, p: t[p], k.split("/")[1:], eng.params)
            assert torch.equal(leaf, v.to(leaf.dtype))

    q = tcommon.build_engine(quant="int8", **kw)
    assert "wqkv_q" in q.params["llm"]["layers"] and q.cfg.llm.vocab_size % 128 == 0
    q.sort_boxes = _boxes
    assert isinstance(q.chat_ocr(_page(11), QUESTION, max_new_tokens=2), str)


def test_apis_and_mode_table(tmp_path, capsys):
    eng = apis.load_engine(preset="callireader-tiny", random_init=True, device="cpu")
    eng.sort_boxes = _boxes
    assert isinstance(apis.recognize(eng, _page(12), max_new_tokens=2), str)
    answer, hist = apis.ask(eng, _page(12), "作者是谁？", max_new_tokens=2)
    assert isinstance(answer, str) and len(hist) == 1
    with pytest.raises(FileNotFoundError):
        apis.evaluate_full_page(eng, str(tmp_path / "missing.parquet"))
    assert tmain.main(["list-cfg"]) == 0 and "e_it" in capsys.readouterr().out
    with pytest.raises(SystemExit) as e:  # the mode runs; its subcommand is required
        tmain.main(["preprocess"])
    assert e.value.code == 2 and "arxiv" in capsys.readouterr().err
    assert tmain.main(["nonsense"]) == 1
    assert tmain.main([]) == 0
