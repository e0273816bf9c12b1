"""The port's evaluation harness (evalx, cli.evaluate, cli.judge) against the
JAX package on the tiny preset (CPU, fp32 engines from one init_all_params,
carried across with from_jax_params, a stub detector that finds two boxes on
any page).

The metric, mmbench, refcoco and judge functions equal JAX exactly over a
seeded sweep of strings (CJK, ASCII, digits, punctuation, option letters).
Each CalliBench task's result dict, and its file, equal the JAX ones key for
key and value for value on the same synthetic parquet: this rests on the
equal token ids of the two engines (tests/test_torch_engine.py). The CLI
runs with --device cpu and --random-init on a synthetic CalliBench tree.
"""

import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.evalx import callibench as jbench
from callireader_tpu.evalx import judges as jjudges
from callireader_tpu.evalx import metrics as jmetrics
from callireader_tpu.evalx import mmbench as jmmbench
from callireader_tpu.evalx import refcoco as jrefcoco
from callireader_tpu.runtime.engine import CalliReaderEngine as JEngine
from callireader_tpu.runtime.engine import init_all_params
from callireader_tpu.runtime.tokenizer import InternLM2Tokenizer as JTok
from callireader_tpu_torch import __main__ as tmain
from callireader_tpu_torch import apis
from callireader_tpu_torch.cli import common as tcommon
from callireader_tpu_torch.cli import evaluate as tevaluate
from callireader_tpu_torch.core.config import callireader_tiny as t_tiny
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.evalx import callibench as tbench
from callireader_tpu_torch.evalx import judges as tjudges
from callireader_tpu_torch.evalx import metrics as tmetrics
from callireader_tpu_torch.evalx import mmbench as tmmbench
from callireader_tpu_torch.evalx import refcoco as trefcoco
from callireader_tpu_torch.runtime.engine import CalliReaderEngine as TEngine
from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer as TTok
from callireader_tpu_torch.runtime.weights import from_jax_params

NEW_TOKENS = 6
ALPHABET = list("春眠不觉晓處處聞啼鳥乾著藉祇瀋覆徵髮後裡發") + list("abcXYZ019") + \
    list("。？！、，「」『』《》：；,.!?:'\";()[]{}-*\n ") + list("ABCD")


def _stub_detector(img):
    return [[8.0, 8.0, 24.0, 24.0], [8.0, 33.0, 24.0, 49.0]]


@pytest.fixture(scope="module")
def engines():
    params = init_all_params(jax.random.PRNGKey(0), callireader_tiny(), dtype=jnp.float32)
    jeng = JEngine(callireader_tiny(), params, JTok("callireader_tpu/assets/tokenizer.model"),
                   policy=J_FP32, use_flash=False)
    teng = TEngine(t_tiny(), from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                             device="cpu"), TTok(), device="cpu", policy=T_FP32)
    jeng.detector = teng.detector = _stub_detector
    return jeng, teng


def _strings(seed, n=60, max_len=24):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(ALPHABET, int(rng.integers(0, max_len)))) for _ in range(n)]


def _png(seed, w=60, h=80):
    rng = np.random.RandomState(seed)
    buf = io.BytesIO()
    Image.fromarray(np.full((h, w, 3), 230, np.uint8)
                    - rng.randint(0, 30, (h, w, 3), np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


def _parquet(path, annots):
    import pandas as pd

    rows = [{"image": {"bytes": _png(i)}, "annotation": json.dumps(a, ensure_ascii=False)}
            for i, a in enumerate(annots)]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pd.DataFrame(rows).to_parquet(path)
    return path


# ------------------------------------------------------------------ metrics


@pytest.mark.parametrize("seed", range(3))
def test_metrics_equal_jax(seed):
    a, b = _strings(seed), _strings(seed + 100)
    for x, y in zip(a, b):
        for fn in ("remove_chinese_punctuation", "remove_english_punctuation",
                   "get_clean_string", "t2s"):
            assert getattr(tmetrics, fn)(x) == getattr(jmetrics, fn)(x), fn
        assert tmetrics.levenshtein(x, y) == jmetrics.levenshtein(x, y)
        assert tmetrics.levenshtein(list(x), list(y)) == jmetrics.levenshtein(list(x), list(y))
        assert tmetrics.calculate_metrics(list(x), list(y)) == \
            jmetrics.calculate_metrics(list(x), list(y))
        assert tmetrics.ned(x, y) == jmetrics.ned(x, y)
    rng = np.random.default_rng(seed)
    answers = [(str(rng.choice(list("ABC"))), *(_strings(seed + 7 + i, n=3, max_len=4)))
               for i in range(len(a))]
    assert tmetrics.evaluate_choice_accuracy(a, answers) == \
        jmetrics.evaluate_choice_accuracy(a, answers)
    letters = ["".join(rng.choice(list("xABCDy"), 3)) for _ in a]
    truth = [str(rng.choice(list("ABCD"))) for _ in a]
    assert tmetrics.mmlu_accuracy(letters, truth) == jmetrics.mmlu_accuracy(letters, truth)
    chosen, rejected = rng.standard_normal(20).tolist(), rng.standard_normal(20).tolist()
    assert tmetrics.reward_accuracy(chosen, rejected) == jmetrics.reward_accuracy(chosen, rejected)


def test_t2s_fallback_without_opencc(monkeypatch):
    """With opencc absent both packages convert through the bundled phrase and
    char tables: the phrase table decides the context-dependent chars."""
    monkeypatch.setitem(sys.modules, "opencc", None)
    for text in ("乾隆皇帝著書", "狼藉一片，發現頭髮", "處處聞啼鳥" * 3, ""):
        assert tmetrics.t2s(text) == jmetrics.t2s(text)
    assert tmetrics.t2s("處處聞啼鳥") == "处处闻啼鸟"


@pytest.mark.parametrize("seed", range(2))
def test_mmbench_and_refcoco_functions_equal_jax(seed):
    rng = np.random.default_rng(seed)
    texts = _strings(seed + 30, n=40)
    for i, resp in enumerate(texts):
        rec = {"question": texts[i - 1], "hint": ["", "nan", texts[i - 2]][i % 3]}
        for letter in "ABCD"[:int(rng.integers(0, 5))]:
            rec[letter] = texts[(i + ord(letter)) % len(texts)] or "nan"
        assert tmmbench.build_prompt(rec) == jmmbench.build_prompt(rec)
        assert tmmbench.extract_answer(resp, rec) == jmmbench.extract_answer(resp, rec)
    answers = []
    for _ in range(40):
        H, W = int(rng.integers(50, 500)), int(rng.integers(50, 500))
        x, y = float(rng.integers(0, W - 10)), float(rng.integers(0, H - 10))
        bbox = [x, y, float(rng.integers(1, W - x)), float(rng.integers(1, H - y))]
        pct = jrefcoco.normalize_bbox(bbox, H, W)
        jitter = (pct + rng.integers(-8, 9, 4)).tolist()
        ans = str(rng.choice([jrefcoco.bbox_answer_string(jitter), "{<3><4>}", " ".join(
            map(str, jitter)) + " 7"]))
        assert trefcoco.normalize_bbox(bbox, H, W) == pct
        assert trefcoco.parse_bbox_answer(ans) == jrefcoco.parse_bbox_answer(ans)
        assert trefcoco.compute_iou(jitter, pct) == jrefcoco.compute_iou(jitter, pct)
        for gen in ("gen_refer_conversation", "gen_identify_conversation"):
            assert getattr(trefcoco, gen)(ans, bbox, H, W, trefcoco.IDENTIFY_INSTRUCTIONS[1]) == \
                getattr(jrefcoco, gen)(ans, bbox, H, W, jrefcoco.IDENTIFY_INSTRUCTIONS[1])
        answers.append({"ans": ans, "bbox": bbox, "height": H, "width": W})
    assert trefcoco.eval_iou(answers) == jrefcoco.eval_iou(answers)


def test_judges_equal_jax(tmp_path):
    texts = _strings(50, n=12)
    path = tmp_path / "intent.json"
    path.write_text(json.dumps({"detailed": [
        {"answer": a, "gt": b, "calligraphy_content": a[:3]}
        for a, b in zip(texts, texts[::-1])]}, ensure_ascii=False), encoding="utf-8")

    def embed(batch):
        out = np.zeros((len(batch), 32), np.float32)
        for i, t in enumerate(batch):
            for ch in t:
                out[i, ord(ch) % 32] += 1.0
        return out

    assert tjudges.STScoreJudge(embed).score_result_file(str(path)) == \
        jjudges.STScoreJudge(embed).score_result_file(str(path))

    replies = ['{"score": 7}', "score: 6.5 of 10", 'Sure. {"note": 1} {"score": "8"}', "none",
               '{"score": null} 4']
    for r in replies:
        assert tjudges._parse_json_score(r) == jjudges._parse_json_score(r)

    class Client:
        """An OpenAI-compatible fake: the reply is chosen by the prompt."""

        def __init__(self):
            self.chat = self
            self.completions = self

        def create(self, model, messages, temperature):
            text = messages[0]["content"]
            msg = type("M", (), {"content": replies[len(text) % len(replies)]})
            return type("R", (), {"choices": [type("C", (), {"message": msg})]})

    got = tjudges.LLMJudge(Client, num_workers=3).score_result_file(
        str(path), save_path=str(tmp_path / "t.json"))
    want = jjudges.LLMJudge(Client, num_workers=3).score_result_file(
        str(path), save_path=str(tmp_path / "j.json"))
    assert got == want and got["judged"] > 0
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


# ---------------------------------------------------------- callibench tasks

FULL = [{"imagePath": f"{i}.jpg", "reference": ref}
        for i, ref in enumerate(["春眠不觉晓，", "处处闻啼鸟。", "夜來風雨聲"])]
REGION = [{"imagePath": "r.jpg", "answer": "春眠", "region": [[5, 5], [50, 70]]},
          {"image": "s.jpg", "answer": "花落", "region": [[0, 10], [40, 60]]}]
CHOICE = [{"image": f"{i}.jpg", "conversations": [
    {"from": "human", "value": "<image>\n作者是谁？\nA: 王羲之\nB: 颜真卿\nC: 柳公权"},
    {"from": "gpt", "value": "ABC"[i]}]} for i in range(2)]
REASONING = [{"image": f"{i}.jpg", "content": "床前明月光", "conversations": [
    {"from": "human", "value": "请翻译并分析这幅作品。\nA: 甲\nB: 乙" if i else "请分析创作意图。"},
    {"from": "gpt", "value": "reference answer"}]} for i in range(2)]

TASKS = {
    "full_page_seq": ("test_full_page", FULL, dict(batch_size=1)),
    "full_page_pipelined": ("test_full_page", FULL, dict(batch_size=2)),
    "full_page_no_p": ("test_full_page", FULL[:2], dict(batch_size=2, use_p=False)),
    "region_wise": ("test_region_wise", REGION, dict(batch_size=1)),
    "region_wise_pipelined": ("test_region_wise", REGION, dict(batch_size=2)),
    "choice": ("test_choice", CHOICE, dict(limit=1)),
    "choice_batched_no_p": ("test_choice", CHOICE, dict(batch_size=2, use_p=False)),
    "bilingual": ("test_bilingual", REASONING, dict(batch_size=2)),
    "intent": ("test_intent", REASONING, dict(batch_size=1)),
}


@pytest.mark.parametrize("case", list(TASKS))
def test_callibench_task_equals_jax(engines, tmp_path, case):
    jeng, teng = engines
    fn, annots, kw = TASKS[case]
    path = _parquet(str(tmp_path / "split.parquet"), annots)
    kw = dict(kw, max_new_tokens=NEW_TOKENS)
    want = getattr(jbench, fn)(jeng, path, str(tmp_path / "jax.json"), **kw)
    got = getattr(tbench, fn)(teng, path, str(tmp_path / "port.json"), **kw)
    assert got == want
    assert (tmp_path / "port.json").read_text(encoding="utf-8") == \
        (tmp_path / "jax.json").read_text(encoding="utf-8")


def test_pipelined_responses_equal_batch_chat_ocr(engines):
    """The pipelined route's responses equal the port's own batch_chat_ocr on
    the same chunks of pages."""
    _, teng = engines
    pages = [np.asarray(Image.open(io.BytesIO(_png(i))).convert("RGB")) for i in range(5)]
    kw = dict(max_new_tokens=NEW_TOKENS, repetition_penalty=1.0)
    got = tbench._pipelined_responses(teng, pages, tbench.FULL_PAGE_PROMPT, 2, **kw)
    want = [tmetrics.t2s(r) for lo in range(0, 5, 2) for r in teng.batch_chat_ocr(
        pages[lo:lo + 2], [tbench.FULL_PAGE_PROMPT] * len(pages[lo:lo + 2]), **kw)]
    assert got == want and len(got) == 5


# ------------------------------------------------------------------ CLIs


def _tree(root):
    _parquet(os.path.join(root, "full_page_ocr/easy/easy.parquet"), FULL[:2])
    _parquet(os.path.join(root, "choice/author/author.parquet"), CHOICE)
    return root


@pytest.fixture
def cli_engines(monkeypatch):
    """Records the engines the CLI builds; their generations are cut to
    NEW_TOKENS and their detector stubbed, as the fixture's engines."""
    built = []
    build = tcommon.build_engine

    def record(**kw):
        eng = build(**kw)
        eng.detector = _stub_detector
        chat_ocr, prepare = eng.chat_ocr, eng.batch_prepare
        eng.chat_ocr = lambda *a, **k: chat_ocr(*a, **{**k, "max_new_tokens": NEW_TOKENS})
        eng.batch_prepare = lambda *a, **k: prepare(*a, **{**k, "max_new_tokens": NEW_TOKENS})
        built.append((kw, eng))
        return eng

    monkeypatch.setattr(tcommon, "build_engine", record)
    return built


def _keys(obj):
    """The key structure of a result: dict keys, and each list's items."""
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return type(obj).__name__ if not isinstance(obj, (int, float)) else "number"


def test_evaluate_cli_writes_the_jax_files(engines, cli_engines, tmp_path, monkeypatch):
    """``test`` (the mode) and cli.evaluate at --device cpu: the harness's
    engine options (RGB chars, host char resize, host tiling), batch 1, the
    JAX file names and key structure."""
    jeng, _ = engines
    data = _tree(str(tmp_path / "CalliBench"))
    monkeypatch.chdir(tmp_path)
    base = ["--data", data, "--preset", "callireader-tiny", "--random-init", "--device", "cpu"]
    assert tmain.main(["test", "--type", "full_page", "--splits", "easy", "--save_name", "fp",
                       *base]) == 0
    tevaluate.main(["--type", "choice", "--splits", "author", "--save_name", "ch", *base])
    for kw, eng in cli_engines:
        assert (kw["gray_chars"], kw["device_resize_chars"], kw["device_tile_pages"]) == \
            (False, False, False)
        assert (eng.gray_chars, eng.device_resize_chars, eng.device_tile_pages) == \
            (False, False, False)
    assert len(cli_engines) == 2
    assert sorted(os.listdir(tmp_path / "outputs")) == ["ch", "fp"]
    assert os.listdir(tmp_path / "outputs/fp") == ["full_page_easy.json"]
    assert os.listdir(tmp_path / "outputs/ch") == ["author.json"]
    kw = dict(max_new_tokens=NEW_TOKENS, repetition_penalty=1.0)
    want = {"fp/full_page_easy.json": jbench.test_full_page(
                jeng, os.path.join(data, "full_page_ocr/easy/easy.parquet"), None, **kw),
            "ch/author.json": jbench.test_choice(
                jeng, os.path.join(data, "choice/author/author.parquet"), None, limit=3, **kw)[1]}
    for name, jres in want.items():
        got = json.loads((tmp_path / "outputs" / name).read_text(encoding="utf-8"))
        assert _keys(got) == _keys(jres)


def test_evaluate_cli_refusals_and_batch_default(cli_engines, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = ["--type", "full_page", "--preset", "callireader-tiny", "--random-init"]
    with pytest.raises(SystemExit):
        tevaluate.main([*base, "--device", "cpu", "--gray-chars", "--rgb-chars"])
    import torch.distributed as dist

    try:  # a mesh whose size is not the world's (a world of 1 without torchrun)
        with pytest.raises(ValueError, match="does not match 1 ranks"):
            tevaluate.main([*base, "--device", "cpu", "--mesh", "tensor=4"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    seen = []
    monkeypatch.setattr(tbench, "test_full_page", lambda *a, **kw: seen.append(kw))
    tevaluate.main([*base, "--device", "cpu", "--splits", "easy", "--gray-chars",
                    "--device-resize-chars", "--device-tile-pages"])
    assert seen[-1]["batch_size"] == 1
    kw, eng = cli_engines[-1]
    assert (eng.gray_chars, eng.device_resize_chars, eng.device_tile_pages) == (True, True, True)
    # on the GPU the pipelined batch of 8 (the engine built on the CPU here)
    monkeypatch.setattr(tcommon, "build_engine", lambda **kw: eng)
    tevaluate.main([*base, "--splits", "easy"])
    assert seen[-1]["batch_size"] == 8


def test_mmbench_refcoco_and_judge_modes(engines, cli_engines, tmp_path, monkeypatch, capsys):
    """``mmbench`` and refcoco through cli.evaluate (results equal the JAX
    functions' on the fixture's engines), ``judge`` through the mode table."""
    import base64

    jeng, teng = engines
    monkeypatch.chdir(tmp_path)
    rows = [{"index": str(i), "question": f"问题{i}", "hint": "nan", "A": "甲", "B": "乙",
             "C": "丙", "answer": "AB"[i % 2], "image": base64.b64encode(_png(i)).decode()}
            for i in range(3)]
    tsv = tmp_path / "mmbench.tsv"
    with open(tsv, "w", encoding="utf-8") as f:
        f.write("\t".join(rows[0]) + "\n")
        f.writelines("\t".join(r.values()) + "\n" for r in rows)
    base = ["--preset", "callireader-tiny", "--random-init", "--device", "cpu"]
    assert tmain.main(["mmbench", "--data-path", str(tsv), "--save_name", "mm", *base]) == 0
    res = json.loads((tmp_path / "outputs/mm/mmbench.xlsx").read_text(encoding="utf-8"))
    assert res["total"] == 3 and res["scored"] == 3 and len(res["detailed"]) == 3
    want = jmmbench.evaluate_mmbench(jeng, str(tsv), batch_size=2, max_new_tokens=NEW_TOKENS)
    got = tmmbench.evaluate_mmbench(teng, str(tsv), batch_size=2, max_new_tokens=NEW_TOKENS)
    assert got == want

    np.save(tmp_path / "a.npy", np.asarray(Image.open(io.BytesIO(_png(0))).convert("RGB")))
    samples = [{"image": str(tmp_path / "a.npy"), "sents": "左边的字", "bbox": [4, 5, 20, 30],
                "height": 80, "width": 60}]
    (tmp_path / "ref.json").write_text(json.dumps(samples, ensure_ascii=False), encoding="utf-8")
    tevaluate.main(["--type", "refcoco", "--data-path", str(tmp_path / "ref.json"),
                    "--save_name", "rc", *base])
    assert set(json.loads((tmp_path / "outputs/rc/refcoco.json").read_text())) == {"accuracy"}
    img = np.load(tmp_path / "a.npy")
    s = [dict(samples[0], image=img)]
    assert trefcoco.evaluate_refcoco(teng, s, max_new_tokens=NEW_TOKENS) == \
        jrefcoco.evaluate_refcoco(jeng, s, max_new_tokens=NEW_TOKENS)

    bil = tmp_path / "bilingual.json"
    bil.write_text(json.dumps({"detailed": [{"answer": "hello world", "gt": "hello world"}]}))
    monkeypatch.setitem(sys.modules, "sentence_transformers", None)  # the fallback embedder
    capsys.readouterr()
    assert tmain.main(["judge", "--type", "bilingual", "--input", str(bil),
                       "--save", str(tmp_path / "st.json")]) == 0
    out = capsys.readouterr()
    assert json.loads(out.out.strip().splitlines()[-1]) == \
        json.loads((tmp_path / "st.json").read_text())
    assert json.loads((tmp_path / "st.json").read_text())["n"] == 1
    assert "hash-embedding fallback" in out.err
    with pytest.raises(SystemExit) as e:  # the mode runs; its subcommand is required
        tmain.main(["preprocess"])
    assert e.value.code == 2


def test_apis_evaluate_full_page(engines, tmp_path):
    jeng, teng = engines
    path = _parquet(str(tmp_path / "easy.parquet"), FULL[:1])
    got = apis.evaluate_full_page(teng, path, str(tmp_path / "fp.json"), max_new_tokens=NEW_TOKENS)
    assert got == jbench.test_full_page(jeng, path, None, max_new_tokens=NEW_TOKENS)
    assert json.loads((tmp_path / "fp.json").read_text(encoding="utf-8")) == got
