"""The port's agent and last modes against the JAX package on the CPU: the
tool plugins, the ReAct agent, ``chat --agent``, the mode table
(``copy-cfg``, ``log-dataset``, ``preprocess``) and the train CLI's
``--eval-chat-interval``.

The plugins and the agent are host code: their strings must be equal. The
CLIs run the tiny preset at FP32 on both sides with the same parameters
(``init_all_params`` carried across by ``from_jax_params``): what they print
must be equal, and each eval chat's response must equal the JAX engine's
``chat`` on the same trained tree carried back.
"""

import io
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from callireader_tpu import __main__ as jmain
from callireader_tpu.cli import chat as jchat
from callireader_tpu.cli import common as jcommon
from callireader_tpu.core.config import callireader_tiny
from callireader_tpu.core.dtypes import FP32_POLICY as J_FP32
from callireader_tpu.runtime import agent as jagent
from callireader_tpu.runtime import plugins as jplugins
from callireader_tpu.runtime.engine import CalliReaderEngine as JEngine
from callireader_tpu.runtime.engine import init_all_params
from callireader_tpu.runtime.tokenizer import InternLM2Tokenizer as JTok
from callireader_tpu_torch import __main__ as tmain
from callireader_tpu_torch.cli import chat as tchat
from callireader_tpu_torch.cli import common as tcommon
from callireader_tpu_torch.cli import train as ttrain
from callireader_tpu_torch.core.config import callireader_tiny as t_tiny
from callireader_tpu_torch.core.dtypes import FP32_POLICY as T_FP32
from callireader_tpu_torch.runtime import agent as tagent
from callireader_tpu_torch.runtime import plugins as tplugins
from callireader_tpu_torch.runtime.engine import CalliReaderEngine as TEngine
from callireader_tpu_torch.runtime.tokenizer import InternLM2Tokenizer as TTok
from callireader_tpu_torch.runtime.weights import from_jax_params

JCFG = callireader_tiny()
TOKENIZER = "callireader_tpu/assets/tokenizer.model"

EXPRESSIONS = ["1+2*3", "2^10", "sqrt(2);pi*2", "1/0", "import os", "3//2; 7%3", "-5+abs(-2)",
               "factorial(5)/log(e)", "round(2.567, 1)", "sin(pi/2)+cos(0)", "x+1", "2**0.5"]
# linear systems, and inputs that fail to parse: the port's sympy route
# prints what the JAX module's prints
SYSTEMS = ["x+y=2, x-y=0", "2x+3y=7; x-y=1", "x=3", "3x=1", "x+y=1,x+y=2", "2*(x+1)=5",
           "0.5x=2", "x+2y+z=4, y-z=1, x+z=2", "a-b=-3, a+b=5", "(x+1)*3=9",
           "x/3+y/4=1, x-y=2", "y=2x+1, y=3", "foo(", "2x=x+1", "-x=4", "x=1.5",
           "x+y=2, x-y=0, 2x=2", "2^3x=16", "x - 0.1 = 0.2", "x = pi"]


def test_plugins_match_jax():
    for e in EXPRESSIONS:
        assert tplugins.calculate(e) == jplugins.calculate(e), e
    for s in SYSTEMS:
        assert tplugins.solve_equations(s) == jplugins.solve_equations(s), s
    turn = ('先算 Calculate("12*(3+4);2^8") 再解 Solve("x+y=10, x-y=2") 最后 Search("王羲之") '
            'and calculator("1/3")')
    for kw in ({}, {"calculate_open": False}, {"search_fn": lambda q: f"found {q}"},
               {"solve_open": False, "search_open": False}):
        assert tplugins.plugins_api(turn, **kw) == jplugins.plugins_api(turn, **kw), kw
    ids = TTok().encode("答案是42<eoa>", add_bos=False)
    for word in ("<eoa>", "42", "", "答"):
        assert tplugins.StopWordCriteria(TTok(), word)(ids) == \
            jplugins.StopWordCriteria(JTok(TOKENIZER), word)(ids), word


@pytest.mark.parametrize("system", ["x^2=4", "x*y=2, x+y=3", "1/x=2", "x+y", "x+y=1,2x+2y=2"])
def test_solve_refuses_what_is_not_a_determined_linear_system(system):
    """Nonlinear and underdetermined systems: the port solves them through
    sympy, as the JAX module does, and prints the same text (the name is
    kept from when the port refused them)."""
    want = jplugins.solve_equations(system)
    assert want not in ("No result.", "No solution.")
    assert tplugins.solve_equations(system) == want


def test_agent_prompts_are_byte_equal():
    assert tagent.CALL_PROTOCOL == jagent.CALL_PROTOCOL
    assert tagent.FORCE_STOP == jagent.FORCE_STOP
    assert tagent._ACTION_RE.pattern == jagent._ACTION_RE.pattern
    assert tagent._INPUT_RE.pattern == jagent._INPUT_RE.pattern
    assert {k: v[0] for k, v in tagent.default_tools().items()} == \
        {k: v[0] for k, v in jagent.default_tools().items()}
    assert tagent.ReActAgent(None)._protocol("问") == jagent.ReActAgent(None)._protocol("问")


def _solver_tool(received):
    def tool(s):
        received.append(s)
        return "x=1, y=1"

    return {"solve": ("solver", tool)}


# the scripts of tests/test_engine_extras.py::test_react_agent_loop and
# ::test_agent_multiline_action_input, the unknown-tool and force-stop cases,
# and more: (model turns, max_turns, tools)
SCRIPTS = {
    "calculate then answer": (["Thought: 需要算一下\nAction: calculate\nAction Input: 6*7\n",
                               "Final Answer: 答案是42"], 4, None),
    "unknown tool": (["Action: google\nAction Input: x\n", "Final Answer: ok"], 4, None),
    "force stop": (["Thought: 继续\nAction: calculate\nAction Input: 1+1\n"] * 3, 2, None),
    "force stop after solve": (["Thought: 解\nAction: solve\nAction Input: x+y=2, x-y=0\n"] * 5,
                               4, None),
    "multiline action input": (["Thought: 解方程\nAction: solve\nAction Input: x+y=2,\nx-y=0",
                                "Final Answer: x=1, y=1"], 4, "solver"),
    "no action": (["just some text\n", "unused"], 4, None),
    "tool error": (["Action: （search）\nAction Input: 王羲之\n", "Action: calculate\nAction Input:",
                    "Final Answer:  done "], 4, "raising"),
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_react_agent_matches_jax(name):
    turns, max_turns, tools = SCRIPTS[name]
    out = {}
    for label, module in (("jax", jagent), ("port", tagent)):
        script, prompts, received = iter(turns), [], []

        def chat_fn(q, hist, script=script, prompts=prompts):
            prompts.append(q)
            return next(script), (hist or []) + [q]

        kw = {}
        if tools == "solver":
            kw["tools"] = _solver_tool(received)
        elif tools == "raising":
            kw["tools"] = {**module.default_tools(), "search": ("s", lambda s: 1 / 0)}
        agent = module.ReActAgent(chat_fn, max_turns=max_turns, **kw)
        answer = agent.chat("6乘7是多少")
        out[label] = (answer, prompts, agent.history, received)
        agent.reset()
        assert agent.history is None
    assert out["port"] == out["jax"]
    if name == "calculate then answer":
        assert out["port"][0] == "答案是42" and "42.00" in out["port"][1][1]
    if name == "force stop":
        assert len(out["port"][1]) == 3 and "已达到最大工具调用轮数" in out["port"][0]
    if name == "multiline action input":
        assert out["port"][3] == ["x+y=2,\nx-y=0"]


@pytest.fixture(scope="module")
def params():
    return init_all_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)


def _port_engine(params):
    return TEngine(t_tiny(), from_jax_params(jax.tree_util.tree_map(np.asarray, params), device="cpu"),
                   TTok(), device="cpu", policy=T_FP32)


def test_chat_agent_cli_matches_jax(params, monkeypatch, capsys):
    """``chat --agent`` with a scripted stdin (two questions around a RESET)
    prints what the JAX CLI prints; each agent turn is a stream_generate call
    that stops at "Response:"."""
    jeng = JEngine(JCFG, params, JTok(TOKENIZER), policy=J_FP32, use_flash=False)
    teng = _port_engine(params)
    monkeypatch.setattr(jcommon, "build_engine", lambda **kw: jeng)
    monkeypatch.setattr(tcommon, "build_engine", lambda **kw: teng)
    calls = {"jax": [], "port": []}
    for name, module in (("jax", jchat), ("port", tchat)):
        orig = module.stream_generate

        def spy(*a, _orig=orig, _name=name, **kw):
            calls[_name].append(kw.get("stop_words"))
            return _orig(*a, **kw)

        monkeypatch.setattr(module, "stream_generate", spy)
    printed = {}
    for name, main in (("jax", jchat.main), ("port", tchat.main)):
        monkeypatch.setattr(sys, "stdin", io.StringIO("3加4等于几？\n\nRESET\n写一个字\nEXIT\n"))
        argv = ["--agent", "--random-init", "--preset", "callireader-tiny", "--max-new-tokens", "6"]
        main(argv + (["--device", "cpu"] if name == "port" else []))
        printed[name] = capsys.readouterr()
    assert printed["port"].out == printed["jax"].out
    assert printed["port"].err == printed["jax"].err
    assert printed["port"].out.count("assistant> ") == 2
    assert calls["port"] == calls["jax"] and calls["port"] and \
        all(w == ("Response:",) for w in calls["port"])


def test_mode_table_matches_jax(monkeypatch, tmp_path, capsys):
    assert tmain.MODES == jmain.MODES
    assert "Not ported" not in tmain.HELP and "not ported" not in tmain.HELP
    seen = []
    monkeypatch.setattr(ttrain, "main", lambda rest: seen.append(rest))
    assert tmain.main(["log-dataset", "--data", "a.jsonl"]) == 0
    assert tmain.main(["check-custom-dataset", "--data", "a.jsonl"]) == 0
    assert seen == [["--data", "a.jsonl"], ["--check-data", "--data", "a.jsonl"]]
    src = tmp_path / "arxiv.jsonl"
    src.write_text(json.dumps({"categories": "cs.CL", "update_date": "2021-05-01"}) + "\n")
    assert tmain.main(["preprocess", "arxiv", str(src), str(tmp_path / "o.json")]) == 0
    assert "kept 1 arxiv records" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        tmain.main(["preprocess"])  # a subcommand is required, as in JAX


def _cli_data(root, hidden, n=2):
    rng = np.random.default_rng(0)
    ann = []
    for i in range(n):
        np.save(root / f"s{i}.npy", rng.integers(0, 255, (64, 48, 3), dtype=np.uint8))
        np.save(root / f"e{i}.npy", rng.standard_normal((2, 3, hidden), dtype=np.float32))
        ann.append({"image": f"s{i}.npy", "embedding": f"e{i}.npy", "conversations": [
            {"from": "human", "value": "读出图中所有文字。"},
            {"from": "gpt", "value": "春眠不觉晓处处闻啼鸟"}]})
    (root / "ann.jsonl").write_text("".join(json.dumps(a, ensure_ascii=False) + "\n" for a in ann))


def test_train_eval_chat_matches_jax(params, tmp_path, monkeypatch, capsys):
    """``train --eval-chat-interval 1``: one ``[eval-chat @k]`` line per
    update, each response the JAX engine's ``chat`` on the same merged tree
    (LoRA adapters and all) carried back; the chats read the live adapters,
    which move between them."""
    _cli_data(tmp_path, JCFG.llm.hidden_size)
    teng = _port_engine(params)
    monkeypatch.setattr(tcommon, "build_engine", lambda **kw: teng)
    seen = []
    chat = teng.chat

    def keep(*a, **kw):
        resp = chat(*a, **kw)
        llm = {k: v.detach().numpy().copy() if isinstance(v, torch.Tensor) else
               {n: t.detach().numpy().copy() for n, t in v.items()}
               for k, v in teng.params["llm"].items()}
        seen.append((a, kw, resp, llm))
        return resp

    monkeypatch.setattr(teng, "chat", keep)
    ttrain.main(["--data", str(tmp_path / "ann.jsonl"), "--image-root", str(tmp_path),
                 "--out", str(tmp_path / "out"), "--config", "e_it", "--preset", "callireader-tiny",
                 "--random-init", "--device", "cpu", "--lora-rank", "4", "--lora-alpha", "8",
                 "--max-iters", "2", "--grad-accum", "1", "--lr", "1e-2", "--ckpt-interval", "0",
                 "--eval-chat-interval", "1", "--eval-chat-prompt", "写一个字"])
    err = capsys.readouterr().err
    lines = [ln for ln in err.splitlines() if ln.startswith("[eval-chat @")]
    assert lines == [f"[eval-chat @{k}] {seen[k - 1][2]!r}" for k in (1, 2)]
    assert [s[:2] for s in seen] == [((None, "写一个字"), {"max_new_tokens": 32})] * 2
    assert not np.array_equal(seen[0][3]["layers"]["wq_lora_b"], seen[1][3]["layers"]["wq_lora_b"])
    jeng = JEngine(JCFG, dict(params), JTok(TOKENIZER), policy=J_FP32, use_flash=False)
    for (a, kw, resp, llm) in seen:
        jeng.params = dict(jeng.params, llm=jax.tree_util.tree_map(jnp.asarray, llm))
        assert jeng.chat(*a, **kw) == resp
