"""The port's measurement scripts (callireader_tpu_torch/scripts/bench_*.py and
mb_scan_int8.py) on the CPU at callireader-tiny with tiny counts, in process.

Each prints one JSON line whose keys are the JAX script's (read from
scripts/<name>.py with ``ast``: no JAX script runs) with the port's changes:
``device`` (the card's name and power limit, "cpu" here) and ``platform``
added, and bench_decode's ``roofline_ms_at_800gbps`` (a TPU's HBM) renamed
``roofline_ms_at_3350gbps`` (the H100's). The workloads are held to the JAX
scripts' own code: bench_serving's requests to the JAX ``reqs`` closure and
bench_8b_int8's int8 leaves to the JAX ``ship`` closure and ``_quant_rows``,
each executed from the JAX script's source over numpy stubs of the model.
Integer and id comparisons are exact.
"""

import ast
import importlib.util
import io
import json
import math
import re
import types
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

from callireader_tpu_torch.core.config import callireader_tiny
from callireader_tpu_torch.scripts import (bench_8b_int8, bench_decode, bench_http, bench_prefix,
                                           bench_serving, bench_train_step, bench_vit,
                                           mb_scan_int8)

REPO = Path(__file__).resolve().parents[1]
TINY = ["--preset", "callireader-tiny", "--device", "cpu"]
RENAMED = {"roofline_ms_at_800gbps": "roofline_ms_at_3350gbps"}
PORT_KEYS = {"device", "platform"}


def _jax_source(name):
    return ast.parse((REPO / "scripts" / f"{name}.py").read_text())


def jax_keys(name):
    """Every key the JAX script's JSON line can carry: the dict literal with
    a "metric" key and any ``out["..."] =`` added to it."""
    keys = set()
    for node in ast.walk(_jax_source(name)):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric" for k in node.keys):
            keys |= {k.value for k in node.keys}
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript) \
                and isinstance(node.targets[0].value, ast.Name) \
                and node.targets[0].value.id == "out":
            keys.add(node.targets[0].slice.value)
    assert "metric" in keys
    return {RENAMED.get(k, k) for k in keys} | PORT_KEYS


def _jax_main_nodes(name, pick):
    """The statements of the JAX script's ``main`` that ``pick`` selects,
    compiled as a module."""
    main = next(n for n in _jax_source(name).body if isinstance(n, ast.FunctionDef)
                and n.name == "main")
    return compile(ast.fix_missing_locations(ast.Module([n for n in main.body if pick(n)], [])),
                   f"scripts/{name}.py", "exec")


def _run(mod, argv, **kw):
    """mod.main(argv) -> (its printed JSON lines, its return value)."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        ret = mod.main(argv, **kw)
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
    assert lines and buf.getvalue().splitlines()[-1].startswith("{")
    return lines, ret


def _check_line(line, name, differences=()):
    """The JAX script's keys with the port's changes; finite numbers, each
    positive but ``differences`` (of two wall times: at this size their sign
    is the CPU's noise)."""
    assert set(line) == jax_keys(name)
    assert line["device"] == "cpu" and line["platform"] == "cpu"
    for k, v in line.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            assert math.isfinite(v) and (k in differences or v >= 0), (k, v)
    assert "value" in differences or line["value"] > 0


def test_bench_decode_line():
    (line,), ret = _run(bench_decode, TINY + ["--batch", "2", "--prompt", "24", "--tokens", "8"])
    assert line == ret
    _check_line(line, "bench_decode")
    assert line["use_flash"] is False and line["tokens"] == 8
    assert line["roofline_ms_at_3350gbps"] == pytest.approx(
        line["hbm_gb_per_step"] / 3350 * 1e3, rel=1e-12)
    with pytest.raises(ValueError, match="card"):
        bench_decode.main(TINY + ["--use-flash", "1"])


@pytest.mark.parametrize("shared", [0, 16])
def test_bench_serving_requests_equal_the_jax_recipe(shared):
    """Two calls of the JAX ``reqs`` closure (the warm-up wave and the timed
    run), run from the JAX script's source over numpy stubs, against two
    calls of ``Workload.requests``: the same uids, ids and lengths."""
    args = types.SimpleNamespace(requests=5, prompt_len=24, shared_prefix=shared, max_new=12)
    ns = {
        "np": np, "args": args, "params": None,
        "jnp": types.SimpleNamespace(asarray=np.asarray, bfloat16=None),
        "internlm2": types.SimpleNamespace(embed_tokens=lambda p, ids, dt: ids),
        "Request": lambda **kw: types.SimpleNamespace(**kw),
    }
    code = _jax_main_nodes("bench_serving", lambda n: (
        isinstance(n, ast.FunctionDef) and n.name == "reqs") or (
        isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
        and n.targets[0].id in ("rng", "shared_ids")))
    exec(code, ns)
    work = bench_serving.Workload(args.requests, args.prompt_len, args.shared_prefix,
                                  args.max_new)
    np.testing.assert_array_equal(work.shared_ids, ns["shared_ids"])
    for _ in range(2):
        want = [(r.uid, np.asarray(r.embeds), r.max_new_tokens) for r in ns["reqs"]()]
        got = work.requests()
        assert [(u, n) for u, _, n in got] == [(u, n) for u, _, n in want]
        for (_, ids, _), (_, jids, _) in zip(got, want):
            np.testing.assert_array_equal(ids, jids)
    assert work.lengths() == [6, 7, 9, 10, 12]


@pytest.mark.parametrize("mode", ["contiguous", "paged_int8_prefix"])
def test_bench_serving_line(mode):
    argv = TINY + ["--slots", "2", "--requests", "3", "--max-new", "6", "--prompt-len", "24",
                   "--max-len", "256"]
    if mode != "contiguous":
        argv = TINY + ["--slots", "2", "--requests", "3", "--max-new", "6", "--max-len", "512",
                       "--paged", "--quant", "int8", "--steps-per-sync", "2",
                       "--prompt-len", "140", "--shared-prefix", "130", "--prefix-cache"]
    (line,), _ = _run(bench_serving, argv)
    _check_line(line, "bench_serving")
    assert line["total_tokens"] == sum(bench_serving.Workload(3, 24, 0, 6).lengths())
    if mode != "contiguous":
        assert line["paged"] and line["quant"] == "int8" and line["prefix_hits"] == 3


def test_bench_http_answers_every_request():
    (line,), _ = _run(bench_http, TINY + ["--slots", "2", "--requests", "3", "--max-tokens", "4",
                                          "--max-len", "256", "--stream"])
    _check_line(line, "bench_http")  # ttfd_p50_s among the keys: --stream
    assert line["requests"] == 3 and line["stream"] is True


def test_bench_prefix_line():
    checks = {}
    (line,), _ = _run(bench_prefix, TINY + ["--rows", "2", "--prompt", "40", "--prefix", "32",
                                            "--iters", "1"], checks=checks)
    _check_line(line, "bench_prefix")
    assert checks["logits_rel_err"] <= bench_prefix.LOGITS_REL_TOL


def test_bench_train_step_line():
    (line,), _ = _run(bench_train_step, TINY + ["--batch", "2", "--seq", "64", "--iters", "1",
                                                "--lora-rank", "4"])
    _check_line(line, "bench_train_step")
    assert line["mesh"] == {"data": 1, "fsdp": 1, "tensor": 1, "seq": 1}
    assert 0 < line["loss"] < 20


def test_bench_vit_both_runs_the_two_routes():
    checks = {}
    lines, ret = _run(bench_vit, TINY + ["--tiles", "3", "--iters", "1", "--attn-impl", "both"],
                      checks=checks)
    assert lines == ret and len(lines) == 2
    for line in lines:
        _check_line(line, "bench_vit")
    # on the CPU both routes are the plain version, and say so
    assert [x["attn_impl"] for x in lines] == ["auto=plain", "reference=plain"]
    assert checks["encode_rel_err"] <= bench_vit.ENCODE_REL_TOL


def _jax_bench_8b():
    spec = importlib.util.spec_from_file_location("jax_bench_8b_int8",
                                                  REPO / "scripts" / "bench_8b_int8.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)  # top level: no JAX import (main imports it)
    return mod


def test_bench_8b_int8_leaves_equal_the_jax_quant_rows():
    """The JAX ``ship`` closure with the JAX ``_quant_rows``, run from the
    script's source on the same RandomState, against the port's int8 tree
    at a tiny config: every int8 leaf and scale equal, each stacked leaf a
    real (L, K, N) tensor, and the stream left where the JAX script draws its
    prompt."""
    import torch

    jmod = _jax_bench_8b()
    cfg = callireader_tiny().llm
    L, E, M = 3, cfg.hidden_size, cfg.intermediate_size
    Hq, Hkv, D, V = (cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim,
                     cfg.vocab_size)
    ns = {"np": np, "rng": np.random.RandomState(0), "_quant_rows": jmod._quant_rows,
          "jnp": types.SimpleNamespace(asarray=np.asarray)}
    exec(_jax_main_nodes("bench_8b_int8", lambda n: isinstance(n, ast.FunctionDef)
                         and n.name == "ship"), ns)
    want = {name: ns["ship"](name, shape, 1) for name, shape in (
        ("wqkv", (L, E, (Hq + 2 * Hkv) * D)), ("wo", (L, Hq * D, E)),
        ("w13", (L, E, 2 * M)), ("w2", (L, M, E)))}
    want.update({name: ns["ship"](name, (V, E), 1) for name in ("tok_embeddings", "output")})

    host, rng = bench_8b_int8.host_draws(cfg)
    params, pcfg = bench_8b_int8.build_params(host, cfg, torch.device("cpu"), L)
    assert pcfg.num_hidden_layers == L and pcfg.vocab_size % 128 == 0
    assert pcfg.real_vocab_size == V
    for name in bench_8b_int8.LAYER_LEAVES:
        for suffix, w in zip(("_q", "_scale"), want[name]):
            t = params["layers"][name + suffix]
            assert t.is_contiguous() and t.untyped_storage().nbytes() == t.numel() * t.element_size()
            np.testing.assert_array_equal(t.numpy(), w)
    for name in bench_8b_int8.VOCAB_LEAVES:
        for suffix, w in zip(("_q", "_scale"), want[name]):
            t = params[name + suffix].numpy()
            np.testing.assert_array_equal(t[:V], w)
            assert not t[V:].any()  # the vocabulary's pad rows
    np.testing.assert_array_equal(rng.randint(10, 90000, (2, 8)),
                                  ns["rng"].randint(10, 90000, (2, 8)))


def test_bench_8b_int8_line():
    (line,), _ = _run(bench_8b_int8, ["--batch", "2", "--prompt", "16", "--tokens", "16",
                                      "--device", "cpu"], num_layers=2, cfg=callireader_tiny().llm)
    _check_line(line, "bench_8b_int8", differences=("value",))  # d(total)/d(tokens)
    assert line["fits_single_chip"] is None  # measured on the card only


def test_mb_scan_int8_variants_agree():
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = mb_scan_int8.run(L=3, K=256, N=384, M=8, which=("stacked", "unrolled"),
                               device="cpu", n=1)
    assert out["same_bits"] and set(out["variants"]) == {"stacked", "unrolled"}
    assert out["bytes_per_pass"] == 3 * 256 * 384
    for name, v in out["variants"].items():
        assert v["gbps"] == pytest.approx(out["bytes_per_pass"] / (v["ms"] / 1e3) / 1e9)
        # the JAX script's line, with the share of 3.35 TB/s beside it
        assert re.search(rf"^{name}\s*: +[0-9.]+ ms  -> +[0-9.]+ GB/s effective int8-weight BW "
                         rf"\([0-9.]+% of 3.35 TB/s\)$", buf.getvalue(), re.M)
    with pytest.raises(ValueError, match="card"):
        mb_scan_int8.run(L=2, K=256, N=384, which=("graph",), device="cpu")


@pytest.mark.parametrize("mod", [bench_decode, bench_serving, bench_http, bench_prefix,
                                 bench_train_step, bench_vit, bench_8b_int8, mb_scan_int8],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_scripts_default_to_the_card(mod):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
