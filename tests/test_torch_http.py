"""Port serving front ends on the CPU at the tiny preset: host tiling against
the JAX package, ``parse_chat_messages``, the JSONL CLI (paged and contiguous)
and a loopback HTTP server.

The CLI builds its own engine from a torch seed, so it cannot share weights
with the JAX CLI: its output is held to the port's batcher driven directly on
an engine built from the same seed (token ids and text equal). Host tiling is
integer arithmetic (vision/resample.py reproduces PIL's fixed-point BICUBIC),
so the tiles must equal the JAX package's PIL tiles exactly (tolerance 0).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from callireader_tpu.vision import preprocess as jpre
from callireader_tpu_torch.cli import serve
from callireader_tpu_torch.runtime import generate as tgen
from callireader_tpu_torch.runtime import http_server
from callireader_tpu_torch.runtime.conversation import build_chat_prompt
from callireader_tpu_torch.runtime.engine import build_engine
from callireader_tpu_torch.runtime.paged_cache import PagedBatcher
from callireader_tpu_torch.runtime.serving import ContinuousBatcher, Request
from callireader_tpu_torch.vision import preprocess as tpre


def _page(seed, h, w):
    return np.random.default_rng(seed).integers(120, 255, (h, w, 3), dtype=np.uint8)


# ------------------------------------------------------------ host tiling


@pytest.mark.parametrize("h,w,size,max_num", [(200, 79, 56, 12), (90, 140, 56, 6), (50, 50, 56, 12)])
def test_host_load_image_matches_jax(h, w, size, max_num):
    page = _page(h + w, h, w)
    want = jpre.load_image(page, size, max_num, True, as_uint8=True)
    got = tpre.load_image(page, size, max_num, True)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert (got == want).all()
    cols, rows = tpre.tile_grid(w, h, max_num=max_num, image_size=size)
    assert got.shape[0] == cols * rows + (1 if cols * rows > 1 else 0)


# ------------------------------------------------------------ messages


def test_parse_chat_messages():
    q, hist, system, image = http_server.parse_chat_messages([
        {"role": "system", "content": "你是书法助手。"},
        {"role": "user", "content": "你好"},
        {"role": "assistant", "content": "你好！"},
        {"role": "user", "content": [{"type": "text", "text": "这幅作品"}, {"type": "text", "text": "的风格？"}]},
    ])
    assert (q, hist, system, image) == ("这幅作品\n的风格？", [("你好", "你好！")], "你是书法助手。", None)
    for bad in ([{"role": "assistant", "content": "x"}],
                [{"role": "critic", "content": "x"}, {"role": "user", "content": "y"}],
                [{"role": "user", "content": 3}],
                [{"role": "user", "content": [{"type": "audio"}]}],
                [{"role": "user", "content": [{"type": "image_url", "image_url": {"url": "data:,x"}}]},
                 {"role": "assistant", "content": "a"}, {"role": "user", "content": "b"}]):
        with pytest.raises(ValueError):
            http_server.parse_chat_messages(bad)
    with pytest.raises(ValueError, match="remote"):
        http_server.decode_image_ref("https://example.com/x.jpg")
    with pytest.raises(ValueError, match="unreadable"):
        http_server.decode_image_ref("no/such/file.png")


def test_decode_image_ref_reads_a_data_uri():
    Image = pytest.importorskip("PIL.Image")
    import base64
    import io

    page = _page(1, 20, 30)
    buf = io.BytesIO()
    Image.fromarray(page).save(buf, format="PNG")
    uri = "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()
    assert (http_server.decode_image_ref(uri) == page).all()


# ------------------------------------------------------------ JSONL CLI


@pytest.fixture(scope="module")
def engine():
    return build_engine("callireader-tiny", device="cpu")


def _direct(engine, batcher, recs, images):
    """The CLI's request preparation, driven by hand: same prompt rows into
    ``batcher`` -> {uid: (text, n_tokens)}."""
    cfg = engine.cfg
    eos = (engine.tok.convert_tokens_to_ids("<|im_end|>"),)
    for uid, rec in enumerate(recs):
        question, feats, n_tiles = rec["question"], None, 0
        if rec.get("image"):
            px = tpre.load_image(images[rec["image"]], cfg.force_image_size,
                                 cfg.max_dynamic_patch, cfg.use_thumbnail)
            feats, n_tiles = engine.encode_image_tiles(engine._to_dev(px)), px.shape[0]
            question = "<image>\n" + question
        query = engine._expand_image_tokens(build_chat_prompt(question).get_prompt(),
                                            [n_tiles] if n_tiles else [])
        ids = engine._tokenize_prompt(query)
        bucket = tgen.bucket_length(len(ids))
        embeds, _ = engine._build_row_embeds(ids, feats, None, bucket)
        row = embeds[0, bucket - len(ids):].float().cpu().numpy()
        batcher.submit(Request(uid, row, max_new_tokens=rec["max_new_tokens"], eos_token_ids=eos))
    out = {}
    for r in batcher.run():
        assert r.error is None
        text = engine.tok.decode(r.tokens, skip_special_tokens=True)
        out[r.uid] = (text.split("<|im_end|>")[0].strip(), len(r.tokens))
    return out


@pytest.mark.parametrize("mode", ["contiguous", "paged", "paged_windowed"])
def test_serve_jsonl_matches_the_batcher_driven_directly(engine, tmp_path, mode):
    Image = pytest.importorskip("PIL.Image")
    page = _page(0, 80, 60)
    img_path = str(tmp_path / "p.png")
    Image.fromarray(page).save(img_path)
    recs = [
        {"id": "a", "question": "你好", "max_new_tokens": 3},
        {"id": "b", "question": "这幅书法作品内容是什么？", "image": img_path, "use_p": False,
         "max_new_tokens": 3},
        {"id": "c", "question": "作者是谁？", "max_new_tokens": 2},
        {"id": "big", "question": "字" * 9000, "max_new_tokens": 2},
    ]
    inp, out = tmp_path / "in.jsonl", tmp_path / "out.jsonl"
    inp.write_text("\n".join(json.dumps(r, ensure_ascii=False) for r in recs))
    flags = {"contiguous": [], "paged": ["--paged"],
             "paged_windowed": ["--paged", "--steps-per-sync", "4"]}[mode]
    serve.main(["--input", str(inp), "--output", str(out), "--slots", "2", "--max-len", "512",
                "--preset", "callireader-tiny", "--random-init", "--device", "cpu", *flags])
    lines = [json.loads(line) for line in open(out)]
    assert [l["id"] for l in lines] == ["a", "b", "c", "big"]
    assert "error" in lines[3] and "response" not in lines[3]  # fails the request, not the server

    llm, cfg = engine.params["llm"], engine.cfg.llm
    if mode == "contiguous":
        b = ContinuousBatcher(llm, cfg, num_slots=2, max_len=512, policy=engine.policy)
    else:
        b = PagedBatcher(llm, cfg, num_slots=2, num_pages=9, page_size=128, max_pages_per_slot=4,
                         policy=engine.policy, steps_per_sync=4 if mode == "paged_windowed" else 1)
    want = _direct(engine, b, recs[:3], {img_path: page})
    for uid, line in enumerate(lines[:3]):
        assert (line["response"], line["n_tokens"]) == want[uid]
        assert line["n_tokens"] == recs[uid]["max_new_tokens"]


def test_serve_cli_refuses_to_run_without_weights(tmp_path):
    with pytest.raises(FileNotFoundError, match="random-init"):
        serve.main(["--input", "x", "--output", "y", "--preset", "callireader-tiny",
                    "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--preset", "callireader-tiny", "--random-init", "--device", "cpu"])


# ------------------------------------------------------------ HTTP


def _post(port, path, obj, timeout=300):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(port, path, timeout=60):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return json.loads(r.read())


def _sse_chunks(port, obj, timeout=300):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions",
                                 data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    chunks = []
    with urllib.request.urlopen(req, timeout=timeout) as r:
        assert r.headers["Content-Type"].startswith("text/event-stream")
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            payload = line[len("data: "):]
            if payload == "[DONE]":
                chunks.append("[DONE]")
                break
            chunks.append(json.loads(payload))
    return chunks


@pytest.fixture(scope="module")
def http(engine):
    batcher = PagedBatcher(engine.params["llm"], engine.cfg.llm, num_slots=2, num_pages=9,
                           page_size=128, max_pages_per_slot=4, policy=engine.policy)
    server, loop = http_server.serve_http(engine, batcher, port=0, model_name="tiny")
    port = server.server_address[1]
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield port, loop, batcher
    server.shutdown()
    loop.shutdown()
    server.server_close()
    t.join(timeout=30)
    assert not t.is_alive() and not loop._thread.is_alive()


def test_http_health_and_models(http):
    port, _, _ = http
    h = _get(port, "/health")
    assert h["status"] == "ok" and h["slots_total"] == 2
    assert _get(port, "/v1/models")["data"][0]["id"] == "tiny"
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(port, "/nope")
    assert e.value.code == 404


def test_http_stream_matches_nonstream(http):
    port, _, _ = http
    body = {"messages": [{"role": "user", "content": "作者是谁？"}], "max_tokens": 6}
    ref = _post(port, "/v1/chat/completions", body)
    assert ref["object"] == "chat.completion"
    assert ref["choices"][0]["finish_reason"] == "length"  # random weights never hit eos
    assert ref["usage"]["completion_tokens"] == 6
    assert ref["usage"]["total_tokens"] == ref["usage"]["prompt_tokens"] + 6
    chunks = _sse_chunks(port, {**body, "stream": True})
    assert chunks[-1] == "[DONE]"
    assert chunks[0]["choices"][0]["delta"].get("role") == "assistant"
    text = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks[:-1])
    finals = [c for c in chunks[:-1] if c["choices"][0]["finish_reason"]]
    assert finals and finals[0]["choices"][0]["finish_reason"] == "length"
    assert text.strip() == ref["choices"][0]["message"]["content"]


def test_http_image_through_the_scheduler_loop(http):
    """A page handed to SchedulerLoop.submit as a numpy array (no image
    decoder involved) runs host tiling, the tile tower and the splice."""
    _, loop, batcher = http
    sess = loop.submit({"question": "读出图中所有文字。", "image": _page(3, 80, 60), "use_p": False,
                        "max_new_tokens": 3}, stream=False)
    kind, payload = sess.events.get(timeout=300)
    assert kind == "done", payload
    assert payload["completion_tokens"] == 3
    nit = loop.engine.cfg.num_image_token
    assert payload["prompt_tokens"] > 3 * nit  # 2 tiles + thumbnail


def test_http_error_mapping(http):
    port, _, _ = http
    req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/chat/completions", data=b"{not json",
                                 headers={"Content-Type": "application/json"}, method="POST")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=60)
    assert e.value.code == 400
    for path, body in (
        ("/v1/chat/completions", {"messages": []}),
        ("/v1/chat/completions", {"messages": [{"role": "user", "content": "字" * 9000}],
                                  "max_tokens": 2}),  # beyond the largest prompt bucket
        ("/v1/chat/completions", {"messages": [{"role": "user", "content": "字" * 600}],
                                  "max_tokens": 2}),  # bucket 1024 > 4 pages x 128: rejected at admission
        ("/ocr", {"image": "https://example.com/x.jpg"}),
        ("/ocr", {}),
    ):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, path, body)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/v2/none", {"x": 1})
    assert e.value.code == 404
    assert _get(port, "/health")["status"] == "ok"


def test_http_concurrent_requests_share_slots(http):
    port, loop, batcher = http
    before = loop.snapshot()
    results = {}

    def hit(name, text, n):
        results[name] = _post(port, "/v1/chat/completions",
                              {"messages": [{"role": "user", "content": text}], "max_tokens": n})

    threads = [threading.Thread(target=hit, args=(f"r{i}", f"问题{i}", 3 + i)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads) and len(results) == 4
    for i in range(4):
        assert results[f"r{i}"]["usage"]["completion_tokens"] == 3 + i
    snap = loop.snapshot()
    assert snap["requests_completed"] - before["requests_completed"] == 4
    assert snap["tokens_generated"] - before["tokens_generated"] == 3 + 4 + 5 + 6
    assert snap["slots_busy"] == 0 and snap["queue_depth"] == 0
    assert len(batcher.pool.free) == 8  # every page returned


@pytest.mark.parametrize("exc,kind", [
    (ValueError("the prefix does not fit"), "done"),
    (RuntimeError("flash_attention_launch failed: cudaError 700"), "error"),
])
def test_prefix_registration_failure_is_not_swallowed(engine, exc, kind):
    """Registering a prompt as a prefix is an optimization: a prompt that does
    not fit goes on without it (and is counted), but a failing kernel inside
    the registration's prefill fails the request with its error."""
    batcher = PagedBatcher(engine.params["llm"], engine.cfg.llm, num_slots=2, num_pages=9,
                           page_size=128, max_pages_per_slot=4, policy=engine.policy)

    def register_prefix(row):
        raise exc

    batcher.register_prefix = register_prefix
    loop = http_server.SchedulerLoop(engine, batcher, prefix_cache=True).start()
    try:
        sess = loop.submit({"question": "你好", "max_new_tokens": 2}, stream=False)
        got, payload = sess.events.get(timeout=300)
        snap = loop.snapshot()
    finally:
        loop.shutdown()
    assert got == kind, payload
    if kind == "error":
        assert "cudaError 700" in payload
        assert snap["requests_rejected"] == 1 and snap["prefix_failed"] == 0
    else:
        assert payload["completion_tokens"] == 2
        assert snap["prefix_failed"] == 1 and snap["requests_completed"] == 1
