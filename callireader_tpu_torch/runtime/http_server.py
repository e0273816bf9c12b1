"""HTTP serving front end over the continuous batcher (PyTorch port of
callireader_tpu/runtime/http_server.py).

Exposes the slot-pool scheduler (runtime/serving.py or runtime/paged_cache.py:
contiguous or paged KV) behind a thread-per-connection stdlib HTTP server:

  POST /v1/chat/completions   OpenAI-compatible chat API (stream + non-stream)
  POST /ocr                   native CalliReader full-page OCR (chat_ocr front
                              half: tiling + detector + CalliAlign + splice)
  GET  /health                liveness + slot/queue gauges
  GET  /metrics               counters (requests, tokens, rejects) as JSON

Threading model (single-device discipline): every device interaction (vision
prep, prefill admission, decode steps, even detokenization) happens on ONE
scheduler thread, on that thread's current CUDA stream; HTTP handler threads
only parse requests, decode image references, enqueue prep jobs, and block on
their per-request event queue. Token deltas therefore stream with at most one
decode step of latency and the device never sees concurrent launches from
racing handlers. ``torch.inference_mode()`` is thread-local: the batcher's
entry points enter it themselves on the scheduler thread.

Zero dependencies beyond the stdlib: `http.server.ThreadingHTTPServer`,
chunked SSE for streaming (`data: {chunk}\n\n`, terminated by
`data: [DONE]`), base64 data-URI / local-path image refs. Image references
are decoded with PIL, imported inside ``decode_image_ref`` only: where PIL is
missing, that one request fails with its error and the module still imports.
``SchedulerLoop.submit`` takes the image as a numpy array already.
"""

from __future__ import annotations

import base64
import binascii
import io
import json
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from callireader_tpu_torch.runtime import generate as gen
from callireader_tpu_torch.runtime.conversation import build_chat_prompt, get_conv_template
from callireader_tpu_torch.runtime.engine import ALIGNED
from callireader_tpu_torch.runtime.serving import Request
from callireader_tpu_torch.vision import preprocess


def decode_image_ref(ref: str) -> np.ndarray:
    """Image reference -> RGB uint8 array. Accepts a base64 data URI
    (``data:image/png;base64,...``), a bare base64 payload, or a local file
    path / file:// URL. Remote http(s) URLs are rejected: the serving host is
    zero-egress and fetching user-supplied URLs from a server is an SSRF
    hazard besides."""
    if ref.startswith(("http://", "https://")):
        raise ValueError("remote image URLs are not fetched; inline a data: URI")
    try:
        from PIL import Image
    except ImportError:
        raise ValueError("image references need PIL, which is not installed here")

    if ref.startswith("data:"):
        try:
            _, b64 = ref.split(",", 1)
        except ValueError:
            raise ValueError("malformed data URI")
        raw = base64.b64decode(b64, validate=True)
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    if ref.startswith("file://"):
        ref = ref[len("file://"):]
    try:
        return np.asarray(Image.open(ref).convert("RGB"))
    except (FileNotFoundError, IsADirectoryError):
        pass
    try:  # bare base64 payload (no data: header)
        raw = base64.b64decode(ref, validate=True)
        return np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    except (binascii.Error, OSError, ValueError):
        raise ValueError(f"unreadable image reference (path or base64): {ref[:64]!r}")


def parse_chat_messages(
    messages: List[Dict[str, Any]],
) -> Tuple[str, List[Tuple[str, str]], Optional[str], Optional[np.ndarray]]:
    """OpenAI `messages` -> (question, history, system, image).

    Content items of type image_url may appear only in the FINAL user
    message (the KV cache holds no cross-request image state). Assistant /
    user turns before it become template history pairs."""
    system = None
    turns: List[Tuple[str, str]] = []  # (role, text)
    image: Optional[np.ndarray] = None
    last_user_idx = max(
        (i for i, m in enumerate(messages) if m.get("role") == "user"), default=-1
    )
    if last_user_idx < 0:
        raise ValueError("no user message")
    for i, m in enumerate(messages):
        role = m.get("role")
        content = m.get("content", "")
        texts: List[str] = []
        if isinstance(content, str):
            texts.append(content)
        elif isinstance(content, list):
            for item in content:
                t = item.get("type")
                if t == "text":
                    texts.append(item.get("text", ""))
                elif t == "image_url":
                    if i != last_user_idx:
                        raise ValueError("images are only supported in the final user message")
                    url = item.get("image_url")
                    url = url.get("url") if isinstance(url, dict) else url
                    image = decode_image_ref(url)
                else:
                    raise ValueError(f"unsupported content type {t!r}")
        else:
            raise ValueError("message content must be a string or a list")
        text = "\n".join(t for t in texts if t)
        if role == "system":
            system = text
        elif role in ("user", "assistant"):
            turns.append((role, text))
        else:
            raise ValueError(f"unsupported role {role!r}")
    last_user_turn = max(
        (i for i, (role, _) in enumerate(turns) if role == "user"), default=-1
    )
    if last_user_turn < 0:
        raise ValueError("no user message")
    question = turns[last_user_turn][1]
    history: List[Tuple[str, str]] = []
    pend_q: Optional[str] = None
    for role, text in turns[:last_user_turn]:
        if role == "user":
            pend_q = text
        elif pend_q is not None:
            history.append((pend_q, text))
            pend_q = None
    return question, history, system, image


class _Session:
    """One in-flight request: the scheduler thread pushes events into
    `events`; the owning HTTP handler thread blocks on it.

    Events: ("delta", text), ("done", info dict), ("error", message)."""

    __slots__ = ("req", "events", "sent_text", "created", "stream")

    def __init__(self, stream: bool):
        self.req: Optional[Request] = None
        self.events: "queue.Queue[Tuple[str, Any]]" = queue.Queue()
        self.sent_text = ""
        self.created = time.time()
        self.stream = stream


class SchedulerLoop:
    """Owns the engine + batcher; the only thread that launches device work.

    Prep jobs (vision front end + prompt splice) and decode ticks interleave:
    each loop iteration admits at most one prep job, then runs one batcher
    step, so a heavy multi-tile prep cannot starve in-flight decodes for more
    than one image's front half."""

    def __init__(self, engine, batcher, *, default_rep_pen: float = 1.0,
                 prefix_cache: bool = False):
        self.engine = engine
        self.batcher = batcher
        self.default_rep_pen = default_rep_pen
        # auto prefix-cache: register each text-only prompt's rows before
        # submitting it. The request then hits its own registration (prefix +
        # suffix prefill ~= one full prefill, so turn N is FLOP-neutral) and
        # the NEXT turn of the same conversation, whose rendered prompt
        # starts with this one under the append-only chat templates, skips
        # the whole shared share. Image prompts are skipped: images cannot
        # recur in history.
        self.prefix_cache = prefix_cache and hasattr(batcher, "register_prefix")
        self.n_prefix_registered = 0
        self.n_prefix_failed = 0
        cfg = engine.cfg
        sep = get_conv_template(cfg.template).sep
        self.sep = sep
        self.eos = (engine.tok.convert_tokens_to_ids(sep),)
        self._prep_jobs: "queue.Queue[Tuple[_Session, Dict[str, Any]]]" = queue.Queue()
        self._sessions: List[_Session] = []
        self._wake = threading.Event()
        self._stop = False
        self._lock = threading.Lock()
        # gauges/counters for /health + /metrics
        self.t_start = time.time()
        self.n_requests = 0
        self.n_completed = 0
        self.n_rejected = 0
        self.n_tokens_out = 0
        self._thread = threading.Thread(target=self._run, name="scheduler", daemon=True)

    # ----- handler-thread API -------------------------------------------

    def start(self):
        self._thread.start()
        return self

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=30)

    def submit(self, spec: Dict[str, Any], *, stream: bool) -> _Session:
        """Called from handler threads. spec keys: question, history, system,
        image (np array or None), use_p, max_new_tokens, repetition_penalty,
        stop_tokens."""
        sess = _Session(stream)
        with self._lock:
            self.n_requests += 1
        self._prep_jobs.put((sess, spec))
        self._wake.set()
        return sess

    def snapshot(self) -> Dict[str, Any]:
        b = self.batcher
        with self._lock:
            return {
                "uptime_s": round(time.time() - self.t_start, 1),
                "slots_total": b.B,
                "slots_busy": sum(r is not None for r in b.slot_req),
                "queue_depth": len(b.queue) + self._prep_jobs.qsize(),
                "requests_total": self.n_requests,
                "requests_completed": self.n_completed,
                "requests_rejected": self.n_rejected,
                "tokens_generated": self.n_tokens_out,
                "prefix_cache": self.prefix_cache,
                "prefix_registered": self.n_prefix_registered,
                "prefix_failed": self.n_prefix_failed,
                "prefix_hits": getattr(b, "prefix_hits", 0),
            }

    # ----- scheduler thread ---------------------------------------------

    def _prepare(self, sess: _Session, spec: Dict[str, Any]) -> None:
        engine = self.engine
        cfg = engine.cfg
        question = spec["question"]
        image = spec.get("image")
        pseudo = None
        img_embeds = None
        n_tiles = 0
        if image is not None:
            if spec.get("use_p", True):
                pseudo, _idx = engine.calli_align(image)
            pixel_values = preprocess.load_image(
                image, cfg.force_image_size, cfg.max_dynamic_patch, cfg.use_thumbnail)
            img_embeds = engine.encode_image_tiles(engine._to_dev(pixel_values))
            n_tiles = pixel_values.shape[0]
            if "<image>" not in question:
                question = "<image>\n" + question
            if pseudo is not None and ALIGNED not in question:
                question = question + ALIGNED * pseudo.shape[0]
        conv = build_chat_prompt(
            question, history=spec.get("history") or None,
            system_message=spec.get("system"), template=cfg.template,
        )
        query = engine._expand_image_tokens(
            conv.get_prompt(), [n_tiles] if n_tiles else []
        )
        ids = engine._tokenize_prompt(query)
        bucket = gen.bucket_length(len(ids))  # ValueError -> caller rejects
        embeds, _mask = engine._build_row_embeds(ids, img_embeds, pseudo, bucket)
        dev_row = embeds[0, bucket - len(ids):]
        row = dev_row.float().cpu().numpy()
        req = Request(
            uid=id(sess), embeds=row, dev_embeds=dev_row,
            max_new_tokens=int(spec.get("max_new_tokens", 1024)),
            eos_token_ids=self.eos
            + tuple(int(t) for t in spec.get("stop_tokens", ())),
            repetition_penalty=float(
                spec.get("repetition_penalty", self.default_rep_pen)
            ),
        )
        sess.req = req
        if self.prefix_cache and image is None:
            try:
                if self.batcher.register_prefix(row):
                    self.n_prefix_registered += 1
            except (ValueError, MemoryError, torch.cuda.OutOfMemoryError):
                # registration is an optimization: a prompt that does not fit
                # (shape, device memory) goes on without it. Anything else (a
                # kernel that fails to build or launch) fails the request
                self.n_prefix_failed += 1
        self._sessions.append(sess)
        self.batcher.submit(req)

    def _flush(self, sess: _Session, final: bool) -> None:
        """Detokenize-and-delta: decode the full token list (cheap at chat
        lengths), emit the unseen suffix. A partial multi-byte tail decodes
        to U+FFFD — hold it back until the next token completes it."""
        req = sess.req
        text = self.engine.tok.decode(req.tokens, skip_special_tokens=True)
        text = text.split(self.sep)[0]
        if not final and text.endswith("�"):
            text = text[: text.rfind("�")]
        if text.startswith(sess.sent_text):
            delta = text[len(sess.sent_text):]
        else:  # decode revised earlier output (SP never does; belt+braces)
            delta, sess.sent_text = text, ""
        if delta:
            sess.sent_text += delta
            if sess.stream:
                sess.events.put(("delta", delta))

    def _sweep(self) -> None:
        done_reqs = {id(r): r for r in self.batcher.done}
        still: List[_Session] = []
        for sess in self._sessions:
            req = sess.req
            if id(req) in done_reqs:
                if req.error is not None:
                    with self._lock:
                        self.n_rejected += 1
                    sess.events.put(("error", req.error))
                else:
                    self._flush(sess, final=True)
                    finish = (
                        "stop"
                        if req.tokens and req.tokens[-1] in req.eos_token_ids
                        else "length"
                    )
                    with self._lock:
                        self.n_completed += 1
                        self.n_tokens_out += len(req.tokens)
                    sess.events.put((
                        "done",
                        {
                            "text": sess.sent_text.strip(),
                            "finish_reason": finish,
                            "prompt_tokens": int(req.embeds.shape[0]),
                            "completion_tokens": len(req.tokens),
                        },
                    ))
            else:
                if req.tokens:
                    self._flush(sess, final=False)
                still.append(sess)
        self._sessions = still
        # every done request was just routed to its session's event queue;
        # unfinished sessions' requests are by definition not in done
        self.batcher.done = []

    def _run(self) -> None:
        while not self._stop:
            worked = False
            try:
                sess, spec = self._prep_jobs.get_nowait()
                worked = True
                try:
                    self._prepare(sess, spec)
                except ValueError as e:
                    with self._lock:
                        self.n_rejected += 1
                    sess.events.put(("error", str(e)))
                except Exception as e:  # fail the request, never the server
                    with self._lock:
                        self.n_rejected += 1
                    sess.events.put(("error", f"prep failed: {e!r}"))
            except queue.Empty:
                pass
            if self.batcher.queue or any(r is not None for r in self.batcher.slot_req):
                self.batcher.step()
                worked = True
            if self._sessions or self.batcher.done:
                self._sweep()
            if not worked:
                self._wake.wait(timeout=0.05)
                self._wake.clear()


def make_handler(loop: SchedulerLoop, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        # ----- plumbing ---------------------------------------------------

        def _json(self, code: int, obj: Dict[str, Any]) -> None:
            body = json.dumps(obj, ensure_ascii=False).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, message: str) -> None:
            self._json(code, {"error": {"message": message, "type": "invalid_request_error"}})

        def _read_body(self) -> Dict[str, Any]:
            n = int(self.headers.get("Content-Length", 0))
            if n <= 0:
                raise ValueError("empty body")
            return json.loads(self.rfile.read(n))

        # ----- GET --------------------------------------------------------

        def do_GET(self):
            if self.path == "/health":
                snap = loop.snapshot()
                self._json(200, {"status": "ok", **snap})
            elif self.path == "/metrics":
                self._json(200, loop.snapshot())
            elif self.path == "/v1/models":
                self._json(200, {
                    "object": "list",
                    "data": [{"id": model_name, "object": "model",
                              "owned_by": "callireader"}],
                })
            else:
                self._error(404, f"no route {self.path}")

        # ----- POST -------------------------------------------------------

        def do_POST(self):
            try:
                body = self._read_body()
            except (ValueError, json.JSONDecodeError) as e:
                return self._error(400, f"bad JSON body: {e}")
            try:
                if self.path == "/v1/chat/completions":
                    return self._chat_completions(body)
                if self.path == "/ocr":
                    return self._ocr(body)
            except ValueError as e:
                return self._error(400, str(e))
            self._error(404, f"no route {self.path}")

        def _chat_completions(self, body: Dict[str, Any]) -> None:
            messages = body.get("messages")
            if not isinstance(messages, list) or not messages:
                raise ValueError("`messages` must be a non-empty list")
            question, history, system, image = parse_chat_messages(messages)
            stream = bool(body.get("stream", False))
            spec = {
                "question": question,
                "history": history,
                "system": system,
                "image": image,
                "use_p": bool(body.get("use_p", True)),
                "max_new_tokens": int(
                    body.get("max_tokens") or body.get("max_completion_tokens") or 1024
                ),
                "repetition_penalty": body.get(
                    "repetition_penalty", loop.default_rep_pen
                ),
                "stop_tokens": body.get("stop_token_ids", ()),
            }
            sess = loop.submit(spec, stream=stream)
            rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
            created = int(time.time())
            if not stream:
                info = self._wait_done(sess)
                return self._json(200, {
                    "id": rid, "object": "chat.completion", "created": created,
                    "model": body.get("model", model_name),
                    "choices": [{
                        "index": 0,
                        "message": {"role": "assistant", "content": info["text"]},
                        "finish_reason": info["finish_reason"],
                    }],
                    "usage": {
                        "prompt_tokens": info["prompt_tokens"],
                        "completion_tokens": info["completion_tokens"],
                        "total_tokens": info["prompt_tokens"] + info["completion_tokens"],
                    },
                })
            # ----- SSE stream -----
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(obj):
                data = f"data: {json.dumps(obj, ensure_ascii=False)}\n\n".encode()
                self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            base = {"id": rid, "object": "chat.completion.chunk",
                    "created": created, "model": body.get("model", model_name)}
            try:
                chunk({**base, "choices": [{"index": 0,
                                            "delta": {"role": "assistant"},
                                            "finish_reason": None}]})
                while True:
                    kind, payload = sess.events.get()
                    if kind == "delta":
                        chunk({**base, "choices": [{"index": 0,
                                                    "delta": {"content": payload},
                                                    "finish_reason": None}]})
                    elif kind == "done":
                        chunk({**base, "choices": [{"index": 0, "delta": {},
                                                    "finish_reason": payload["finish_reason"]}]})
                        break
                    else:  # error mid-stream: surface as a terminal event
                        chunk({**base, "error": {"message": payload}})
                        break
                tail = b"data: [DONE]\n\n"
                self.wfile.write(f"{len(tail):x}\r\n".encode() + tail + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionError):
                # client hung up mid-stream: the request keeps decoding in
                # the batcher and retires normally; nothing to clean up here
                self.close_connection = True

        def _ocr(self, body: Dict[str, Any]) -> None:
            ref = body.get("image") or body.get("image_path")
            if not ref:
                raise ValueError("`image` (data URI / base64 / path) is required")
            image = decode_image_ref(ref)
            spec = {
                "question": body.get("question", "读出图中所有文字。"),
                "history": None,
                "system": None,
                "image": image,
                "use_p": bool(body.get("use_p", True)),
                "max_new_tokens": int(body.get("max_new_tokens", 1024)),
                "repetition_penalty": body.get(
                    "repetition_penalty", loop.default_rep_pen
                ),
                "stop_tokens": body.get("stop_token_ids", ()),
            }
            sess = loop.submit(spec, stream=False)
            info = self._wait_done(sess)
            self._json(200, {
                "response": info["text"],
                "finish_reason": info["finish_reason"],
                "n_tokens": info["completion_tokens"],
            })

        def _wait_done(self, sess: _Session) -> Dict[str, Any]:
            while True:
                kind, payload = sess.events.get()
                if kind == "done":
                    return payload
                if kind == "error":
                    raise ValueError(payload)
                # non-stream mode ignores deltas (text is in the done event)

    return Handler


def serve_http(engine, batcher, *, host: str = "127.0.0.1", port: int = 8000,
               model_name: str = "callireader", default_rep_pen: float = 1.0,
               prefix_cache: bool = False):
    """Build and return (ThreadingHTTPServer, SchedulerLoop) — caller runs
    `server.serve_forever()` (the CLI) or drives it from a thread (tests)."""
    loop = SchedulerLoop(engine, batcher, default_rep_pen=default_rep_pen,
                         prefix_cache=prefix_cache).start()
    handler = make_handler(loop, model_name)
    server = ThreadingHTTPServer((host, port), handler)
    server.scheduler_loop = loop  # for tests / shutdown
    return server, loop
