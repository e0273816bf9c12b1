"""HTTP serving benchmark: concurrent clients against the OpenAI endpoint
(port of scripts/bench_http.py).

  python -m callireader_tpu_torch.scripts.bench_http --preset callireader-2b --slots 8 \
      --requests 24 --max-tokens 64 [--paged] [--steps-per-sync 8] [--stream] [--device cpu]

Starts the full HTTP stack in-process (runtime/http_server.serve_http on an
ephemeral loopback port: the same code path as ``serve --http``) on an
engine with seeded random weights and no trained assets, fires N concurrent
text requests from client threads, and prints ONE JSON line: aggregate
generated tok/s, request-latency p50/p95, and (with ``--stream``) p50
time-to-first-DELTA over the wire. Every request must answer 200; one that
does not fails the run. Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="callireader-2b")
    p.add_argument("--slots", type=int, default=8)
    p.add_argument("--max-len", type=int, default=1024)
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--concurrency", type=int, default=None,
                   help="client threads (default: 2x slots)")
    p.add_argument("--paged", action="store_true")
    p.add_argument("--steps-per-sync", type=int, default=1)
    p.add_argument("--stream", action="store_true",
                   help="streamed requests; also measures time-to-first-delta")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from callireader_tpu_torch.cli.common import build_engine
    from callireader_tpu_torch.runtime.http_server import serve_http
    from callireader_tpu_torch.runtime.serving import ContinuousBatcher
    from callireader_tpu_torch.scripts import bench_common as bc

    engine = build_engine(preset=args.preset, random_init_ok=True, trained_assets=False,
                          device=args.device)
    dev = engine.device
    if args.paged:
        from callireader_tpu_torch.runtime.paged_cache import PagedBatcher

        page = 128
        per_slot = -(-args.max_len // page)
        batcher = PagedBatcher(
            engine.params["llm"], engine.cfg.llm, num_slots=args.slots,
            num_pages=args.slots * per_slot + 1, page_size=page,
            max_pages_per_slot=per_slot, policy=engine.policy,
            steps_per_sync=args.steps_per_sync,
        )
    else:
        batcher = ContinuousBatcher(
            engine.params["llm"], engine.cfg.llm, num_slots=args.slots,
            max_len=args.max_len, policy=engine.policy, steps_per_sync=args.steps_per_sync,
        )
    server, loop = serve_http(engine, batcher, port=0, model_name=args.preset)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        prompts = [
            f"第{i}幅书法作品的内容、作者与风格是什么？请逐项说明。"
            for i in range(args.requests)
        ]

        def call(i, record):
            body = {
                "messages": [{"role": "user", "content": prompts[i]}],
                "max_tokens": args.max_tokens,
                "stream": args.stream,
            }
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/v1/chat/completions",
                data=json.dumps(body).encode(),
                headers={"Content-Type": "application/json"}, method="POST",
            )
            t0 = time.perf_counter()
            with urllib.request.urlopen(req, timeout=1200) as r:
                if r.status != 200:
                    raise RuntimeError(f"request {i} answered {r.status}")
                if args.stream:
                    first_delta = None
                    for raw in r:
                        line = raw.decode().strip()
                        if not line.startswith("data: ") or line == "data: [DONE]":
                            continue
                        d = json.loads(line[len("data: "):])
                        delta = d.get("choices", [{}])[0].get("delta", {})
                        if delta.get("content") and first_delta is None:
                            first_delta = time.perf_counter() - t0
                    record[i] = {"latency": time.perf_counter() - t0, "ttfd": first_delta,
                                 "tokens": args.max_tokens}
                else:
                    out = json.loads(r.read())
                    record[i] = {
                        "latency": time.perf_counter() - t0,
                        "tokens": out["usage"]["completion_tokens"],
                    }

        # warm the graphs with one request outside the timed window
        warm = {}
        call(0, warm)
        print(f"[bench_http] warm request: {warm[0]['latency']:.3f}s", file=sys.stderr)

        conc = args.concurrency or 2 * args.slots
        record, errors = {}, {}
        sem = threading.Semaphore(conc)

        def worker(i):
            with sem:
                try:
                    call(i, record)
                except Exception as e:  # noqa: BLE001 - reported after the join
                    errors[i] = repr(e)

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(args.requests)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        server.shutdown()
        loop.shutdown()
        server.server_close()
    if errors or len(record) != args.requests:
        raise RuntimeError(f"{len(record)} of {args.requests} requests answered 200; "
                           f"failures: {errors}")

    toks = sum(r["tokens"] for r in record.values())
    lats = sorted(r["latency"] for r in record.values())
    out = {
        "metric": "http_serving_agg_tok_per_sec",
        "value": toks / wall,
        "unit": "tok/s",
        "requests": args.requests,
        "slots": args.slots,
        "concurrency": conc,
        "max_tokens": args.max_tokens,
        "steps_per_sync": args.steps_per_sync,
        "paged": bool(args.paged),
        "stream": bool(args.stream),
        "wall_s": wall,
        "latency_p50_s": lats[len(lats) // 2],
        "latency_p95_s": lats[min(len(lats) - 1, int(0.95 * len(lats)))],
    }
    if args.stream:
        tt = sorted(r["ttfd"] for r in record.values() if r.get("ttfd"))
        if tt:
            out["ttfd_p50_s"] = tt[len(tt) // 2]
    out["device"] = bc.device_line(dev)
    out["platform"] = dev.type
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
