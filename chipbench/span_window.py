"""Run one page cell as ``chipbench.run`` does, and write the program's own
counters (``kernels/_build.Counter``: the span totals of the port's recorder,
``blocked.upload.bytes``, ``kernel_builds``, ``graph_captures``,
``decode_pad_steps``) as their change over the untraced window and, with
``--trace 1``, over the traced stretch:

    python3 -m chipbench.span_window --out PATH [--spans-off] <chipbench.run arguments>

The page metrics read the counters over the traced stretch only
(``Context.launches``), where the profiler paces the host: there the
decode's enqueue takes as long as the decode, and the wait moves away from
the site that holds it untraced. This reads the untraced window as well.
``--spans-off`` switches the recorder off (``Spans.enabled``), to time what
it costs. PATH holds ``{"spans_enabled", "window": {"batches", "seconds",
"counters"}, "traced": {"batches", "counters"}}``; a counter's
``span.<name>.*_ns`` over ``batches`` is ns a batch. The run's own result
line is printed as ``chipbench.run`` prints it."""

from chipbench import run  # first, so that its clock starts at the process start

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from typing import List, Optional  # noqa: E402


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="where the counters' JSON goes")
    ap.add_argument("--spans-off", action="store_true", help="run with the recorder off")
    args, rest = ap.parse_known_args(argv)

    from chipbench import trace
    from chipbench.drivers import ocr
    from callireader_tpu_torch.kernels import _build
    from callireader_tpu_torch.utils import profiling

    if args.spans_off:
        profiling.Spans.enabled = False
    out = {"spans_enabled": profiling.Spans.enabled}

    def own():
        return {c.name: c.launches for c in _build.COUNTS if isinstance(c, _build.Counter)}

    run_until, init = ocr.Pipeline.run_until, trace.Context.__init__

    def counted_run_until(self, seconds, last):
        c0 = own()
        done, window_s = run_until(self, seconds, last)
        out["window"] = {"batches": len(done), "seconds": window_s,
                         "counters": {k: v - c0[k] for k, v in own().items()}}
        return done, window_s

    def counted_init(self, tr, launches, work, cfg):
        init(self, tr, launches, work, cfg)
        if tr is not None:
            names = own()
            out["traced"] = {"batches": len(work["traced"]["batches"]),
                             "counters": {k: v for k, v in launches.items() if k in names}}

    ocr.Pipeline.run_until, trace.Context.__init__ = counted_run_until, counted_init
    try:
        return run.main(rest)
    finally:
        ocr.Pipeline.run_until, trace.Context.__init__ = run_until, init
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
