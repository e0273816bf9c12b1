"""The program's span counters as the page metrics read them: each span of
the port's recorder is four counters of its registry (``span.<name>.host_ns``,
``.device_ns``, ``.blocked_ns``, ``.calls``), whose change over the traced
stretch ``Context.launches`` holds beside the launch counts. The
program's pipeline runs each span once a step, so a sum over the stretch,
over its batches, is seconds a batch. A program without the counters (or
that never opened a span) reads as nothing to read."""

from __future__ import annotations

from typing import Iterable, Optional

# the spans of the front half (the box stage and batch_build_rows)
BOX_STAGE = ("detect_dispatch", "detect_fetch", "columns", "order_dispatch", "order_fetch")
BUILD = ("page_tiling", "char_prep", "char_route", "tile_encode", "tokenize", "embed_build")
BLOCKED = ("blocked.upload", "blocked.readback")


def seconds_a_batch(ctx, names: Iterable[str], field: str, less: Optional[str] = None) -> Optional[float]:
    """The sum of ``span.<name>.<field>`` (less ``span.<name>.<less>``) over
    ``names``, in seconds a traced batch; None when a span is missing or
    has no call in the stretch, or when device time reads 0 (no card)."""
    traced = ctx.work.get("traced")
    if not traced or not traced["batches"]:
        return None
    total = 0
    for name in names:
        if ctx.launches.get(f"span.{name}.calls", 0) == 0:
            ctx.missing.append(f"span {name}: no call in the traced stretch")
            return None
        total += ctx.launches[f"span.{name}.{field}"]
        if less is not None:
            total -= ctx.launches[f"span.{name}.{less}"]
    if field == "device_ns" and total == 0:
        ctx.missing.append(f"spans {', '.join(names)}: no device time (no CUDA events)")
        return None
    return total * 1e-9 / len(traced["batches"])
