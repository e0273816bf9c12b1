"""Device seconds a batch of its prefill and decode: the time in which an
operation ran on the device within the device span of the benchmark's
``launch`` range (``batch_prepare(prepared_rows=...)``: the kernels it
enqueued, the decode graphs' replays among them), averaged over the traced
batches. Gaps in which the device waited for the host's enqueue are not
counted."""


def read(ctx):
    if ctx.trace is None:
        return None
    busy = ctx.trace.range_busy("launch")
    if len(busy) != len(ctx.work["traced"]["batches"]):
        ctx.missing.append(f"launch: {len(busy)} device spans, {len(ctx.work['traced']['batches'])} batches")
        return None
    return sum(busy) / len(busy)
