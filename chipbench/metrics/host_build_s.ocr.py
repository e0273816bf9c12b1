"""Host seconds a batch in the benchmark's own calls that build a batch:
the phased box stage (detector dispatch and readback, columns, OrderFormer
dispatch and readback) and ``batch_build_rows``, timed on the host clock
around each call, averaged over the untraced window's batches. It holds the
waits the engine's syncing spans put inside those calls."""


def read(ctx):
    b = ctx.work["window"]["host_build_s"]
    return sum(b) / len(b) if b else None
