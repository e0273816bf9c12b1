"""Share of the untraced window in which no kernel, copy or set ran on the
device, in percent: the busy seconds a batch of the batches traced after
the window (every batch has the same pages a batch, decode steps and
prompt bucket) against the window's seconds a batch."""


def read(ctx):
    return ctx.idle_share(lambda w: len(w["batches"]))
