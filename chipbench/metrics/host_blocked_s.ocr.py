"""Host seconds a batch in which the program waited for the device: the
host time of every ``blocked.upload`` (a pageable host-to-device copy, which
waits for the work queued before it) and ``blocked.readback`` span, in any
site (``batch_decode``'s readback among them), over the traced batches.
Read under the profiler, which stretches host time."""

from chipbench import spans


def read(ctx):
    return spans.seconds_a_batch(ctx, spans.BLOCKED, "host_ns")
