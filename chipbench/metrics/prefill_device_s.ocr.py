"""Device seconds a batch of the prefill: the time between the CUDA events
the program records around its ``prefill`` span (the mask's upload, the
decode state, the prefill), over the traced batches."""

from chipbench import spans


def read(ctx):
    return spans.seconds_a_batch(ctx, ("prefill",), "device_ns")
