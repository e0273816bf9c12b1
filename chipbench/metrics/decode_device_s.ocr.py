"""Device seconds a batch of the decode: the time between the CUDA events
the program records around each chunk of its ``decode`` (one graph replay
of 8 steps), summed over the chunks, so that the gaps in which the device
waits for the host's next chunk are left out, over the traced batches."""

from chipbench import spans


def read(ctx):
    return spans.seconds_a_batch(ctx, ("decode",), "device_ns")
