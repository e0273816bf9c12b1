"""Device seconds a batch of the prefill's routed experts: the time between
the CUDA events the program records around each prefill layer's routed
block (its ``prefill_experts`` device span: the routing, the grouping and
the grouped expert kernel's launches), summed, over the traced batches."""

from chipbench import spans


def read(ctx):
    return spans.seconds_a_batch(ctx, ("prefill_experts",), "device_ns")
