"""Host seconds a batch of the engine's front half, its waits left out: the
host time of the program's box-stage spans (``detect_dispatch``,
``detect_fetch``, ``columns``, ``order_dispatch``, ``order_fetch``) and of
``batch_build_rows``' (``page_tiling``, ``char_prep``, ``char_route``,
``tile_encode``, ``tokenize``, ``embed_build``), less the ``blocked.*`` spans
inside them, over the traced batches. Read under the profiler, which
stretches host time."""

from chipbench import spans


def read(ctx):
    return spans.seconds_a_batch(ctx, spans.BOX_STAGE + spans.BUILD, "host_ns", less="blocked_ns")
