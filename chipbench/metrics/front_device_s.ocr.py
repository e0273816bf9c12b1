"""Device seconds a batch of the engine's front half: the time between the
CUDA events the program records around the launches of ``detect_dispatch``,
``order_dispatch``, ``page_tiling``, ``char_route``, ``tile_encode`` and
``embed_build`` (the device's own timestamps; the host's preparation and
uploads lie outside the brackets, so the device's waits for them are left
out), over the traced batches."""

from chipbench import spans

DEVICE = ("detect_dispatch", "order_dispatch", "page_tiling", "char_route", "tile_encode", "embed_build")


def read(ctx):
    return spans.seconds_a_batch(ctx, DEVICE, "device_ns")
