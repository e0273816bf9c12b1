"""Share of its roofline reached by the decode attention (``decode_kernel``
and its ``decode_combine``): bf16 K and V of the valid keys only, the query
and output rows and the validity row of the cache, over 3.35 TB/s, over
their device time in the trace, in percent."""

from chipbench import flops


def read(ctx):
    main = ctx.kernel_seconds("flash_decode_launch", "decode_kernel")
    if main is None:
        return None
    _, combine = ctx.trace.family("decode_combine")
    llm = ctx.cfg["llm"]
    steps, rows = ctx.work["traced"]["steps"], ctx.work["traced"]["rows"]
    need = 0
    for b in ctx.work["traced"]["batches"]:
        cache_len = b["bucket"] + steps
        keys = flops.decode_valid_keys(b["lengths"], steps)
        # every layer, every step: the rows' valid keys, and the fixed rows
        need += llm["num_hidden_layers"] * (flops.flash_decode_bytes(llm, keys, rows, cache_len)
                                            + (steps - 1) * flops.flash_decode_bytes(llm, 0, rows, cache_len))
    return 100.0 * need / flops.PEAKS["hbm_bytes_per_s"] / (main + combine)
