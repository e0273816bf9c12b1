"""The whole window's share of the card's bf16 peak in the MLA-MoE cell: the
model operations the untraced window's batches need (the front half as
``mfu.ocr`` counts it: the tile tower and projector over each page's tiles;
the compact char tower, its projector, the resampler and VQ over each found
character; then the LLM's active operations, the prefill over the valid
prompt tokens and the decode steps, ``flops_moe.py``) over the window's
seconds times 989 TFLOP/s, in percent."""

from chipbench import flops, flops_moe


def read(ctx):
    cfg = ctx.cfg
    v, cv, cr = cfg["vision"], cfg["char_tower"]["vision"], cfg["char_tower"]["resampler"]
    V, E = cfg["vocab_size"], cfg["hidden_size"]
    char_tokens = (cv["image_size"] // cv["patch_size"]) ** 2 // 4
    total = 0.0
    w = ctx.work["window"]
    for b in w["batches"]:
        tiles, chars = sum(b["tiles"]), sum(b["chars"])
        total += flops.vit_flops(v, tiles) + flops.projector_flops(v["hidden_size"], E, cfg["num_image_token"], tiles)
        total += (flops.vit_flops(cv, chars) + flops.projector_flops(cv["hidden_size"], cr["dim"], char_tokens, chars)
                  + flops.resampler_flops(cr, char_tokens, chars) + flops.vq_flops(E, V, cr["num_learns"] * chars))
        total += flops_moe.prefill_flops(cfg, b["lengths"]) + flops_moe.decode_flops(cfg, b["lengths"], w["steps"])
    return 100.0 * total / (w["window_s"] * flops.PEAKS["bf16_flops"])
