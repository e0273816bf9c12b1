"""The whole window's share of the card's bf16 peak: the model operations
the untraced window's batches need (the tile tower and projector over each page's
tiles, the char tower, its projector, the resampler and VQ over each found
character, the prefill over the valid prompt tokens, the decode steps; the
detector and OrderFormer, under 0.1% of it, are not counted) over the
window's seconds times 989 TFLOP/s, in percent."""

import json

import numpy as np

from chipbench import flops
from chipbench import weights


def read(ctx):
    cfg = ctx.cfg
    meta = json.loads(str(np.load(weights.ASSETS / cfg["char_tower"]["asset"])["meta"]))
    cv, cr = meta["char_vision"], meta["char_resampler"]
    v, llm = cfg["vision"], cfg["llm"]
    V, E = llm["vocab_size"], llm["hidden_size"]
    char_tokens = (cv["image_size"] // cv["patch_size"]) ** 2 // 4
    total = 0.0
    w = ctx.work["window"]
    for b in w["batches"]:
        tiles, chars = sum(b["tiles"]), sum(b["chars"])
        total += flops.vit_flops(v, tiles) + flops.projector_flops(v["hidden_size"], E, cfg["num_image_token"], tiles)
        total += (flops.vit_flops(cv, chars) + flops.projector_flops(cv["hidden_size"], cr["dim"], char_tokens, chars)
                  + flops.resampler_flops(cr, char_tokens, chars) + flops.vq_flops(E, V, cr["num_learns"] * chars))
        total += flops.prefill_flops(llm, b["lengths"], V) + flops.decode_flops(llm, b["lengths"], w["steps"], V)
    return 100.0 * total / (w["window_s"] * flops.PEAKS["bf16_flops"])
