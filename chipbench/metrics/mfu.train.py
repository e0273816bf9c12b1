"""The micro-steps' share of the card's bf16 peak: the operations the
untraced window's micro-steps need (``flops.eit_step_flops``: the frozen
tile tower, the projector with its weight gradient, the LLM forward and its
activations' backward through the frozen base, attention per causal pair,
the LoRA products and their gradients, the LM head; remat's recompute not
counted) over the window's seconds times 989 TFLOP/s, in percent."""

from chipbench import flops


def read(ctx):
    w = ctx.work["window"]
    total = sum(flops.eit_step_flops(ctx.cfg, s, w["rank"]) for s in w["steps"])
    return 100.0 * total / (w["window_s"] * flops.PEAKS["bf16_flops"])
