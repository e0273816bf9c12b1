"""Share of the untraced window in which no kernel, copy or set ran on the
device, in percent: the busy seconds of the micro-steps traced after the
window, scaled by the window's operations over theirs
(``flops.eit_step_flops``, as the micro-steps differ in length), against
the window's seconds."""

from chipbench import flops


def read(ctx):
    return ctx.idle_share(lambda w: sum(flops.eit_step_flops(ctx.cfg, s, w["rank"]) for s in w["steps"]))
