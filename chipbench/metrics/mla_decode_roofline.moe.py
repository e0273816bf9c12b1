"""Share of its roofline reached by the latent decode kernel of the MLA-MoE
cell (``latent_decode_kernel`` and its ``latent_combine_kernel``): the bf16
latent rows of the valid keys once a step and layer, the absorbed queries
in and the latent outputs out (``flops_moe.py``), over 3.35 TB/s, over their
device time in the trace, in percent."""

from chipbench import flops_moe


def read(ctx):
    main = ctx.kernel_seconds("latent_decode_launch", "latent_decode_kernel")
    if main is None:
        return None
    _, combine = ctx.trace.family("latent_combine_kernel")
    traced = ctx.work["traced"]
    need = sum(flops_moe.latent_decode_bytes(ctx.cfg, b["lengths"], traced["steps"]) for b in traced["batches"])
    return 100.0 * need / flops_moe.PEAKS["hbm_bytes_per_s"] / (main + combine)
