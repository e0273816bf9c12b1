"""Share of its roofline reached by the grouped expert kernel of the
MLA-MoE cell (``moe_kernel``, its gate-up and down launches): the least time
of its work, the prefill's routed products over the valid prompt tokens at
989 TFLOP/s plus the decode's bytes (each touched (step, layer, expert)'s
weights once, from the program's ``moe.experts_touched``, and the routed
rows in and out) at 3.35 TB/s, over the kernel's device time in the trace,
in percent (``flops_moe.py``)."""

from chipbench import flops_moe


def read(ctx):
    t = ctx.kernel_seconds("moe_gate_up_launch", "moe_kernel")
    if t is None:
        return None
    touched = ctx.launches.get("moe.experts_touched", 0)
    if touched <= 0:
        ctx.missing.append("moe.experts_touched: no count in the traced stretch")
        return None
    cfg, traced = ctx.cfg, ctx.work["traced"]
    ops = sum(flops_moe.expert_prefill_flops(cfg, b["lengths"]) for b in traced["batches"])
    tokens = len(traced["batches"]) * traced["rows"] * traced["steps"]
    need = (ops / flops_moe.PEAKS["bf16_flops"]
            + flops_moe.expert_decode_bytes(cfg, touched, tokens) / flops_moe.PEAKS["hbm_bytes_per_s"])
    return 100.0 * need / t
