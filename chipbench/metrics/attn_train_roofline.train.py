"""Share of its roofline reached by the training attention (the forward with
its log-sum-exp, run again for the backward under remat, and the dq and
dk/dv kernels): the operations the attended (query, key) pairs need, counted
from each row's segment of valid tokens (a forward launch 4 pairs x heads x
head width; the backward of a layer 10, its five products once each), over
989 TFLOP/s, over their device time in the trace, in percent."""

from chipbench import flops

FWD = r"flash_fwd_kernel<128, \d+, \d+, \d+, true, true>"


def read(ctx):
    fwd = ctx.kernel_seconds("attn_train_fwd_launch", FWD, regex=True)
    dq = ctx.kernel_seconds("attn_train_dq_launch", "dq_kernel")
    dkv = ctx.kernel_seconds("attn_train_dkv_launch", "dkdv_kernel")
    if fwd is None or dq is None or dkv is None:
        return None
    llm = ctx.cfg["llm"]
    steps = ctx.work["traced"]["steps"]
    per_step_fwd = ctx.launches["attn_train_fwd_launch"] / len(steps)
    per_step_bwd = ctx.launches["attn_train_dq_launch"] / len(steps)
    D = llm["hidden_size"] // llm["num_attention_heads"]
    need = sum(flops.causal_pairs(s["lengths"]) * llm["num_attention_heads"] * D
               * (4 * per_step_fwd + 10 * per_step_bwd) for s in steps)
    return 100.0 * need / flops.PEAKS["bf16_flops"] / (fwd + dq + dkv)
