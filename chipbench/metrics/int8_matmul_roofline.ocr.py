"""Share of their roofline reached by the weight-only int8 kernels of the
decode (``kn_kernel``, the per-layer (K, N) products; ``nt_kernel``, the LM
head at every step and after each prefill): the bytes they need (int8
weights, fp32 scales, bf16 rows in and out, each once) over 3.35 TB/s, over
their device time in the trace, in percent."""

from chipbench import flops


def read(ctx):
    kn = ctx.kernel_seconds("int8_matmul_kn_launch", "kn_kernel")
    nt = ctx.kernel_seconds("int8_matmul_nt_launch", "nt_kernel")
    if kn is None or nt is None:
        return None
    llm = ctx.cfg["llm"]
    E, V = llm["hidden_size"], llm["padded_vocab_size"]
    steps, rows = ctx.work["traced"]["steps"], ctx.work["traced"]["rows"]
    n = len(ctx.work["traced"]["batches"])
    need = n * (steps * flops.decode_step_int8_bytes(llm, rows)
                + (steps + 1) * flops.int8_nt_bytes(E, V, rows))
    return 100.0 * need / flops.PEAKS["hbm_bytes_per_s"] / (kn + nt)
