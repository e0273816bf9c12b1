// Causal attention of latent attention's prefill (the non-absorbed form):
// query and key heads of Dqk = 192 ([no-RoPE 128 | RoPE 64]), value heads of
// Dv = 128, one query head a key head (G = 1), segment ids.
//
// No JAX counterpart: the JAX package's LLM is InternLM2 alone. The loop is
// flash_common.cuh's (wgmma and TMA, the softmax weights split into two bf16
// parts), instantiated with Q and K tiles of three 64-column blocks and a V
// tile of two: a block holds 64 query positions of one head, two K/V stages
// of 64 keys (24 KB of K and 16 KB of V each), two blocks an SM.
//
// Operands are strided (B, S, H, D) views, so the model hands the products'
// outputs over without a transpose: q (B, S, H, 192) as its projection
// leaves it, k (B, S, H, 192) (no-RoPE keys expanded from the latents beside
// the one RoPE key), v a view of the expansion's value half (B, S, H, 128)
// with the expansion's row strides, out (B, S, H, 128). Strides are in
// elements; each must be a multiple of 8 (16 bytes, TMA's rule).
//
// Bound on the H100: operations. At the page prefill (B = 8, S = 3584, 16
// heads) the causal work is ~2 B H S^2 (192 + 128) / 2 flops against a few
// hundred MB.
#include "flash_common.cuh"

extern "C" int mla_prefill_launch(const void* q, const void* k, const void* v, void* out,
                                  const void* seg, int B, int S, int H, long long q_ss,
                                  long long q_sh, long long q_sb, long long k_ss, long long k_sh,
                                  long long k_sb, long long v_ss, long long v_sh, long long v_sb,
                                  long long o_ss, long long o_sh, long long o_sb, float scale,
                                  void* stream) {
  const cr::Operand qo{q, S, H, B, q_ss, q_sh, q_sb};
  const cr::Operand ko{k, S, H, B, k_ss, k_sh, k_sb};
  const cr::Operand vo{v, S, H, B, v_ss, v_sh, v_sb};
  cr::AttnArgs a{};
  a.o = static_cast<__nv_bfloat16*>(out);
  a.o_sb = o_sb;
  a.o_sh = o_sh;
  a.o_ss = o_ss;
  a.Hkv = H;
  a.Sq = S;
  a.Sk = S;
  a.causal = 1;
  a.q_offset = 0;
  a.q_seg = static_cast<const int*>(seg);
  a.k_seg = static_cast<const int*>(seg);
  a.scale_log2 = scale * 1.4426950408889634f;
  return cr::launch_flash<192, 1, 2, 2, true, false, 128>(a, qo, ko, vo,
                                                          static_cast<cudaStream_t>(stream));
}
