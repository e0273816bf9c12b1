// Causal / non-causal GQA flash attention with segment ids and a query offset.
//
// Replaces callireader_tpu/kernels/attention.py (flash_attention), the LLM
// prefill kernel. q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), out (B, Hq, Sq, D),
// all bf16 contiguous; Hq = G * Hkv. A block serves the G query heads of one
// KV head (flash_common.cuh), so K/V are never repeated. Segment ids (B, S)
// int32 mask pairs whose ids differ (left padding is -1 on both sides in the
// prefill, so pad rows still attend to pad keys, as in the reference);
// `q_offset` places query row i at key position i + q_offset for the causal
// mask, and key tiles wholly above the diagonal are never loaded. Rows that
// attend to nothing are written as zeros.
//
// Bound on the H100: at the prefill shape (S=3584, D=128) the causal work is
// ~2*B*Hq*S^2*D flops against a few hundred MB, so it is bound by operations.
// This first version runs the products as fp32 FMAs on the CUDA cores.
#include "flash_common.cuh"

extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      const void* q_seg, const void* k_seg, int B, int Hq,
                                      int Hkv, int Sq, int Sk, int D, int causal, int q_offset,
                                      float scale, void* stream) {
  cr::AttnArgs a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.o = static_cast<__nv_bfloat16*>(out);
  a.q_sb = (long long)Hq * Sq * D;
  a.q_sh = (long long)Sq * D;
  a.q_ss = D;
  a.k_sb = a.v_sb = (long long)Hkv * Sk * D;
  a.k_sh = a.v_sh = (long long)Sk * D;
  a.k_ss = a.v_ss = D;
  a.o_sb = a.q_sb;
  a.o_sh = a.q_sh;
  a.o_ss = D;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.q_offset = q_offset;
  a.q_seg = static_cast<const int*>(q_seg);
  a.k_seg = static_cast<const int*>(k_seg);
  a.scale_log2 = scale * 1.4426950408889634f;
  // Instantiated for the LLM shape of every full-width preset (D = 128,
  // G = 4) and one second shape (D = 64, G = 1) that the card-only tests use.
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128 && G == 4) {
    cr::launch_flash<128, 4>(a, Hkv, B, s);
  } else if (D == 64 && G == 1) {
    cr::launch_flash<64, 1>(a, Hkv, B, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
