// Non-causal multi-head attention straight from the ViT's packed QKV.
//
// Replaces callireader_tpu/kernels/vit_attention.py (vit_attention_nomax and
// vit_attention_single_pass, via attention_from_packed_qkv[_nomax]) and
// callireader_tpu/kernels/packed_qkv_attention.py (flash_attention_packed_qkv).
//
// Input qkv (B, S, 3E) bf16 with E = H * D, each row laid out as
// [q heads | k heads | v heads]; output (B, S, E) bf16. The kernel addresses
// q/k/v of head h through strides, so neither side is transposed. Any S works:
// the KV loop runs over shared-memory tiles with online softmax, and ragged
// edges are masked by bounds. Templated on D in {32, 64}: the compact char
// tower (D=32, S=257) and the tile tower (D=64, S=1025).
//
// Bound on the H100: the work is 4*B*H*S^2*D flops against 2*B*S*4E bytes, so
// at S=1025 it is bound by operations. This first version runs the products
// as fp32 FMAs on the CUDA cores (tile loop in flash_common.cuh); moving them
// to wgmma is the next step.
#include "flash_common.cuh"

extern "C" int vit_attention_launch(const void* qkv, void* out, int B, int S, int H, int D,
                                    float scale, void* stream) {
  const long long E = (long long)H * D;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  cr::AttnArgs a{};
  a.q = base;
  a.k = base + E;
  a.v = base + 2 * E;
  a.o = static_cast<__nv_bfloat16*>(out);
  a.q_sb = a.k_sb = a.v_sb = (long long)S * 3 * E;
  a.q_sh = a.k_sh = a.v_sh = D;
  a.q_ss = a.k_ss = a.v_ss = 3 * E;
  a.o_sb = (long long)S * E;
  a.o_sh = D;
  a.o_ss = E;
  a.Sq = a.Sk = S;
  a.causal = 0;
  a.q_offset = 0;
  a.q_seg = a.k_seg = nullptr;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: cr::launch_flash<32, 1>(a, H, B, s); break;
    case 64: cr::launch_flash<64, 1>(a, H, B, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
