// Non-causal multi-head attention straight from the ViT's packed QKV.
//
// Replaces callireader_tpu/kernels/vit_attention.py (vit_attention_nomax and
// vit_attention_single_pass, via attention_from_packed_qkv[_nomax]) and
// callireader_tpu/kernels/packed_qkv_attention.py (flash_attention_packed_qkv).
//
// Input qkv (B, S, 3E) bf16 with E = H * D, each row laid out as
// [q heads | k heads | v heads]; output (B, S, E) bf16.
// TMA reads q, k and v of head h straight from the packed rows (a row stride
// of 3E), so nothing is transposed or copied. Any S works: the KV loop runs
// over shared-memory tiles with online softmax, and ragged edges are masked
// by bounds. Templated on D in {32, 64}: the compact char tower (D=32,
// S=257) and the tile tower (D=64, S=1025).
//
// Bound on the H100: the work is 4*B*H*S^2*D flops against 2*B*S*4E bytes, so
// at S=1025 it is bound by operations: both products run on the tensor cores
// (wgmma, the tile loop in flash_common.cuh, one 64-row query tile of one
// head a block). Stages of the K/V ring and blocks an SM, timed on the H100
// at the towers' shapes: 3 and 3 at D = 64, 2 and 4 at D = 32.
#include "flash_common.cuh"

extern "C" int vit_attention_launch(const void* qkv, void* out, int B, int S, int H, int D,
                                    float scale, void* stream) {
  const long long E = (long long)H * D;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(qkv);
  // q, k, v of head h at column h * D of the three thirds of a packed row
  const cr::Operand q{base, S, H, B, 3 * E, D, S * 3 * E};
  cr::Operand k = q, v = q;
  k.p = base + E;
  v.p = base + 2 * E;
  cr::AttnArgs a{};
  a.o = static_cast<__nv_bfloat16*>(out);
  a.o_sb = (long long)S * E;
  a.o_sh = D;
  a.o_ss = E;
  a.Hkv = H;
  a.Sq = a.Sk = S;
  a.causal = 0;
  a.q_offset = 0;
  a.q_seg = a.k_seg = nullptr;
  a.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return cr::launch_flash<32, 1, 2, 4, false>(a, q, k, v, s);
    case 64: return cr::launch_flash<64, 1, 3, 3, false>(a, q, k, v, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
