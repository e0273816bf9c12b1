// Single-token GQA decode attention over the whole stacked KV cache.
//
// Replaces callireader_tpu/kernels/decode_attention.py (flash_decode).
// q (B, Hq, D) bf16; cache_k/cache_v (L, B, Hkv, S, D) bf16, read in place at
// `layer` (no per-layer slice is ever materialised); valid (B, S) int32,
// 1 = attendable; out (B, Hq, D) bf16.
//
// Bound on the H100: the bytes of the cache layer it reads (2*B*Hkv*S*D*2),
// about 0.5 flop per byte. With B <= 4 and Hkv = 8 a block per (b, kv head)
// would leave most of the 132 SMs idle, so the work is split over the keys
// (split-K): pass 1 runs one block per (key chunk of CK, kv head, b) and
// writes a partial (max, sum, weighted V) per query head in fp32; pass 2
// merges the chunks. Each block reads its chunk of K and V once for all G
// query heads of the group; keys masked out by `valid` are not read for V.
#include "decode_common.cuh"

namespace {

using decode::CK;

// grid (NC, Hkv, B), block CK; the passes themselves are in decode_common.cuh
template <int D, int G>
__global__ void __launch_bounds__(CK) decode_partial(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ ck,
    const __nv_bfloat16* __restrict__ cv, const int* __restrict__ valid,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int B, int Hkv, int S, int layer,
    int NC, float scale_log2) {
  const int c = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const long long qrow0 = (long long)b * Hkv * G + (long long)hkv * G;
  const long long first = (((long long)layer * B + b) * Hkv + hkv) * (long long)S + c * CK;
  decode::decode_partial_block<D, G>(q, ck + first * D, cv + first * D,
                                     valid + (long long)b * S + c * CK, min(CK, S - c * CK),
                                     part_acc, part_ml, qrow0, c, NC, scale_log2);
}

template <int D, int G>
void launch(const void* q, const void* ck, const void* cv, const void* valid, void* part_acc,
            void* part_ml, void* out, int B, int Hkv, int S, int layer, int NC, float scale_log2,
            cudaStream_t s) {
  dim3 grid(NC, Hkv, B);
  decode_partial<D, G><<<grid, CK, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(ck),
      static_cast<const __nv_bfloat16*>(cv), static_cast<const int*>(valid),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), B, Hkv, S, layer, NC,
      scale_log2);
  decode::decode_combine<D><<<B * Hkv * G, D, 0, s>>>(static_cast<const float*>(part_acc),
                                              static_cast<const float*>(part_ml),
                                              static_cast<__nv_bfloat16*>(out), NC);
}

}  // namespace

extern "C" int flash_decode_chunk() { return CK; }

extern "C" int flash_decode_launch(const void* q, const void* ck, const void* cv,
                                   const void* valid, void* part_acc, void* part_ml, void* out,
                                   int B, int Hq, int Hkv, int S, int D, int layer, int NC,
                                   float scale, void* stream) {
  // Instantiated for the LLM shape of every full-width preset: D = 128, G = 4.
  if (D != 128 || Hkv <= 0 || Hq != 4 * Hkv) return (int)cudaErrorInvalidValue;
  launch<128, 4>(q, ck, cv, valid, part_acc, part_ml, out, B, Hkv, S, layer, NC,
                 scale * 1.4426950408889634f, static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
