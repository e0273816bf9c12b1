// Single-token GQA decode attention of every slot over its own pages of a
// global page pool.
//
// Replaces callireader_tpu/kernels/paged_decode.py (paged_flash_decode).
// q (B, Hq, D) bf16; kpool/vpool (L, NPAGES, Hkv, page, D) bf16, read in place
// at `layer`; page_table (B, P) int32, the pool page of each of a slot's P
// entries; valid (B, P, page) int32, 1 = attendable; out (B, Hq, D) bf16.
//
// Bound on the H100: the bytes of the live keys and values,
// 2 * live * Hkv * D * 2, about half a flop per byte. A page is the split-K
// chunk: pass 1 runs one block per (table entry j, kv head, slot), finds its
// page with one load from page_table (base address ((layer * NPAGES +
// page_table[b, j]) * Hkv + hkv) * page * D) and leaves an fp32 partial for
// the group's G query heads; pass 2 merges a slot's P partials in page order
// (both passes are decode_common.cuh, shared with flash_decode.cu). With 8
// slots and 8 kv heads that is up to 64 * P blocks for the 132 SMs. A block
// whose entry holds no valid key (unused entries of a short slot, every entry
// of an empty slot) returns before it reads K or V, so the kernel moves the
// live pages only; a table entry outside the pool counts as dead. A slot with
// no valid key at all gives zeros.
#include "decode_common.cuh"

namespace {

using decode::CK;

// grid (P, Hkv, B), block CK (one thread per key of the page; page <= CK)
template <int D, int G>
__global__ void __launch_bounds__(CK) paged_partial(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kpool,
    const __nv_bfloat16* __restrict__ vpool, const int* __restrict__ page_table,
    const int* __restrict__ valid, float* __restrict__ part_acc, float* __restrict__ part_ml,
    int Hkv, int P, int page, int NPAGES, int layer, float scale_log2) {
  const int j = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const long long qrow0 = (long long)b * Hkv * G + (long long)hkv * G;
  const int pid = page_table[b * P + j];
  const bool in_pool = pid >= 0 && pid < NPAGES;
  const long long first =
      ((((long long)layer * NPAGES + (in_pool ? pid : 0)) * Hkv + hkv) * (long long)page);
  decode::decode_partial_block<D, G, true>(q, kpool + first * D, vpool + first * D,
                                           valid + ((long long)b * P + j) * page,
                                           in_pool ? page : 0, part_acc, part_ml, qrow0, j, P,
                                           scale_log2);
}

}  // namespace

extern "C" int paged_decode_launch(const void* q, const void* kpool, const void* vpool,
                                   const void* page_table, const void* valid, void* part_acc,
                                   void* part_ml, void* out, int B, int Hq, int Hkv, int P,
                                   int page, int NPAGES, int D, int layer, float scale,
                                   void* stream) {
  // Instantiated for the LLM shape of every full-width preset: D = 128, G = 4.
  if (D != 128 || Hkv <= 0 || Hq != 4 * Hkv || page <= 0 || page > CK || page % 16 || B <= 0 ||
      P <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid(P, Hkv, B);
  paged_partial<128, 4><<<grid, CK, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kpool),
      static_cast<const __nv_bfloat16*>(vpool), static_cast<const int*>(page_table),
      static_cast<const int*>(valid), static_cast<float*>(part_acc), static_cast<float*>(part_ml),
      Hkv, P, page, NPAGES, layer, scale * 1.4426950408889634f);
  decode::decode_combine<128><<<B * Hq, 128, 0, s>>>(static_cast<const float*>(part_acc),
                                                     static_cast<const float*>(part_ml),
                                                     static_cast<__nv_bfloat16*>(out), P);
  return (int)cudaGetLastError();
}
