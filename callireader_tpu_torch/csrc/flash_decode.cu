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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int CK = 128;  // keys per chunk = threads per block in pass 1

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// grid (NC, Hkv, B), block CK
template <int D, int G>
__global__ void __launch_bounds__(CK) decode_partial(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ ck,
    const __nv_bfloat16* __restrict__ cv, const int* __restrict__ valid,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int B, int Hkv, int S, int layer,
    int NC, float scale_log2) {
  const int c = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  __shared__ float qs[G][D];
  __shared__ float ps[G][CK];
  __shared__ int oks[CK];
  __shared__ float red[G][2];

  const long long qrow0 = (long long)b * Hkv * G + (long long)hkv * G;
  for (int i = tid; i < G * D; i += CK) {
    const int g = i / D, d = i % D;
    qs[g][d] = __bfloat162float(q[(qrow0 + g) * D + d]) * scale_log2;
  }
  __syncthreads();

  const long long base = (((long long)layer * B + b) * Hkv + hkv) * (long long)S;
  const int kp = c * CK + tid;
  const bool ok = kp < S && valid[(long long)b * S + kp] != 0;
  float dot[G];
#pragma unroll
  for (int g = 0; g < G; ++g) dot[g] = 0.f;
  if (ok) {
    const __nv_bfloat16* kr = ck + (base + kp) * D;
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 8) {
      float kf[8];
      load8(kr + d0, kf);
#pragma unroll
      for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e) dot[g] = fmaf(qs[g][d0 + e], kf[e], dot[g]);
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) ps[g][tid] = ok ? dot[g] : -INFINITY;
  oks[tid] = ok;
  __syncthreads();
  if (tid < G) {
    float mx = -INFINITY;
    for (int j = 0; j < CK; ++j) mx = fmaxf(mx, ps[tid][j]);
    red[tid][0] = mx;
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float mx = red[g][0];
    ps[g][tid] = ok ? exp2f(ps[g][tid] - mx) : 0.f;
  }
  __syncthreads();
  if (tid < G) {
    float sum = 0.f;
    for (int j = 0; j < CK; ++j) sum += ps[tid][j];
    red[tid][1] = sum;
  }
  __syncthreads();

  const int nk = min(CK, S - c * CK);
  for (int d = tid; d < D; d += CK) {
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    for (int j = 0; j < nk; ++j) {
      if (!oks[j]) continue;
      const float vv = __bfloat162float(cv[(base + c * CK + j) * D + d]);
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(ps[g][j], vv, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) part_acc[((qrow0 + g) * NC + c) * D + d] = acc[g];
  }
  if (tid < G) {
    const long long idx = (qrow0 + tid) * NC + c;
    part_ml[idx * 2] = red[tid][0];
    part_ml[idx * 2 + 1] = red[tid][1];
  }
}

// grid (B * Hq), block D
template <int D>
__global__ void decode_combine(const float* __restrict__ part_acc,
                               const float* __restrict__ part_ml, __nv_bfloat16* __restrict__ out,
                               int NC) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  float M = -INFINITY;
  for (int c = 0; c < NC; ++c) M = fmaxf(M, part_ml[(bh * NC + c) * 2]);
  float L = 0.f, acc = 0.f;
  if (M != -INFINITY) {
    for (int c = 0; c < NC; ++c) {
      const float w = exp2f(part_ml[(bh * NC + c) * 2] - M);
      L = fmaf(part_ml[(bh * NC + c) * 2 + 1], w, L);
      acc = fmaf(part_acc[(bh * NC + c) * D + d], w, acc);
    }
  }
  out[bh * D + d] = __float2bfloat16(L > 0.f ? acc / L : 0.f);
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
  decode_combine<D><<<B * Hkv * G, D, 0, s>>>(static_cast<const float*>(part_acc),
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
