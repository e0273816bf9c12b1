// Split-K single-token GQA decode attention: pass 1 of the contiguous-cache
// kernel (flash_decode.cu), and pass 2, which the paged kernel
// (paged_decode.cu) shares.
//
// Pass 1, `decode_partial_block`: one block of CK threads owns one chunk of at
// most CK keys of one KV head of one row, one thread per key. It reads the
// chunk's K and V once for all G query heads of the group and leaves an fp32
// partial (max, sum, weighted V) per query head at chunk index `c` of `NC`.
// Keys masked out by `valid` are read for neither K nor V. A chunk with no
// valid key leaves (max = -inf, sum = 0).
// Pass 2, `decode_combine`: merges a row's NC partials in chunk order; a
// partial whose max is -inf is never read for its weighted V, and a row with
// no valid key at all comes out as zeros.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace decode {

constexpr int CK = 128;  // keys per chunk = threads per block in pass 1
constexpr int VB = 4;    // V rows loaded per batch in pass 1 (divides CK)

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

// q: (rows, D) bf16 with the group's G query heads at rows qrow0 .. qrow0+G-1.
// kc / vc: the chunk's first key row, (nk, D) bf16, contiguous.
// valid_c: the chunk's nk validity flags.
template <int D, int G>
__device__ __forceinline__ void decode_partial_block(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
    const __nv_bfloat16* __restrict__ vc, const int* __restrict__ valid_c, int nk,
    float* __restrict__ part_acc, float* __restrict__ part_ml, long long qrow0, int c, int NC,
    float scale_log2) {
  const int tid = threadIdx.x;
  __shared__ float qs[G][D];
  __shared__ float ps[G][CK];
  __shared__ int oks[CK];
  __shared__ float red[G][2];

  const bool ok = tid < nk && valid_c[tid] != 0;

  for (int i = tid; i < G * D; i += CK) {
    const int g = i / D, d = i % D;
    qs[g][d] = __bfloat162float(q[(qrow0 + g) * D + d]) * scale_log2;
  }
  __syncthreads();

  float dot[G];
#pragma unroll
  for (int g = 0; g < G; ++g) dot[g] = 0.f;
  if (ok) {
    const __nv_bfloat16* kr = kc + (long long)tid * D;
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

  for (int d = tid; d < D; d += CK) {
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.f;
    // V loads are issued VB at a time, ahead of the FMAs that use them. With
    // one load per key behind its own branch (what nvcc makes of the plain
    // `if (!oks[j]) continue;` loop in this function) the loop runs at one
    // memory latency per key and the whole kernel takes about twice as long
    // on the H100. oks[] is 0 from nk on, so the batch may run past a ragged
    // chunk's end without reading there.
    for (int j0 = 0; j0 < nk; j0 += VB) {
      float vv[VB];
#pragma unroll
      for (int u = 0; u < VB; ++u)
        vv[u] = oks[j0 + u] ? __bfloat162float(vc[(long long)(j0 + u) * D + d]) : 0.f;
#pragma unroll
      for (int u = 0; u < VB; ++u) {
        if (!oks[j0 + u]) continue;
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = fmaf(ps[g][j0 + u], vv[u], acc[g]);
      }
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

// grid (B * Hq), block D. A chunk whose max is -inf holds no valid key and
// adds nothing (its weight would be exp2(-inf) = 0); it is skipped so that a
// dead chunk's weighted-V partial need not have been written.
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
      const float m = part_ml[(bh * NC + c) * 2];
      if (m == -INFINITY) continue;
      const float w = exp2f(m - M);
      L = fmaf(part_ml[(bh * NC + c) * 2 + 1], w, L);
      acc = fmaf(part_acc[(bh * NC + c) * D + d], w, acc);
    }
  }
  out[bh * D + d] = __float2bfloat16(L > 0.f ? acc / L : 0.f);
}

}  // namespace decode
