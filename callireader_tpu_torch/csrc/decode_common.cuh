// What the split-K single-token GQA decode kernels share: flash_decode.cu
// over the contiguous cache and paged_decode.cu over the page pool. Both
// stream chunks of up to 64 keys of one KV head through a shared-memory ring
// and leave an fp32 partial (max, sum, weighted V) per query head and run
// of chunks; their producers differ, their consumers are the code below.
// - `WarpSoftmax`: a consumer warp's online softmax over its 16 keys of each
//   chunk, for the G = 4 query heads of the KV head at D = 128. q K: eight
//   lanes a key, each 16 of the 128 dims (two 16-byte loads, the eight lanes
//   of a load phase on one contiguous 128-byte half row, so no bank
//   conflict; the loads of all 16 keys issued first), reduced by three
//   shuffles a key for the four heads together; the chunk's max by warp
//   shuffles, no serial loop. P V: a lane owns 4 dims of all four heads and
//   walks the valid keys, four keys' loads at a time (an 8-byte load a lane,
//   one 256-byte V row a warp); a masked key's K and V are never used, so a
//   stage's rows past a ragged chunk's end may hold anything. A warp none
//   of whose keys is valid leaves its state as it was (every key masked
//   would move no bit of it) and skips the chunk.
// - `merge_run`: at a run's end the four warps' states merge in warp order
//   into the run's partial; a run with no valid key leaves (max = -inf,
//   sum = 0) and no weighted V.
// - `decode_combine`: the second pass, which merges a row's partials in
//   partial order; a partial whose max is -inf is never read for its
//   weighted V, and a row with no valid key at all comes out as zeros.
// The order is fixed by the shapes alone, so the same inputs give the same
// bits.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace decode {

constexpr int DD = 128;     // head dim
constexpr int DG = 4;       // query heads of a KV head
constexpr int DWARPS = 4;   // consumer warps
constexpr int DKW = 16;     // keys of a chunk a consumer warp owns
constexpr int DROW = DD * 2;  // bytes of a K or V row
// shared memory merge_run needs: the warps' weighted V and (max, sum)
constexpr int MERGE_BYTES = DWARPS * DG * (DD + 2) * 4;

__device__ __forceinline__ float2 bf16x2_to_f2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
}

// lane l = lane % 8 of key quarter lane / 8 holds dims 8l .. 8l + 7 and
// 64 + 8l .. 64 + 8l + 7 of the 4 heads at `q` (G rows of D), prescaled
__device__ __forceinline__ void load_q(const __nv_bfloat16* q, float scale_log2, int lane,
                                       float (&qf)[DG][16]) {
  const int l = lane % 8;
#pragma unroll
  for (int h = 0; h < DG; ++h)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      qf[h][e] = __bfloat162float(q[h * DD + 8 * l + e]) * scale_log2;
      qf[h][8 + e] = __bfloat162float(q[h * DD + 64 + 8 * l + e]) * scale_log2;
    }
}

struct WarpSoftmax {
  float m[DG], lsum[DG], acc[DG][4];  // per head: max, sum (this lane's part), V of 4 dims

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int h = 0; h < DG; ++h) {
      m[h] = -INFINITY;
      lsum[h] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;
    }
  }

  // the warp's 16 keys of one chunk: ks / vs its first K / V row in shared
  // memory, bit k of `bits` set when key k is valid, sc its 16 float4 of
  // shared scratch
  __device__ __forceinline__ void step(const uint8_t* ks, const uint8_t* vs, unsigned bits,
                                       const float (&qf)[DG][16], float4* sc, int lane) {
    if (bits == 0) return;
    const int quarter = lane / 8, l = lane % 8;
    const bool hi4 = lane & 4, hi2 = lane & 2;
    const int hq = (hi4 ? 2 : 0) + (hi2 ? 1 : 0);  // the head a lane's reduced score is for
    // q K: four keys a pass, a quarter warp each; the four passes' loads first
    uint4 kv[4][2];
#pragma unroll
    for (int p4 = 0; p4 < 4; ++p4) {
      const uint8_t* kr = ks + (4 * p4 + quarter) * DROW;
      kv[p4][0] = *reinterpret_cast<const uint4*>(kr + 16 * l);
      kv[p4][1] = *reinterpret_cast<const uint4*>(kr + 128 + 16 * l);
    }
#pragma unroll
    for (int p4 = 0; p4 < 4; ++p4) {
      const uint32_t wv[8] = {kv[p4][0].x, kv[p4][0].y, kv[p4][0].z, kv[p4][0].w,
                              kv[p4][1].x, kv[p4][1].y, kv[p4][1].z, kv[p4][1].w};
      float d[DG] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float2 kf = bf16x2_to_f2(wv[e]);
#pragma unroll
        for (int h = 0; h < DG; ++h) {
          d[h] = fmaf(qf[h][2 * e], kf.x, d[h]);
          d[h] = fmaf(qf[h][2 * e + 1], kf.y, d[h]);
        }
      }
      // over the quarter's 8 lanes: halve the heads twice, then pair up
      float a0 = hi4 ? d[2] : d[0], a1 = hi4 ? d[3] : d[1];
      a0 += __shfl_xor_sync(0xffffffffu, hi4 ? d[0] : d[2], 4);
      a1 += __shfl_xor_sync(0xffffffffu, hi4 ? d[1] : d[3], 4);
      float sr = hi2 ? a1 : a0;
      sr += __shfl_xor_sync(0xffffffffu, hi2 ? a0 : a1, 2);
      sr += __shfl_xor_sync(0xffffffffu, sr, 1);
      if ((l & 1) == 0) reinterpret_cast<float*>(sc + 4 * p4 + quarter)[hq] = sr;
    }
    __syncwarp();
    // online softmax over the warp's 16 keys: lane k < 16 has key k
    const bool ok = lane < DKW && ((bits >> lane) & 1u);
    const float4 s4 = ok ? sc[lane] : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
    const float sv[DG] = {s4.x, s4.y, s4.z, s4.w};
    float p[DG];
#pragma unroll
    for (int h = 0; h < DG; ++h) {
      float mx = sv[h];
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      mx = __shfl_sync(0xffffffffu, mx, 0);
      const float mn = fmaxf(m[h], mx);
      const float alpha = mn == -INFINITY ? 1.f : exp2f(m[h] - mn);
      p[h] = ok ? exp2f(sv[h] - mn) : 0.f;
      lsum[h] = fmaf(lsum[h], alpha, p[h]);
      m[h] = mn;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][e] *= alpha;
    }
    __syncwarp();
    if (lane < DKW) sc[lane] = make_float4(p[0], p[1], p[2], p[3]);
    __syncwarp();
    // P V: lane owns dims 4 lane .. 4 lane + 3; four keys' loads at a time
#pragma unroll
    for (int k0 = 0; k0 < DKW; k0 += 4) {
      uint2 v[4];
      float4 pk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = *reinterpret_cast<const uint2*>(vs + (k0 + u) * DROW + 8 * lane);
        pk[u] = sc[k0 + u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (((bits >> (k0 + u)) & 1u) == 0) continue;  // a masked key's V is never used
        const float2 v01 = bf16x2_to_f2(v[u].x), v23 = bf16x2_to_f2(v[u].y);
        const float vv[4] = {v01.x, v01.y, v23.x, v23.y};
        const float pp[DG] = {pk[u].x, pk[u].y, pk[u].z, pk[u].w};
#pragma unroll
        for (int h = 0; h < DG; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][e] = fmaf(pp[h], vv[e], acc[h][e]);
      }
    }
  }

  // the sums over the warp's lanes, at the run's end
  __device__ __forceinline__ void finish() {
#pragma unroll
    for (int h = 0; h < DG; ++h)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], o);
  }
};

// Every thread of the block calls this at the run's end; warps 0 .. DWARPS -
// 1 hold their states in `st`. `scratch` (MERGE_BYTES of shared memory, free
// to overwrite) takes them; the merged partial of query head h goes to row
// (qrow0 + h) * NR + run of part_acc (rows of DD) and part_ml (max, sum).
__device__ __forceinline__ void merge_run(const WarpSoftmax& st, uint8_t* scratch,
                                          float* __restrict__ part_acc,
                                          float* __restrict__ part_ml, long long qrow0, int NR,
                                          int run) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* wacc = reinterpret_cast<float*>(scratch);  // (warps, G, D)
  float* wml = wacc + DWARPS * DG * DD;             // (warps, G, 2)
  __syncthreads();  // the scratch is no longer read as the ring
  if (warp < DWARPS) {
#pragma unroll
    for (int h = 0; h < DG; ++h) {
      *reinterpret_cast<float4*>(wacc + (warp * DG + h) * DD + 4 * lane) =
          make_float4(st.acc[h][0], st.acc[h][1], st.acc[h][2], st.acc[h][3]);
      if (lane == 0) {
        wml[(warp * DG + h) * 2] = st.m[h];
        wml[(warp * DG + h) * 2 + 1] = st.lsum[h];
      }
    }
  }
  __syncthreads();
  // merge the warps in order: thread d of head h (4 x 128 = 512 outputs)
  for (int o = threadIdx.x; o < DG * DD; o += blockDim.x) {
    const int h = o / DD, d = o % DD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) mx = fmaxf(mx, wml[(w * DG + h) * 2]);
    const long long row = (qrow0 + h) * NR + run;
    if (mx == -INFINITY) {  // no valid key in the run: the combine skips it
      if (d == 0) {
        part_ml[row * 2] = -INFINITY;
        part_ml[row * 2 + 1] = 0.f;
      }
      continue;
    }
    float L = 0.f, s = 0.f;
#pragma unroll
    for (int w = 0; w < DWARPS; ++w) {
      const float mw = wml[(w * DG + h) * 2];
      if (mw == -INFINITY) continue;
      const float c = exp2f(mw - mx);
      L = fmaf(wml[(w * DG + h) * 2 + 1], c, L);
      s = fmaf(wacc[(w * DG + h) * DD + d], c, s);
    }
    part_acc[row * DD + d] = s;
    if (d == 0) {
      part_ml[row * 2] = mx;
      part_ml[row * 2 + 1] = L;
    }
  }
}

// grid (B * Hq), block D. A partial whose max is -inf holds no valid key and
// adds nothing (its weight would be exp2(-inf) = 0); it is skipped so that
// its weighted V need not have been written. The partials' (max, sum) pairs
// are read by all threads at once, D at a time, and each weight is computed
// once into shared memory, so a row's partials cost a few round trips, not
// two for each partial; the sums still add in partial order.
template <int D>
__global__ void __launch_bounds__(D) decode_combine(const float* __restrict__ part_acc,
                                                    const float* __restrict__ part_ml,
                                                    __nv_bfloat16* __restrict__ out, int NC) {
  __shared__ float ms[D], ws[D], ls[D], red[D / 32];
  const long long bh = blockIdx.x;
  const int t = threadIdx.x;
  const float* ml = part_ml + bh * NC * 2;
  // the largest max, over the thread's partials, then the block (a max is
  // exact in any order)
  float M = -INFINITY;
  for (int c = t; c < NC; c += D) M = fmaxf(M, ml[2 * c]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  if (t % 32 == 0) red[t / 32] = M;
  __syncthreads();
  M = red[0];
#pragma unroll
  for (int i = 1; i < D / 32; ++i) M = fmaxf(M, red[i]);
  float L = 0.f, acc = 0.f;
  if (M != -INFINITY) {  // the same for every thread of the block
    for (int c0 = 0; c0 < NC; c0 += D) {
      const int n = min(D, NC - c0);
      __syncthreads();  // the previous group's weights have been read
      if (t < n) {
        const float m = ml[2 * (c0 + t)];
        ms[t] = m;
        ws[t] = m == -INFINITY ? 0.f : exp2f(m - M);
        ls[t] = ml[2 * (c0 + t) + 1];
      }
      __syncthreads();
      const float* a = part_acc + (bh * NC + c0) * D + t;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        if (ms[i] == -INFINITY) continue;
        L = fmaf(ls[i], ws[i], L);
        acc = fmaf(a[(long long)i * D], ws[i], acc);
      }
    }
  }
  out[bh * D + t] = __float2bfloat16(L > 0.f ? acc / L : 0.f);
}

}  // namespace decode
