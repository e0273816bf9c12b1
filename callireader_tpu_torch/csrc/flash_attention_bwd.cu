// Trainable causal GQA flash attention with segment ids: the forward that
// also writes each row's log-sum-exp, and the two backward kernels.
//
// Replaces callireader_tpu/kernels/attention_bwd.py (flash_attention_trainable):
// the forward pallas_call (:276), the dq pallas_call (:333) and the dk/dv
// pallas_call (:360). q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), o/do/dq
// (B, Hq, Sq, D), dk/dv (B, Hkv, Sk, D), all bf16 contiguous; lse and
// dsum = rowsum(dO * O) (B, Hq, Sq) fp32; Hq = G * Hkv. Segment ids (B, S)
// int32 mask every pair whose ids differ; causal masks keys past the query's
// own position. The backward recomputes P = exp(S - lse) tile by tile
// (FlashAttention-2):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - dsum) * scale,
//   dQ = dS K,    dK = dS^T Q.
// A row with no attendable key writes o = 0 and lse = -1e30; its P is 0 in
// the backward, so it adds nothing to any gradient.
//
// What bounds it on the H100: operations (2, 3 and 4 products of 2*D flops
// per attended (query, key) pair for the forward, dq and dk/dv) against a
// few tens of MB.
//
// Forward: the tensor-core loop of flash_common.cuh (wgmma, TMA, a split P),
// built with its lse epilogue (LSE = true) and launched with q_offset = 0,
// the same loop as the ViT and prefill kernels. With segment ids its
// producer skips every key tile whose id range is disjoint from the query
// tile's, exactly as the backward's producers below do (at the e-IT shape,
// rows of ~1,470 tokens and a -1 tail in S = 2048, 2.51M of the 4.2M causal
// pairs are attended). Its O sums run over at most S keys in the wgmma
// accumulator; at S = 8192 its excess, 3.2e-6 on an H100 80GB HBM3 (700 W),
// stays within the check without moving O into fp32 sums
// (tools/attention_arith.py). Two blocks an SM, as the prefill: 168
// registers, no spill.
//
// Backward (dq_kernel, dkdv_kernel): tensor-core loops on Hopper
// (wgmma_common.cuh: wgmma, TMA, mbarriers; sm_90a). A block holds one
// consumer warpgroup and one producer warp; the producer copies the tiles by
// TMA into a ring of STAGES shared-memory stages (a "full" mbarrier says a
// stage landed, an "empty" one that the consumers are done with it), with the
// rows' segment ids, lse and dsum beside them, and pushes only tiles that can
// hold an attended pair: above the diagonal never, and not where the two
// tiles' id ranges are disjoint (exact: such a tile's P is 0). It ends the
// ring with a stage whose first row is -1.
//  - dq: the warpgroup owns a 64-row query tile (16 positions of each of the
//    G = 4 heads, as the forward loop of flash_common.cuh); Q and dO load
//    once, K/V tiles of 64 keys stream. Per tile S = Q K^T and dP = dO V^T
//    (both operands in shared memory, K-major), P = 2^(S c - lse2) with the
//    row's lse2 = lse log2(e), dS = P (dP - dsum), dQ += dS K (dS in
//    registers, K the MN-major B operand, two n64 halves at D = 128).
//  - dk/dv: the warpgroup owns 64 keys of one KV head; K and V load once,
//    and the ring streams Q and dO tiles of 64 positions for each of the G
//    heads and each query tile at or below the diagonal. Per tile
//    S^T = K Q^T and dP^T = V dO^T, P^T = 2^(S^T c - lse2[col]) with lse2
//    and dsum varying along the accumulator's columns (read from the stage),
//    dV += P^T dO and dK += dS^T Q, the streamed tile read once K-major and
//    once MN-major. dK and dV stay in the block (registers, then fp32 sums
//    in shared memory): no atomics, the same result on every run, hence dq
//    as a kernel of its own (as in JAX).
// A tensor-core product takes bf16 operands, and P or dS rounded to bf16
// once misses the fp32 check by 21-46x (kernels/tolerance.py); so each is
// split, hi = bf16(x) and lo = bf16(x - hi), and both parts go into the one
// fp32 accumulator: 4 products a pair for dq and 6 for dk/dv instead of 3
// and 4. The wgmma accumulator drifts over long sums (a dV summed over the
// 32,768 queries of S = 8192 in the accumulator alone stood 2.7e-4 beyond
// its rounding, over the check, against 4.9e-6 when moved every 8 query
// tiles: tools/backward_arith.py), so dk/dv moves dK and dV into fp32 sums in
// shared memory every DKV_FLUSH query tiles. Masks are applied only
// to tiles that need them (on the diagonal, with keys past S, or whose ids
// are not one common id). Registers: dk/dv holds dK, dV (128 a thread), S^T
// and dP^T (64) and the four fragment sets at 255 a thread, one block an SM;
// dq takes 193, so it too runs one block an SM (at two, its 168 spill).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace crt {

using namespace cr;

constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- backward

constexpr int DQ_INFO = KT + 2;  // a dq stage: KT key ids, their common id, the first key
// a dk/dv stage: lse2, dsum and ids of 64 query rows, the first row, the common id
constexpr int DKV_INFO = 3 * 64 + 4;
// query tiles between two moves of dK and dV from the wgmma accumulators
// into fp32 sums in shared memory
constexpr int DKV_FLUSH = 8;

struct BwdArgs {
  CUtensorMap tq, tdo, tk, tv;  // TMA maps (see launch_bwd)
  const float* lse;             // (B, Hq, Sq)
  const float* dsum;            // (B, Hq, Sq)
  const int* q_seg;             // (B, Sq) or null
  const int* k_seg;             // (B, Sk) or null
  __nv_bfloat16* out;           // dq, or dk
  __nv_bfloat16* out2;          // dv
  int Hq, Hkv, Sq, Sk, causal;
  float scale, scale_log2;  // softmax scale; scale * log2(e)
};

// the row's lse in log2 units; +inf for a row with no attendable key, so
// that its P = 2^(s - inf) is 0
__device__ __forceinline__ float lse_log2(float L) {
  return L > 0.5f * NO_KEY_LSE ? L * LOG2E : INFINITY;
}

template <int D, int STAGES>
constexpr int dq_smem_bytes() {
  return 1024 + (2 + 2 * STAGES) * Tile<D>::BYTES + STAGES * DQ_INFO * 4 + (2 * STAGES + 1) * 8;
}

template <int D, int STAGES>
constexpr int dkdv_smem_bytes() {
  return 1024 + (2 + 2 * STAGES) * Tile<D>::BYTES + 2 * WG_ROWS * D * 4 + STAGES * DKV_INFO * 4 +
         16 + (2 * STAGES + 1) * 8;
}

// ---------------------------------------------------------------- dq
// grid: one block per (query tile of 64 / G positions, KV head, batch row),
// flattened, the longest query tiles first (causal); block: the consumer
// warpgroup (threads 0-127), then the producer warp
template <int D, int G, int STAGES, int MINB>
__global__ void __launch_bounds__(WG_THREADS + 32, MINB)
    dq_kernel(const __grid_constant__ BwdArgs a) {
  using T = Tile<D>;
  constexpr int QW = WG_ROWS / G;  // query positions of a block
  static_assert(D == 128 && QW == 16, "a warp holds 16 rows of one head; D = 128 as two n64");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;          // the Q tile
  const uint32_t do_s = q_s + T::BYTES;                 // the dO tile
  const uint32_t kv_s = do_s + T::BYTES;                // STAGES x (K tile, V tile)
  const uint32_t info_s = kv_s + 2 * STAGES * T::BYTES;  // STAGES x DQ_INFO
  const uint32_t bar_s = info_s + STAGES * DQ_INFO * 4;
  int* info = reinterpret_cast<int*>(smem_raw + (info_s - raw));
  const uint32_t q_full = bar_s + 16 * STAGES;
  auto full = [&](int st) { return bar_s + 8 * st; };
  auto empty = [&](int st) { return bar_s + 8 * (STAGES + st); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nqb = (a.Sq + QW - 1) / QW;
  const int npair = gridDim.x / nqb;
  const int qb = a.causal ? nqb - 1 - static_cast<int>(blockIdx.x) / npair
                          : static_cast<int>(blockIdx.x) % nqb;
  const int pair = a.causal ? static_cast<int>(blockIdx.x) % npair
                            : static_cast<int>(blockIdx.x) / nqb;
  const int hkv = pair % a.Hkv, b = pair / a.Hkv;
  const int q0 = qb * QW;
  // keys past the block's last query row are never loaded (causal)
  const int k_end = a.causal ? min(a.Sk, min(q0 + QW, a.Sq)) : a.Sk;
  const int ntiles = (k_end + KT - 1) / KT;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 32);
      mbar_init(empty(st), WG_THREADS);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer: Q and dO once, then the K/V tiles that can hold an attended pair
    if (lane == 0) {
      mbar_arrive_tx(q_full, 2 * T::BYTES);
      for (int g = 0; g < G; ++g)
        for (int cb = 0; cb < T::NCB; ++cb) {
          const uint32_t off = cb * 64 * T::RB + g * QW * T::RB;
          tma_load(q_s + off, &a.tq, q_full, cb * T::RB / 2, q0, hkv * G + g, b);
          tma_load(do_s + off, &a.tdo, q_full, cb * T::RB / 2, q0, hkv * G + g, b);
        }
    }
    int qmin = 0, qmax = 0;  // the block's query ids
    if (a.k_seg != nullptr) {
      const int* qs = a.q_seg + (long long)b * a.Sq + q0;
      const int s = lane < min(QW, a.Sq - q0) ? qs[lane] : qs[0];
      qmin = __reduce_min_sync(0xffffffffu, s);
      qmax = __reduce_max_sync(0xffffffffu, s);
    }
    int it = 0;
    for (int t = 0; t <= ntiles; ++t) {  // t == ntiles: the end of the ring
      const int k0 = t * KT;
      int s0 = 0, s1 = 0, kcommon = MIXED;
      if (t < ntiles && a.k_seg != nullptr) {
        const int2 r = tile_ids(a.k_seg + (long long)b * a.Sk + k0, a.Sk - k0, lane, s0, s1);
        if (r.y < qmin || r.x > qmax) continue;  // no key shares an id with a query
        kcommon = r.x == r.y ? r.x : MIXED;
      }
      const int st = it % STAGES;
      if (it >= STAGES) mbar_wait(empty(st), (it / STAGES - 1) & 1);
      int* in = info + st * DQ_INFO;
      if (a.k_seg != nullptr) {
        in[lane] = s0;
        in[32 + lane] = s1;
      }
      if (lane == 0) {
        in[KT] = kcommon;
        in[KT + 1] = t < ntiles ? k0 : -1;
      }
      if (lane == 0 && t < ntiles) {
        mbar_arrive_tx(full(st), 2 * T::BYTES);
        const uint32_t ks = kv_s + st * 2 * T::BYTES;
        for (int cb = 0; cb < T::NCB; ++cb) {
          tma_load(ks + cb * 64 * T::RB, &a.tk, full(st), cb * T::RB / 2, k0, hkv, b);
          tma_load(ks + T::BYTES + cb * 64 * T::RB, &a.tv, full(st), cb * T::RB / 2, k0, hkv, b);
        }
      } else {
        mbar_arrive(full(st));
      }
      ++it;
    }
    return;
  }

  // consumer: this thread's two rows of the tile are r0 = 16 warp + lane / 4 and r0 + 8
  const float c = a.scale_log2;
  int pos[2], head[2], qseg[2], lim[2];
  float lse2[2], dsm[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 16 * warp + lane / 4 + 8 * rr;
    head[rr] = hkv * G + r / QW;
    pos[rr] = q0 + r % QW;
    const bool valid = pos[rr] < a.Sq;
    const long long row = ((long long)b * a.Hq + head[rr]) * a.Sq + pos[rr];
    qseg[rr] = (a.q_seg != nullptr && valid) ? a.q_seg[(long long)b * a.Sq + pos[rr]] : 0;
    lim[rr] = a.causal ? min(a.Sk, pos[rr] + 1) : a.Sk;  // keys from lim on are masked
    lse2[rr] = valid ? lse_log2(a.lse[row]) : INFINITY;  // rows past Sq weigh 0
    dsm[rr] = valid ? a.dsum[row] : 0.f;
  }

  float dq[2][32];  // dq[cb][4j + 2rr + e]: row r0 + 8 rr, column 64 cb + 8j + 2 (lane % 4) + e
#pragma unroll
  for (int cb = 0; cb < 2; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[cb][i] = 0.f;
  float s[32], dp[32];  // [4j + 2rr + e]: row r0 + 8 rr, key 8j + 2 (lane % 4) + e of the tile
  uint32_t fh[4][4], fl[4][4];

  mbar_wait(q_full, 0);
  for (int it = 0;; ++it) {
    const int st = it % STAGES;
    mbar_wait(full(st), (it / STAGES) & 1);
    const int* in = info + st * DQ_INFO;
    const int k0 = in[KT + 1];
    if (k0 < 0) break;
    const uint32_t ks = kv_s + st * 2 * T::BYTES, vs = ks + T::BYTES;

    // S = Q K^T, dP = dO V^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, T::k_step(q_s, kk), T::k_step(ks, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, T::k_step(do_s, kk), T::k_step(vs, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P = 2^(S c - lse2), then the mask where the tile needs one: keys that
    // share both rows' id need no id check, a tile wholly before both rows'
    // limits no bound check
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = fast_exp2(fmaf(s[i], c, -lse2[(i / 2) % 2]));
    if (a.k_seg != nullptr && !(in[KT] != MIXED && in[KT] == qseg[0] && in[KT] == qseg[1])) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2), rr = (i / 2) % 2;
        s[i] = (k0 + col < lim[rr] && in[col] == qseg[rr]) ? s[i] : 0.f;
      }
    } else if (k0 + KT > lim[0] || k0 + KT > lim[1]) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        s[i] = k0 + col < lim[(i / 2) % 2] ? s[i] : 0.f;
      }
    }
    // dS = P (dP - dsum), split into bf16 hi + lo A fragments
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] *= dp[i] - dsm[(i / 2) % 2];
    split_bf16_frags(s, fh, fl);

    // dQ += dS_hi K + dS_lo K
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
#pragma unroll
      for (int cb = 0; cb < 2; ++cb) {
        const uint64_t dk = T::mn_step(ks, cb, kt);
        wgmma_rs_n64(dq[cb], fh[kt], dk);
        wgmma_rs_n64(dq[cb], fl[kt], dk);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq[0]);
    fence_regs(dq[1]);
    mbar_arrive(empty(st));
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (pos[rr] >= a.Sq) continue;
    __nv_bfloat16* op = a.out + (((long long)b * a.Hq + head[rr]) * a.Sq + pos[rr]) * D;
#pragma unroll
    for (int cb = 0; cb < 2; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cb + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(op + col) = __floats2bfloat162_rn(
            dq[cb][4 * j + 2 * rr] * a.scale, dq[cb][4 * j + 2 * rr + 1] * a.scale);
      }
  }
}

// ---------------------------------------------------------------- dk / dv
// grid: one block per (tile of 64 keys, KV head, batch row), flattened, the
// first key tiles (the most query tiles) first (causal); block: the consumer
// warpgroup, then the producer warp
template <int D, int G, int STAGES, int MINB>
__global__ void __launch_bounds__(WG_THREADS + 32, MINB)
    dkdv_kernel(const __grid_constant__ BwdArgs a) {
  using T = Tile<D>;
  static_assert(D == 128, "D = 128 as two n64 products");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023u) & ~1023u;          // the K tile
  const uint32_t v_s = k_s + T::BYTES;                  // the V tile
  const uint32_t ring = v_s + T::BYTES;                 // STAGES x (Q tile, dO tile)
  const uint32_t sums_s = ring + 2 * STAGES * T::BYTES;  // fp32 dK, dV: [2 x 64 x D / 128][thread]
  const uint32_t info_s = sums_s + 2 * WG_ROWS * D * 4;  // STAGES x DKV_INFO, then the keys' common id
  const uint32_t bar_s = info_s + STAGES * DKV_INFO * 4 + 16;
  int* info = reinterpret_cast<int*>(smem_raw + (info_s - raw));
  int* kcommon_s = info + STAGES * DKV_INFO;
  float* sums = reinterpret_cast<float*>(smem_raw + (sums_s - raw)) + threadIdx.x;
  const uint32_t kv_full = bar_s + 16 * STAGES;
  auto full = [&](int st) { return bar_s + 8 * st; };
  auto empty = [&](int st) { return bar_s + 8 * (STAGES + st); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nkb = (a.Sk + KT - 1) / KT;
  const int npair = gridDim.x / nkb;
  const int kb = a.causal ? static_cast<int>(blockIdx.x) / npair
                          : static_cast<int>(blockIdx.x) % nkb;
  const int pair = a.causal ? static_cast<int>(blockIdx.x) % npair
                            : static_cast<int>(blockIdx.x) / nkb;
  const int hkv = pair % a.Hkv, b = pair / a.Hkv;
  const int k0 = kb * KT;
  // causal: query tiles before the block's first key see none of its keys
  const int q_begin = a.causal ? k0 : 0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 32);
      mbar_init(empty(st), WG_THREADS);
    }
    mbar_init(kv_full, 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {
    // producer: K and V once (and the keys' common id), then for each head
    // g < G and each query tile at or below the diagonal that shares an id
    // with the keys, the Q and dO tiles, the rows' lse2, dsum and ids
    int kmin = 0, kmax = 0, s0 = 0, s1 = 0;
    if (a.k_seg != nullptr) {
      const int2 r = tile_ids(a.k_seg + (long long)b * a.Sk + k0, a.Sk - k0, lane, s0, s1);
      kmin = r.x;
      kmax = r.y;
      if (lane == 0) *kcommon_s = kmin == kmax ? kmin : MIXED;
    }
    if (lane == 0) {
      mbar_arrive_tx(kv_full, 2 * T::BYTES);
      for (int cb = 0; cb < T::NCB; ++cb) {
        tma_load(k_s + cb * 64 * T::RB, &a.tk, kv_full, cb * T::RB / 2, k0, hkv, b);
        tma_load(v_s + cb * 64 * T::RB, &a.tv, kv_full, cb * T::RB / 2, k0, hkv, b);
      }
    } else {
      mbar_arrive(kv_full);
    }
    int it = 0;
    for (int g = 0; g <= G; ++g) {  // g == G: the end of the ring
      const int head = hkv * G + g;
      for (int qt0 = g < G ? q_begin : -1; qt0 < (g < G ? a.Sq : 0); qt0 += KT) {
        int qcommon = MIXED;
        if (qt0 >= 0 && a.q_seg != nullptr) {
          const int2 r = tile_ids(a.q_seg + (long long)b * a.Sq + qt0, a.Sq - qt0, lane, s0, s1);
          if (r.y < kmin || r.x > kmax) continue;  // no query shares an id with a key
          qcommon = r.x == r.y ? r.x : MIXED;
        }
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty(st), (it / STAGES - 1) & 1);
        int* in = info + st * DKV_INFO;
        if (qt0 >= 0) {
          float* l2 = reinterpret_cast<float*>(in);
          float* ds = l2 + 64;
          const long long row = ((long long)b * a.Hq + head) * a.Sq + qt0;
#pragma unroll
          for (int r = lane; r < 64; r += 32) {
            const bool valid = qt0 + r < a.Sq;  // rows past Sq weigh 0
            l2[r] = valid ? lse_log2(a.lse[row + r]) : INFINITY;
            ds[r] = valid ? a.dsum[row + r] : 0.f;
          }
          if (a.q_seg != nullptr) {
            in[128 + lane] = s0;
            in[160 + lane] = s1;
          }
        }
        if (lane == 0) {
          in[192] = qt0;
          in[193] = qcommon;
        }
        if (lane == 0 && qt0 >= 0) {
          mbar_arrive_tx(full(st), 2 * T::BYTES);
          const uint32_t qs = ring + st * 2 * T::BYTES;
          for (int cb = 0; cb < T::NCB; ++cb) {
            tma_load(qs + cb * 64 * T::RB, &a.tq, full(st), cb * T::RB / 2, qt0, head, b);
            tma_load(qs + T::BYTES + cb * 64 * T::RB, &a.tdo, full(st), cb * T::RB / 2, qt0,
                     head, b);
          }
        } else {
          mbar_arrive(full(st));
        }
        ++it;
      }
    }
    return;
  }

  // consumer: this thread's two keys are r0 = 16 warp + lane / 4 and r0 + 8
  // of the tile; its accumulator columns are query rows of the streamed tile
  const float c = a.scale_log2;
  int kpos[2], kseg[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    kpos[rr] = k0 + 16 * warp + lane / 4 + 8 * rr;
    kseg[rr] = (a.k_seg != nullptr && kpos[rr] < a.Sk) ? a.k_seg[(long long)b * a.Sk + kpos[rr]]
                                                        : 0;
  }
  float dk[2][32], dv[2][32];  // [cb][4j + 2rr + e]: key r0 + 8 rr, column 64 cb + 8j + 2 (lane % 4) + e
#pragma unroll
  for (int cb = 0; cb < 2; ++cb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[cb][i] = dv[cb][i] = 0.f;
  float s[32], dp[32];  // [4j + 2rr + e]: key r0 + 8 rr, query 8j + 2 (lane % 4) + e of the tile
  uint32_t ph[4][4], pl[4][4], dh[4][4], dl[4][4];
  // this thread's fp32 sums of dK and dV (element i at sums[128 i]: the
  // warp's lanes on neighbouring banks); the registers move into them every
  // DKV_FLUSH query tiles
#pragma unroll
  for (int i = 0; i < 128; ++i) sums[WG_THREADS * i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int it = 0;; ++it) {
    const int st = it % STAGES;
    mbar_wait(full(st), (it / STAGES) & 1);
    const int* in = info + st * DKV_INFO;
    const int qt0 = in[192];
    if (qt0 < 0) break;
    const float* l2 = reinterpret_cast<const float*>(in);
    const float* dsum = l2 + 64;
    const uint32_t qs = ring + st * 2 * T::BYTES, dos = qs + T::BYTES;

    // S^T = K Q^T, dP^T = V dO^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, T::k_step(k_s, kk), T::k_step(qs, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(dp, T::k_step(v_s, kk), T::k_step(dos, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = 2^(S^T c - lse2[col]), with each column's lse2 from the stage
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(l2 + 8 * j + 2 * (lane % 4));
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        s[4 * j + 2 * rr] = fast_exp2(fmaf(s[4 * j + 2 * rr], c, -l.x));
        s[4 * j + 2 * rr + 1] = fast_exp2(fmaf(s[4 * j + 2 * rr + 1], c, -l.y));
      }
    }
    // the mask where the tile needs one: ids, unless the queries share the
    // keys' one id (read from shared memory here: a register more spills);
    // causal, on a tile that reaches above the diagonal
    const int qcommon = in[193];
    if (a.q_seg != nullptr && !(qcommon != MIXED && qcommon == *kcommon_s)) {
      const int* qid = in + 128;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2), rr = (i / 2) % 2;
        const bool ok = qid[col] == kseg[rr] && (!a.causal || qt0 + col >= kpos[rr]);
        s[i] = ok ? s[i] : 0.f;
      }
    } else if (a.causal && qt0 < k0 + KT) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        s[i] = qt0 + col >= kpos[(i / 2) % 2] ? s[i] : 0.f;
      }
    }
    // dS^T = P^T (dP^T - dsum[col]) in dp
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(dsum + 8 * j + 2 * (lane % 4));
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        dp[4 * j + 2 * rr] = s[4 * j + 2 * rr] * (dp[4 * j + 2 * rr] - d.x);
        dp[4 * j + 2 * rr + 1] = s[4 * j + 2 * rr + 1] * (dp[4 * j + 2 * rr + 1] - d.y);
      }
    }
    split_bf16_frags(s, ph, pl);
    split_bf16_frags(dp, dh, dl);

    // dV += P^T_hi dO + P^T_lo dO, dK += dS^T_hi Q + dS^T_lo Q
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
#pragma unroll
      for (int cb = 0; cb < 2; ++cb) {
        const uint64_t ddo = T::mn_step(dos, cb, kt), dq = T::mn_step(qs, cb, kt);
        wgmma_rs_n64(dv[cb], ph[kt], ddo);
        wgmma_rs_n64(dv[cb], pl[kt], ddo);
        wgmma_rs_n64(dk[cb], dh[kt], dq);
        wgmma_rs_n64(dk[cb], dl[kt], dq);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int cb = 0; cb < 2; ++cb) {
      fence_regs(dk[cb]);
      fence_regs(dv[cb]);
    }
    mbar_arrive(empty(st));
    if (it % DKV_FLUSH == DKV_FLUSH - 1) {
#pragma unroll
      for (int cb = 0; cb < 2; ++cb)
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          sums[WG_THREADS * (32 * cb + i)] += dk[cb][i];
          sums[WG_THREADS * (64 + 32 * cb + i)] += dv[cb][i];
          dk[cb][i] = dv[cb][i] = 0.f;
        }
    }
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (kpos[rr] >= a.Sk) continue;
    const long long off = (((long long)b * a.Hkv + hkv) * a.Sk + kpos[rr]) * D;
#pragma unroll
    for (int cb = 0; cb < 2; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cb + 8 * j + 2 * (lane % 4);
        const int i = 32 * cb + 4 * j + 2 * rr;
        const float k0s = sums[WG_THREADS * i] + dk[cb][4 * j + 2 * rr];
        const float k1s = sums[WG_THREADS * (i + 1)] + dk[cb][4 * j + 2 * rr + 1];
        const float v0s = sums[WG_THREADS * (64 + i)] + dv[cb][4 * j + 2 * rr];
        const float v1s = sums[WG_THREADS * (65 + i)] + dv[cb][4 * j + 2 * rr + 1];
        *reinterpret_cast<__nv_bfloat162*>(a.out + off + col) =
            __floats2bfloat162_rn(k0s * a.scale, k1s * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(a.out2 + off + col) = __floats2bfloat162_rn(v0s, v1s);
      }
  }
}

// Instantiated for the LLM shape of every full-width preset (D = 128, G = 4).
inline bool supported(int Hq, int Hkv, int D) {
  return Hkv > 0 && Hq % Hkv == 0 && D == 128 && Hq / Hkv == 4;
}


constexpr int BWD_D = 128, BWD_G = 4;
constexpr int FWD_STAGES = 2, FWD_MINB = 2;  // the prefill's: two blocks an SM, no spill
constexpr int DQ_STAGES = 2, DQ_MINB = 1;   // at two blocks an SM (168 registers) it spills
constexpr int DKV_STAGES = 2, DKV_MINB = 1;  // dK and dV take 128 registers a thread

// the TMA maps of a backward launch: q and dO in boxes of `q_rows` rows,
// k and v of KT rows; -> false if the encoder is missing or refuses one
inline bool bwd_maps(BwdArgs& a, const void* q, const void* k, const void* v, const void* dO,
                     int B, int q_rows) {
  const long long D = BWD_D;
  const Operand oq{q, a.Sq, a.Hq, B, D, a.Sq * D, a.Hq * a.Sq * D};
  const Operand odo{dO, a.Sq, a.Hq, B, D, a.Sq * D, a.Hq * a.Sq * D};
  const Operand ok{k, a.Sk, a.Hkv, B, D, a.Sk * D, a.Hkv * a.Sk * D};
  const Operand ov{v, a.Sk, a.Hkv, B, D, a.Sk * D, a.Hkv * a.Sk * D};
  return encode_map<BWD_D>(&a.tq, oq, q_rows) && encode_map<BWD_D>(&a.tdo, odo, q_rows) &&
         encode_map<BWD_D>(&a.tk, ok, KT) && encode_map<BWD_D>(&a.tv, ov, KT);
}

inline BwdArgs bwd_args(const void* lse, const void* dsum, const void* q_seg, const void* k_seg,
                        int Hq, int Hkv, int Sq, int Sk, int causal, float scale) {
  BwdArgs a{};
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.q_seg = static_cast<const int*>(q_seg);
  a.k_seg = static_cast<const int*>(k_seg);
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.scale = scale;
  a.scale_log2 = scale * LOG2E;
  return a;
}

}  // namespace crt

extern "C" int attn_train_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                     void* lse, const void* q_seg, const void* k_seg, int B,
                                     int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                                     float scale, void* stream) {
  using namespace crt;
  if (!supported(Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  const Operand qo{q, Sq, Hq, B, D, (long long)Sq * D, (long long)Hq * Sq * D};
  const Operand ko{k, Sk, Hkv, B, D, (long long)Sk * D, (long long)Hkv * Sk * D};
  Operand vo = ko;
  vo.p = v;
  AttnArgs a{};
  a.o = static_cast<__nv_bfloat16*>(out);
  a.o_sb = (long long)Hq * Sq * D;
  a.o_sh = (long long)Sq * D;
  a.o_ss = D;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.q_offset = 0;
  a.q_seg = static_cast<const int*>(q_seg);
  a.k_seg = static_cast<const int*>(k_seg);
  a.scale_log2 = scale * LOG2E;
  a.lse = static_cast<float*>(lse);
  return launch_flash<BWD_D, BWD_G, FWD_STAGES, FWD_MINB, true, true>(a, qo, ko, vo,
                                                                static_cast<cudaStream_t>(stream));
}

extern "C" int attn_train_dq_launch(const void* q, const void* k, const void* v, const void* dO,
                                    const void* lse, const void* dsum, const void* q_seg,
                                    const void* k_seg, void* dq, int B, int Hq, int Hkv, int Sq,
                                    int Sk, int D, int causal, float scale, void* stream) {
  using namespace crt;
  if (!supported(Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  BwdArgs a = bwd_args(lse, dsum, q_seg, k_seg, Hq, Hkv, Sq, Sk, causal, scale);
  a.out = static_cast<__nv_bfloat16*>(dq);
  constexpr int QW = WG_ROWS / BWD_G;
  if (!bwd_maps(a, q, k, v, dO, B, QW)) return (int)cudaErrorInvalidValue;
  constexpr int smem = dq_smem_bytes<BWD_D, DQ_STAGES>();
  auto kern = dq_kernel<BWD_D, BWD_G, DQ_STAGES, DQ_MINB>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((Sq + QW - 1) / QW) * Hkv * B;
  if (blocks == 0) return 0;
  kern<<<(unsigned)blocks, WG_THREADS + 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int attn_train_dkv_launch(const void* q, const void* k, const void* v, const void* dO,
                                     const void* lse, const void* dsum, const void* q_seg,
                                     const void* k_seg, void* dk, void* dv, int B, int Hq,
                                     int Hkv, int Sq, int Sk, int D, int causal, float scale,
                                     void* stream) {
  using namespace crt;
  if (!supported(Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  BwdArgs a = bwd_args(lse, dsum, q_seg, k_seg, Hq, Hkv, Sq, Sk, causal, scale);
  a.out = static_cast<__nv_bfloat16*>(dk);
  a.out2 = static_cast<__nv_bfloat16*>(dv);
  if (!bwd_maps(a, q, k, v, dO, B, KT)) return (int)cudaErrorInvalidValue;
  constexpr int smem = dkdv_smem_bytes<BWD_D, DKV_STAGES>();
  auto kern = dkdv_kernel<BWD_D, BWD_G, DKV_STAGES, DKV_MINB>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((Sk + KT - 1) / KT) * Hkv * B;
  if (blocks == 0) return 0;
  kern<<<(unsigned)blocks, WG_THREADS + 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
