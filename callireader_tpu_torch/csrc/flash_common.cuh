// Shared forward attention loop of the port on Hopper's tensor cores (wgmma
// and TMA, sm_90a): the ViT packed-QKV attention and the LLM prefill
// (flash_attention.cu, vit_attention.cu) and the e-IT training forward, which
// also writes each row's log-sum-exp (flash_attention_bwd.cu, LSE = true).
//
// Layout. A block holds one consumer warpgroup of 128 threads and one
// producer warp. The warpgroup owns a 64-row query tile (the M of one
// wgmma): QW = 64 / G consecutive query positions of each of the G query
// heads that share one KV head, so every K/V tile the block stages serves the
// whole GQA group (warp w holds head w's 16 positions when G = 4). The
// producer warp copies the Q tile once and then K/V tiles of KT = 64 keys
// into a ring of STAGES shared-memory stages with TMA: a "full" mbarrier says
// a stage has landed, an "empty" one that the consumers are done with it, so
// the next tiles' copies overlap this tile's products. Each stage carries its
// first key. With segment ids the producer pushes no key tile whose id range
// is disjoint from the query tile's (every row's maximum, l and O would pass
// through such a tile unchanged: alpha = 1, P = 0, so the skip is exact) and
// ends the ring with a stage whose first key is -1. Q, K and V sit in
// shared memory in the swizzled layout that TMA writes and wgmma reads
// (128-byte rows of 64 columns per column block; 64-byte rows when D = 32).
//
// Products. S = Q K^T: wgmma m64n64k16 with both operands in shared memory
// (K-major), fp32 accumulators. O += P V: P is the score accumulator turned
// in place into wgmma's register A fragments, V the shared-memory B operand
// (MN-major). A tensor-core product takes bf16 operands, and a softmax
// weight rounded to bf16 misses the fp32 plain version by 30-180x the
// tolerance (kernels/tolerance.py); so P is split, P_hi = bf16(P) and
// P_lo = bf16(P - P_hi), and both products go into the one fp32 accumulator
// (1.5x the tensor-core work of a single P V). The row sum l is taken from
// the fp32 P.
//
// Softmax. Online softmax in fp32 in the log2 domain: the fp32 scores are
// scaled by softmax scale * log2(e) (Q stays exact in bf16). Masked keys get
// -inf and weigh exactly 0, so a row that attends to nothing ends with l == 0
// and is written as zeros (and lse = -1e30). Keys past Sk arrive as zeros
// (TMA's out-of-bounds fill) and are masked. The CUDA-core work per score
// bounds the loop more than the products, so only tiles that need it are
// masked (the producer marks a tile whose keys share one segment id), and O
// is rescaled only when a row's maximum moved. Causal: tiles past the
// block's last query row are never loaded, and the grid starts with the
// longest query tiles. The lse epilogue writes m * scale + ln(l) from the
// row maximum m and the quad-reduced l.
//
// Operands are 4-D (D, S, H, B) bf16 views with any 16-byte aligned strides
// (elements) of S, H and B; the Python wrappers check D % 8 == 0 and the base
// pointers. V may be narrower than Q and K (DV < D: latent attention's
// prefill, Dqk 192 and Dv 128); DV = D unless a launch says otherwise.
#pragma once

#include <limits.h>
#include <math.h>

#include "wgmma_common.cuh"

namespace cr {

constexpr int KT = 64;           // keys per shared-memory tile (the N of S = Q K^T)
constexpr int SEGW = KT + 2;     // a stage: KT keys' segment ids, the tile's common id, its first key
constexpr int MIXED = INT_MIN;   // common id of a tile whose keys' ids differ
constexpr float LN2 = 0.6931471805599453f;
constexpr float NO_KEY_LSE = -1e30f;  // lse of a row with no attendable key

struct AttnArgs {
  CUtensorMap tq, tk, tv;  // TMA maps of q, k, v (see launch_flash)
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;  // batch, head, sequence strides of o (elements)
  int Hkv;  // KV heads (the G query heads of KV head h are h * G + g)
  int Sq, Sk;
  int causal;
  int q_offset;      // query row i sits at key position i + q_offset
  const int* q_seg;  // (B, Sq) or null
  const int* k_seg;  // (B, Sk) or null
  float scale_log2;  // softmax scale * log2(e)
  float* lse;        // (B, Hkv G, Sq) fp32, written by the LSE build only
};

// the Q tile, a ring of STAGES (K tile, V tile, the keys' segment ids), and
// the mbarriers full[STAGES], empty[STAGES], q_full, from a 1024-byte aligned base
template <int D, int STAGES, int DV = D>
constexpr int smem_bytes() {
  return 1024 + (1 + STAGES) * Tile<D>::BYTES + STAGES * Tile<DV>::BYTES + STAGES * SEGW * 4 +
         (2 * STAGES + 1) * 8;
}

// ------------------------------------------------------------------ kernel

// grid: one block per (query tile of 64 / G positions, KV head, batch row),
// flattened; block: the consumer warpgroup (threads 0-127), then the
// producer warp; MINB blocks an SM (it caps the registers a thread); IDS:
// the launch may pass segment ids (without, the ids' masks, the tile skip
// and the ring's end marker compile out, as the ViT towers take none); LSE:
// also write each row's natural-log log-sum-exp to a.lse; DV: V's width
template <int D, int G, int STAGES, int MINB, bool IDS, bool LSE, int DV = D>
__global__ void __launch_bounds__(WG_THREADS + 32, MINB)
    flash_fwd_kernel(const __grid_constant__ AttnArgs a) {
  using T = Tile<D>;
  using TV = Tile<DV>;
  constexpr int QW = WG_ROWS / G;         // query positions of a block
  constexpr int NO = DV >= 64 ? 64 : DV;  // N of one P V product
  constexpr int NCH = DV / NO;
  constexpr int KV_BYTES = T::BYTES + TV::BYTES;  // a stage's K tile and V tile
  static_assert(WG_ROWS % G == 0 && (G == 1 || QW == 16), "a warp holds 16 rows of one head");

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023u) & ~1023u;          // the Q tile
  const uint32_t kv_s = q_s + T::BYTES;               // STAGES x (K tile, V tile)
  const uint32_t seg_s = kv_s + STAGES * KV_BYTES;    // STAGES x SEGW segment ids
  const uint32_t bar_s = seg_s + STAGES * SEGW * 4;
  int* segs = reinterpret_cast<int*>(smem_raw + (seg_s - raw));
  const uint32_t q_full = bar_s + 16 * STAGES;
  auto full = [&](int st) { return bar_s + 8 * st; };
  auto empty = [&](int st) { return bar_s + 8 * (STAGES + st); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // causal: the longest query tiles first, so the grid ends with short blocks
  const int nqb = (a.Sq + QW - 1) / QW;
  const int npair = gridDim.x / nqb;
  const int qb = a.causal ? nqb - 1 - static_cast<int>(blockIdx.x) / npair
                          : static_cast<int>(blockIdx.x) % nqb;
  const int pair = a.causal ? static_cast<int>(blockIdx.x) % npair
                            : static_cast<int>(blockIdx.x) / nqb;
  const int hkv = pair % a.Hkv, b = pair / a.Hkv;
  const int q0 = qb * QW;
  // keys past the block's last query row are never loaded (causal)
  const int k_end = a.causal ? min(a.Sk, min(q0 + QW, a.Sq) + a.q_offset) : a.Sk;
  const int ntiles = (k_end + KT - 1) / KT;
  const bool ids = IDS && a.k_seg != nullptr;

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
    // producer: Q once, then the K/V tiles that can hold an attended pair
    // (and the keys' segment ids) into the ring, then the end marker
    if (lane == 0) {
      mbar_arrive_tx(q_full, T::BYTES);
      for (int g = 0; g < G; ++g)
        for (int cb = 0; cb < T::NCB; ++cb)
          tma_load(q_s + cb * 64 * T::RB + g * QW * T::RB, &a.tq, q_full, cb * T::RB / 2, q0,
                   hkv * G + g, b);
    }
    int qmin = 0, qmax = 0;  // the block's query ids (0 without q_seg, as the consumers take)
    if (ids && a.q_seg != nullptr) {
      int s0, s1;
      const int2 r = tile_ids(a.q_seg + (long long)b * a.Sq + q0, min(QW, a.Sq - q0), lane, s0, s1);
      qmin = r.x;
      qmax = r.y;
    }
    int it = 0;
    // t == ntiles: the end of the ring, marked only where tiles may be skipped
    for (int t = 0; t < ntiles + ids; ++t) {
      const int k0 = t * KT;
      int s0 = 0, s1 = 0, common = MIXED;
      if (t < ntiles && ids) {
        // the ids, and whether the tile's keys share one (keys past Sk count
        // as sharing it: they are masked as such)
        const int2 r = tile_ids(a.k_seg + (long long)b * a.Sk + k0, a.Sk - k0, lane, s0, s1);
        if (r.y < qmin || r.x > qmax) continue;  // no key shares an id with a query
        common = r.x == r.y ? r.x : MIXED;
      }
      const int st = it % STAGES;
      if (it >= STAGES) mbar_wait(empty(st), (it / STAGES - 1) & 1);
      int* sg = segs + st * SEGW;
      if (ids) {
        sg[lane] = s0;
        sg[32 + lane] = s1;
        if (lane == 0) {
          sg[KT] = common;
          sg[KT + 1] = t < ntiles ? k0 : -1;
        }
      }
      if (lane == 0 && t < ntiles) {
        mbar_arrive_tx(full(st), KV_BYTES);
        const uint32_t ks = kv_s + st * KV_BYTES;
        for (int cb = 0; cb < T::NCB; ++cb)
          tma_load(ks + cb * 64 * T::RB, &a.tk, full(st), cb * T::RB / 2, k0, hkv, b);
        for (int cb = 0; cb < TV::NCB; ++cb)
          tma_load(ks + T::BYTES + cb * 64 * TV::RB, &a.tv, full(st), cb * TV::RB / 2, k0, hkv, b);
      } else {
        mbar_arrive(full(st));
      }
      ++it;
    }
    return;
  }

  // consumer: this thread's two rows of the tile are r0 = 16 warp + lane / 4 and r0 + 8
  const float c = a.scale_log2;
  int pos[2], qseg[2], head[2], lim[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int r = 16 * warp + lane / 4 + 8 * rr;
    head[rr] = hkv * G + r / QW;
    pos[rr] = q0 + r % QW;
    qseg[rr] = (a.q_seg != nullptr && pos[rr] < a.Sq) ? a.q_seg[(long long)b * a.Sq + pos[rr]] : 0;
    // keys from lim[rr] on are past Sk or after the row (causal)
    lim[rr] = a.causal ? min(a.Sk, pos[rr] + a.q_offset + 1) : a.Sk;
  }

  float o[NCH][NO / 2];
#pragma unroll
  for (int ci = 0; ci < NCH; ++ci)
#pragma unroll
    for (int i = 0; i < NO / 2; ++i) o[ci][i] = 0.f;
  float s[32];  // s[4j + 2rr + e]: row r0 + 8 rr, key 8j + 2 (lane % 4) + e of the tile
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  uint32_t ph[4][4], pl[4][4];  // P_hi, P_lo as A fragments of keys 16t .. 16t + 15
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(q_full, 0);
  for (int it = 0;; ++it) {
    if (!ids && it == ntiles) break;  // no ids: every tile came, unmarked
    const int st = it % STAGES;
    mbar_wait(full(st), (it / STAGES) & 1);
    const int* sg = segs + st * SEGW;
    const int k0 = ids ? sg[KT + 1] : it * KT;
    if (k0 < 0) break;
    const uint32_t ks = kv_s + st * KV_BYTES, vs = ks + T::BYTES;

    // S = Q K^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64(s, T::k_step(q_s, kk), T::k_step(ks, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // mask: a tile of keys that share the segment id of both rows needs no
    // id check, one wholly before both rows' limits no bound check
    if (ids && !(sg[KT] != MIXED && sg[KT] == qseg[0] && sg[KT] == qseg[1])) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        const bool ok = k0 + col < lim[(i / 2) % 2] && sg[col] == qseg[(i / 2) % 2];
        s[i] = ok ? s[i] : -INFINITY;
      }
    } else if (k0 + KT > lim[0] || k0 + KT > lim[1]) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
        s[i] = k0 + col < lim[(i / 2) % 2] ? s[i] : -INFINITY;
      }
    }

    // online softmax: the row maxima over the quad, P = 2^(S c - m c) in s
    float mx[2] = {-INFINITY, -INFINITY}, alpha[2], neg_mu[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 32; ++i) mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      const float mu = m_new == -INFINITY ? 0.f : m_new * c;  // nothing attendable yet: p = 0
      alpha[rr] = fast_exp2(m[rr] * c - mu);
      neg_mu[rr] = -mu;
      m[rr] = m_new;
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      s[i] = fast_exp2(fmaf(s[i], c, neg_mu[(i / 2) % 2]));
      ls[(i / 2) % 2] += s[i];
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * alpha[rr] + ls[rr];
    // O *= alpha, skipped when no row of the warp has a new maximum
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int ci = 0; ci < NCH; ++ci)
#pragma unroll
        for (int i = 0; i < NO / 2; ++i) o[ci][i] *= alpha[(i / 2) % 2];
    }

    // P_hi = bf16(P), P_lo = bf16(P - P_hi), as A fragments
    split_bf16_frags(s, ph, pl);

    // O += P_hi V + P_lo V
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < 4; ++kt) {
#pragma unroll
      for (int ci = 0; ci < NCH; ++ci) {
        const uint64_t dv = TV::mn_step(vs, ci, kt);
        if constexpr (NO == 64) {
          wgmma_rs_n64(o[ci], ph[kt], dv);
          wgmma_rs_n64(o[ci], pl[kt], dv);
        } else {
          wgmma_rs_n32(o[ci], ph[kt], dv);
          wgmma_rs_n32(o[ci], pl[kt], dv);
        }
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int ci = 0; ci < NCH; ++ci) fence_regs(o[ci]);
    mbar_arrive(empty(st));
  }

  // o[ci][4j + 2rr + e] is row r0 + 8 rr, column ci NO + 8j + 2 (lane % 4) + e
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lr = l[rr];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    if (pos[rr] >= a.Sq) continue;
    if constexpr (LSE) {
      // natural-log lse: m is a raw score, m c its log2-domain value
      if (lane % 4 == 0)
        a.lse[((long long)b * a.Hkv * G + head[rr]) * a.Sq + pos[rr]] =
            lr > 0.f ? m[rr] * c * LN2 + logf(lr) : NO_KEY_LSE;
    }
    const float inv = lr > 0.f ? 1.f / lr : 0.f;
    __nv_bfloat16* op = a.o + b * a.o_sb + head[rr] * a.o_sh + (long long)pos[rr] * a.o_ss;
#pragma unroll
    for (int ci = 0; ci < NCH; ++ci)
#pragma unroll
      for (int j = 0; j < NO / 8; ++j) {
        const int col = ci * NO + 8 * j + 2 * (lane % 4);
        *reinterpret_cast<__nv_bfloat162*>(op + col) =
            __floats2bfloat162_rn(o[ci][4 * j + 2 * rr] * inv, o[ci][4 * j + 2 * rr + 1] * inv);
      }
  }
}

template <int D, int G, int STAGES, int MINB, bool IDS, bool LSE = false, int DV = D>
inline int launch_flash(AttnArgs a, const Operand& q, const Operand& k, const Operand& v,
                        cudaStream_t stream) {
  constexpr int QW = WG_ROWS / G;
  constexpr int smem = smem_bytes<D, STAGES, DV>();
  if (!encode_map<D>(&a.tq, q, WG_ROWS / G) || !encode_map<D>(&a.tk, k, KT) ||
      !encode_map<DV>(&a.tv, v, KT))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D, G, STAGES, MINB, IDS, LSE, DV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)((a.Sq + QW - 1) / QW) * a.Hkv * q.B;
  if (blocks == 0) return 0;
  flash_fwd_kernel<D, G, STAGES, MINB, IDS, LSE, DV>
      <<<(unsigned)blocks, WG_THREADS + 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace cr
