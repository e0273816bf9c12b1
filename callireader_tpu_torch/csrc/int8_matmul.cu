// Weight-only int8 matrix products for decode: h (M, K) bf16 times an int8
// weight with per-out-channel fp32 scales -> (M, N) bf16, M <= 32.
//
// Replaces callireader_tpu/kernels/int8_matmul.py:
//   - int8_matmul_kn: int8_matmul_stacked and int8_matmul, weight (K, N). The
//     TPU needed a scalar-prefetch kernel to address one layer of the (L, K, N)
//     stack in place; here the caller passes the layer's base pointer (a view
//     in PyTorch, no copy), so this one kernel serves both JAX entry points.
//   - int8_matmul_nt: int8_matmul_nt, weight (N, K) (the LM head), each output
//     column a contiguous int8 row of length K.
// Arithmetic of the TPU kernel: int8 -> float is exact and a bf16 x bf16
// product is exact in fp32, the sum over K is fp32, the fp32 scale is applied
// once, the result is rounded to bf16 once.
//
// Bound on the H100: the int8 weight bytes (K*N), about 2*M flops per byte
// (2M <= 64 against the card's ~295), so both kernels read each weight byte
// once for any M <= 32, through a ring of shared-memory stages that a
// producer warp fills by TMA, and run mma.sync m16n8k16 (bf16 in, fp32 out)
// on weight values turned into bf16 in registers (exact: |q| <= 127).
// - kn: a block owns one tile of KN_TN = 128 columns and one split of K.
//   The split count S depends on K alone (K / 1024 up to K = 8192, K / 2048
//   past it, 1 to 8: 4 at K = 4096, 7 at K = 14336, where fewer, longer
//   blocks amortize a block's ramp and epilogue), split s owning the 64-deep
//   groups [G s / S, G (s + 1) / S) of G = K / 64; the S blocks of a tile
//   form a thread-block cluster. A ring slot is one group: the tile's
//   64 x 128 weight bytes (one TMA box of the (K, N) layer view, 128-byte
//   swizzle) and the group's 64 columns of all rows of h (one box, rows
//   past M zero-filled), so no lane reads h from global memory. Four
//   consumer warps own 32 columns each, h is the mma's A (row-major, K
//   contiguous) and the weight its B. B's fragment wants two consecutive k
//   of one column while the tile has columns contiguous: ldmatrix.trans of
//   16 k rows x 16 two-byte units hands a lane rows 2t, 2t + 1 of columns
//   2g, 2g + 1 in one register, whose bytes 0 | 2 and 1 | 3 are the B of two
//   products; the 128-byte swizzle puts the eight rows of each 8 x 8 matrix
//   in distinct banks. int8 -> bf16 takes three integer-and-bf16 operations
//   per two values (i8x2_to_bf16x2), no float conversion. Small rings (54 KB,
//   4-5 groups) so that four blocks share an SM (three at M > 16, by
//   registers): a block's ramp and epilogue hide behind the others'
//   streams. A consumer hands a slot back only after a proxy fence
//   (mbar_release_stage): its ldmatrix reads are generic-proxy, the refill
//   is TMA's async proxy, and without the fence rows of h were seen
//   overwritten before they were read. Epilogue: each block leaves its
//   split's fp32 sums in its own ring; after a cluster barrier rank r
//   finishes its 1/S of the tile, reading every rank's sums through
//   distributed shared memory and adding them in rank order, then the scale
//   and the rounding. No partial goes through HBM and there is no second
//   launch.
// - nt: a persistent grid of one block an SM splits the N / 16 units of 16
//   weight rows evenly; a block walks its units in tiles of up to 8 (128
//   rows), each tile along K in stages of NT_KC = 256. A stage holds the
//   tile's weight (one box of 16 rows x 256 bytes a unit) and the matching
//   256 columns of all rows of h. Eight consumer warps own a unit each, with
//   the weight rows as A and rows of h as B: n = 8 rows of h a product, up to
//   four products per A fragment at M = 32. The 16 k of one product are any
//   16 of the stage as long as A and B agree: a lane loads 16 contiguous
//   bytes of a weight row and 32 contiguous bytes of a row of h, one
//   register each per fragment slot pair, no shuffles.
// Summation order of both, fixed by K alone: each 64-deep group of four
// products starts from a zero accumulator, the groups of a stage (256 rows:
// nt's stage, or four consecutive groups of a kn split from its first) are
// added in order into the stage's sum, the stages in order into the
// split's (nt: the row's) fp32 total, and kn's splits in rank order. So an
// output does not depend on M (the rows that share the launch), on N or on
// its column's place in a tile, and no tensor-core accumulation runs longer
// than 64 terms: the fused wqkv / w13 products, split, equal the separate
// products bit for bit. No atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

// kn
constexpr int KN_TN = 128;                       // columns of a tile (one swizzled 128-byte row)
constexpr int KN_GROUP = 64;                     // K rows of a ring slot
constexpr int KN_WARPS = 4;                      // consumer warps, 32 columns each
constexpr int KN_THREADS = (KN_WARPS + 1) * 32;  // + the producer warp
constexpr int KN_WBYTES = KN_GROUP * KN_TN;      // a slot's weight, 8 KB
constexpr int KN_SMEM = 54 * 1024;               // shared memory a block may take: four an SM
constexpr int KN_SPLIT_ROWS = 1024;              // rows a split: S = K / this, clamped to 1..8,
constexpr int KN_LONG_K = 8192;                  // and twice this many rows past this K
constexpr int KN_MAX_SPLITS = 8;                 // a portable cluster
// nt
constexpr int NT_UNIT = 16;                      // weight rows of a unit (a warp's mma M)
constexpr int NT_WARPS = 8;                      // consumer warps: up to 8 units a tile
constexpr int NT_THREADS = (NT_WARPS + 1) * 32;  // + the producer warp
constexpr int NT_KC = 256;                       // K of a stage
constexpr int NT_WBYTES = NT_WARPS * NT_UNIT * NT_KC;  // a stage's weight, 32 KB
constexpr int NT_SMEM = 220 * 1024;              // shared memory a block may take

// the ring of kn: a slot is the tile's weight of one group and 8 RB rows of h
template <int RB>
struct KnRing {
  static constexpr int HBYTES = 8 * RB * KN_GROUP * 2;
  static constexpr int SLOT = KN_WBYTES + HBYTES;  // a multiple of 1024: boxes stay swizzle-aligned
  static constexpr int SLOTS = (KN_SMEM - 1024 - 256) / SLOT;
  static_assert(SLOTS >= 4, "a ring of at least four groups");
  static constexpr int SMEM = 1024 + SLOTS * SLOT + 2 * SLOTS * 8;
};

// the ring of NT: a stage is the tile's weight and 8 NT rows of h
template <int NT>
struct NtRing {
  static constexpr int HBYTES = 8 * NT * NT_KC * 2;
  static constexpr int STAGE = NT_WBYTES + HBYTES;
  static constexpr int FIT = (NT_SMEM - 1024 - 128) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int SMEM = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

// 4 int8 in a word -> 4 exact floats: bias each byte to unsigned (x + 128),
// place it in the mantissa of 2^23 and subtract 2^23 + 128.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// 4 int8 in a word -> two bf16x2 (exact): lo holds bytes 0, 1 (byte 0 in
// the low half), hi bytes 2, 3
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t w, uint32_t& lo, uint32_t& hi) {
  float f[4];
  i8x4_to_f32(w, f);
  const __nv_bfloat162 l = __floats2bfloat162_rn(f[0], f[1]), h = __floats2bfloat162_rn(f[2], f[3]);
  lo = *reinterpret_cast<const uint32_t*>(&l);
  hi = *reinterpret_cast<const uint32_t*>(&h);
}

// d += A B, m16n8k16: A (16 x 16) and B (16 x 8) bf16 fragments, d fp32
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}


struct KnArgs {
  CUtensorMap tw;  // q (K, N) int8: boxes of KN_TN columns x KN_GROUP rows, 128-byte swizzle
  CUtensorMap th;  // h (M, K) bf16: boxes of KN_GROUP columns x 8 RB rows, 128-byte swizzle
  const float* scale;
  __nv_bfloat16* out;
  int M, K, N;
};

__host__ __device__ inline int kn_splits(int K) {
  const int s = K / (K > KN_LONG_K ? 2 * KN_SPLIT_ROWS : KN_SPLIT_ROWS);
  return s < 1 ? 1 : (s > KN_MAX_SPLITS ? KN_MAX_SPLITS : s);
}

// bytes 0 and 2 of a word, int8 -> bf16x2 (exact): byte b = 128 s + u
// (two's complement) is u - 128 s; bf16 0x4300 | u is 128 + u and
// 0x4300 | 128 s is 128 + 128 s, so one bf16x2 subtraction
__device__ __forceinline__ uint32_t i8x2_to_bf16x2(uint32_t w) {
  const uint32_t m = (w & 0x007F007Fu) | 0x43004300u, c = (w & 0x00800080u) | 0x43004300u;
  const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&m),
                                   *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&d);
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// grid (S, N / KN_TN), clusters of (S, 1, 1): block (s, tile) sums split s
// of the tile's columns; KN_WARPS consumer warps, then the producer warp.
// RB = 8-row blocks of h staged (M <= 8 RB); MT = m16 tiles of the mma.
template <int RB>
__global__ void __launch_bounds__(KN_THREADS, 3) kn_kernel(const __grid_constant__ KnArgs a) {
  using R = KnRing<RB>;
  constexpr int MT = (RB + 1) / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = cr::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // SLOTS x (weight group, h columns)
  const uint32_t bar_s = base + R::SLOTS * R::SLOT;
  uint8_t* ring = smem_raw + (base - raw);
  auto full = [&](int st) { return bar_s + 8 * st; };
  auto empty = [&](int st) { return bar_s + 8 * (R::SLOTS + st); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int S = gridDim.x, rank = cr::cluster_rank();
  const int n0 = blockIdx.y * KN_TN;
  const int G = a.K / KN_GROUP;
  const int g0 = static_cast<int>((long long)G * rank / S);
  const int ng = static_cast<int>((long long)G * (rank + 1) / S) - g0;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < R::SLOTS; ++st) {
      cr::mbar_init(full(st), 1);
      cr::mbar_init(empty(st), KN_WARPS * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == KN_WARPS) {
    // producer: the split's groups in order, each the tile's weight rows and
    // those columns of h
    if (lane == 0) {
      for (int i = 0; i < ng; ++i) {
        const int st = i % R::SLOTS;
        if (i >= R::SLOTS) cr::mbar_wait(empty(st), (i / R::SLOTS - 1) & 1);
        const uint32_t ws = base + st * R::SLOT;
        cr::mbar_arrive_tx(full(st), R::SLOT);
        cr::tma_load_2d(ws, &a.tw, full(st), n0, (g0 + i) * KN_GROUP);
        cr::tma_load_2d(ws + KN_WBYTES, &a.th, full(st), (g0 + i) * KN_GROUP, 0);
      }
    }
    __syncwarp();
  } else {
    // consumer: lane (g, t) of the mma fragments. B by ldmatrix.trans of the
    // warp's 32 columns (16 two-byte units) x 16 rows: matrix i (lanes
    // 8i .. 8i + 7 give its rows) holds rows 8 (i % 2) .. + 7 of the 16-byte
    // chunk 2 warp + i / 2, where row r's chunk c sits at c ^ (r % 8) (the
    // swizzle), so the eight rows of a matrix fall in distinct banks. Lane
    // (g, t) gets rows 2t, 2t + 1 (k) of columns 2g, 2g + 1 of each: bytes
    // 0 | 2 are column 2g, bytes 1 | 3 column 2g + 1, one product's B each.
    const int g = lane / 4, t = lane % 4;
    const int lr = lane % 8 + 8 * ((lane / 8) % 2);  // the row this lane addresses
    const uint32_t boff = lr * KN_TN + (((2 * warp + lane / 16) ^ (lane % 8)) << 4);
    // A by ldmatrix: matrix i holds rows 8 (i % 2) .. + 7 (of an m16 tile),
    // k 8 (i / 2) .. + 7 of the step (two matrices, rows 0 .. 7, for RB = 1)
    const int ar = RB == 1 ? lane % 8 : lr, ak = RB == 1 ? (lane / 8) % 2 : lane / 16;
    float total[MT][4][4], part[MT][4][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) total[m][j][e] = part[m][j][e] = 0.f;

    for (int i = 0; i < ng; ++i) {
      const int st = i % R::SLOTS;
      cr::mbar_wait(full(st), (i / R::SLOTS) & 1);
      const uint32_t ws = base + st * R::SLOT;
      const uint32_t hs = ws + KN_WBYTES;
      float acc[MT][4][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KN_GROUP; kk += 16) {
        uint32_t r[4], b0[4], b1[4];
        ldsm_x4_trans(r, ws + kk * KN_TN + boff);
        // product j: columns 32 warp + 16 (j / 2) + 2g + j % 2
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          b0[2 * h] = i8x2_to_bf16x2(r[2 * h]);
          b1[2 * h] = i8x2_to_bf16x2(r[2 * h + 1]);
          b0[2 * h + 1] = i8x2_to_bf16x2(r[2 * h] >> 8);
          b1[2 * h + 1] = i8x2_to_bf16x2(r[2 * h + 1] >> 8);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t af[4];
          const int row = 16 * m + ar, kc = kk / 8 + ak;
          const uint32_t addr = hs + row * 128 + ((kc ^ (row % 8)) << 4);
          if (RB == 1) {
            ldsm_x2(af[0], af[2], addr);
            af[1] = af[3] = 0u;  // rows 8 .. 15 of an 8-row h
          } else {
            ldsm_x4(af, addr);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_16816(acc[m][j], af, b0[j], b1[j]);
        }
      }
      cr::mbar_release_stage(empty(st));
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[m][j][e] += acc[m][j][e];
      if ((i & 3) == 3 || i == ng - 1) {  // a stage: four groups from the split's first
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              total[m][j][e] += part[m][j][e];
              part[m][j][e] = 0.f;
            }
      }
    }
    // the ring is free once every consumer is past its last slot: the
    // split's sums go to its start, (M, KN_TN) fp32
    asm volatile("bar.sync 1, %0;\n" ::"n"(KN_WARPS * 32) : "memory");
    float* sums = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * m + g + 8 * (e / 2);
          const int col = 32 * warp + 16 * (j / 2) + 2 * (2 * t + e % 2) + j % 2;
          if (row < a.M) sums[row * KN_TN + col] = total[m][j][e];
        }
  }
  cr::cluster_sync();
  // rank r: float4 q of the tile's M x 32, q in [E4 r / S, E4 (r + 1) / S)
  const int e4 = a.M * (KN_TN / 4);
  for (int q = e4 * rank / S + threadIdx.x; q < e4 * (rank + 1) / S; q += KN_THREADS) {
    float4 v = cr::ld_cluster_f4(cr::cluster_map(base + 16 * q, 0));
    for (int r = 1; r < S; ++r) {
      const float4 w = cr::ld_cluster_f4(cr::cluster_map(base + 16 * q, r));
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    const int row = q / (KN_TN / 4), col = n0 + 4 * (q % (KN_TN / 4));
    const float4 sc = *reinterpret_cast<const float4*>(a.scale + col);
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x * sc.x, v.y * sc.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z * sc.z, v.w * sc.w);
    uint2 o;
    o.x = *reinterpret_cast<const uint32_t*>(&lo);
    o.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(a.out + (long long)row * a.N + col) = o;
  }
  cr::cluster_sync();  // no block leaves while another reads its shared memory
}

struct NtArgs {
  CUtensorMap tw;  // w (N, K) int8: boxes of NT_KC columns x NT_UNIT rows
  CUtensorMap th;  // h (M, K) bf16: boxes of NT_KC columns x 8 NT rows
  const float* scale;
  __nv_bfloat16* out;
  int M, K, N;
};

// grid: one block an SM (at most N / 16); block: NT_WARPS consumer warps,
// then the producer warp. NT = ceil(M / 8) products of n = 8 rows of h.
template <int NT>
__global__ void __launch_bounds__(NT_THREADS, 1) nt_kernel(const __grid_constant__ NtArgs a) {
  using R = NtRing<NT>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = cr::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // STAGES x (weight tile, h columns)
  const uint32_t bar_s = base + R::STAGES * R::STAGE;
  const uint8_t* ring = smem_raw + (base - raw);
  auto full = [&](int st) { return bar_s + 8 * st; };
  auto empty = [&](int st) { return bar_s + 8 * (R::STAGES + st); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long units = a.N / NT_UNIT;
  const int u0 = static_cast<int>(units * blockIdx.x / gridDim.x);
  const int u1 = static_cast<int>(units * (blockIdx.x + 1) / gridDim.x);
  const int nk = (a.K + NT_KC - 1) / NT_KC;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < R::STAGES; ++st) {
      cr::mbar_init(full(st), 1);
      cr::mbar_init(empty(st), NT_WARPS * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == NT_WARPS) {
    // producer: for each tile of the block's units and each K stage, the
    // units' weight boxes and the stage's columns of h
    if (lane == 0) {
      int it = 0;
      for (int t0 = u0; t0 < u1; t0 += NT_WARPS) {
        const int nu = min(NT_WARPS, u1 - t0);
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int st = it % R::STAGES;
          if (it >= R::STAGES) cr::mbar_wait(empty(st), (it / R::STAGES - 1) & 1);
          const uint32_t ws = base + st * R::STAGE;
          cr::mbar_arrive_tx(full(st), nu * NT_UNIT * NT_KC + R::HBYTES);
          for (int u = 0; u < nu; ++u)
            cr::tma_load_2d(ws + u * NT_UNIT * NT_KC, &a.tw, full(st), kc * NT_KC,
                            (t0 + u) * NT_UNIT);
          cr::tma_load_2d(ws + NT_WBYTES, &a.th, full(st), kc * NT_KC, 0);
        }
      }
    }
    return;
  }

  // consumer: this lane's weight rows are g and g + 8 of the warp's unit, its
  // outputs rows 8j + 2t, 8j + 2t + 1 of h (the mma fragment layout)
  const int g = lane / 4, t = lane % 4;
  int it = 0;
  for (int t0 = u0; t0 < u1; t0 += NT_WARPS) {
    const bool mine = t0 + warp < u1;
    float total[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) total[j][e] = 0.f;
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int st = it % R::STAGES;
      cr::mbar_wait(full(st), (it / R::STAGES) & 1);
      if (mine) {
        const uint8_t* ws = ring + st * R::STAGE + warp * NT_UNIT * NT_KC;
        const uint8_t* hs = ring + st * R::STAGE + NT_WBYTES;
        float part[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
        for (int c = 0; c < NT_KC / 64; ++c) {
          // k = 64c + 16t + 4s + e of the stage is slot 2t + e (e < 2) or
          // 2t + 6 + e (e >= 2) of product s, in A and B alike
          const int k = 64 * c + 16 * t;
          const uint4 w0 = *reinterpret_cast<const uint4*>(ws + g * NT_KC + k);
          const uint4 w1 = *reinterpret_cast<const uint4*>(ws + (g + 8) * NT_KC + k);
          const uint32_t r0[4] = {w0.x, w0.y, w0.z, w0.w}, r1[4] = {w1.x, w1.y, w1.z, w1.w};
          uint32_t af[4][4];
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            i8x4_to_bf16x2(r0[s], af[s][0], af[s][2]);
            i8x4_to_bf16x2(r1[s], af[s][1], af[s][3]);
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint4* hp = reinterpret_cast<const uint4*>(hs + ((8 * j + g) * NT_KC + k) * 2);
            const uint4 h0 = hp[0], h1 = hp[1];
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            mma_16816(acc, af[0], h0.x, h0.y);
            mma_16816(acc, af[1], h0.z, h0.w);
            mma_16816(acc, af[2], h1.x, h1.y);
            mma_16816(acc, af[3], h1.z, h1.w);
#pragma unroll
            for (int e = 0; e < 4; ++e) part[j][e] += acc[e];
          }
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) total[j][e] += part[j][e];
      }
      cr::mbar_release_stage(empty(st));
    }
    if (mine) {
      // total[j][e]: weight row g (e < 2) or g + 8, row 8j + 2t + e % 2 of h
      const int n = (t0 + warp) * NT_UNIT + g;
      const float s0 = a.scale[n], s1 = a.scale[n + 8];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * j + 2 * t + e;
          if (m < a.M) {
            a.out[(long long)m * a.N + n] = __float2bfloat16_rn(total[j][e] * s0);
            a.out[(long long)m * a.N + n + 8] = __float2bfloat16_rn(total[j][2 + e] * s1);
          }
        }
    }
  }
}

// a 2-D TMA map of `rows` rows of `inner` elements, `row_bytes` apart, in
// boxes of box_inner x box_rows; out-of-bounds boxes fill zeros
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* p, long long inner,
               long long rows, long long row_bytes, int box_inner, int box_rows,
               CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_NONE) {
  const cr::EncodeTiled encode = cr::tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int RB>
int kn_launch(const void* h, const void* q, const void* scale, void* out, int M, int K, int N,
              cudaStream_t stream) {
  KnArgs a{};
  if (!encode_2d(&a.tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, K, N, KN_TN, KN_GROUP,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&a.th, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, h, K, M, 2LL * K, KN_GROUP, 8 * RB,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = M;
  a.K = K;
  a.N = N;
  cudaError_t e = cudaFuncSetAttribute(kn_kernel<RB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       KnRing<RB>::SMEM);
  if (e == cudaSuccess)  // all of L1 as shared memory, so four blocks fit an SM
    e = cudaFuncSetAttribute(kn_kernel<RB>, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  const int S = kn_splits(K);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, N / KN_TN, 1);
  cfg.blockDim = dim3(KN_THREADS, 1, 1);
  cfg.dynamicSmemBytes = KnRing<RB>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kn_kernel<RB>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <int NT>
int nt_launch(const void* h, const void* w, const void* scale, void* out, int M, int K, int N,
              cudaStream_t stream) {
  static int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  NtArgs a{};
  if (!encode_2d(&a.tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, K, NT_KC, NT_UNIT) ||
      !encode_2d(&a.th, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, h, K, M, 2LL * K, NT_KC, 8 * NT))
    return (int)cudaErrorInvalidValue;
  a.scale = static_cast<const float*>(scale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.M = M;
  a.K = K;
  a.N = N;
  cudaError_t e = cudaFuncSetAttribute(nt_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       NtRing<NT>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int cap = sms > 0 ? sms : 132;
  const int grid = N / NT_UNIT < cap ? N / NT_UNIT : cap;
  nt_kernel<NT><<<grid, NT_THREADS, NtRing<NT>::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

bool shape_ok(const void* h, const void* q, int M, int K, int N) {
  return M >= 1 && M <= 32 && K > 0 && N > 0 && K % 128 == 0 && N % 128 == 0 &&
         (reinterpret_cast<uintptr_t>(h) % 16) == 0 && (reinterpret_cast<uintptr_t>(q) % 16) == 0;
}

}  // namespace

extern "C" int int8_matmul_kn_splits(int K) { return kn_splits(K); }

// h (M, K) bf16; q (K, N) int8 at the layer's base; scale (N,) fp32 (16-byte
// aligned); out (M, N) bf16.
extern "C" int int8_matmul_kn_launch(const void* h, const void* q, const void* scale, void* out,
                                     int M, int K, int N, void* stream) {
  if (!shape_ok(h, q, M, K, N) || (reinterpret_cast<uintptr_t>(scale) % 16) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 8) return kn_launch<1>(h, q, scale, out, M, K, N, s);
  if (M <= 16) return kn_launch<2>(h, q, scale, out, M, K, N, s);
  return kn_launch<4>(h, q, scale, out, M, K, N, s);
}

// h (M, K) bf16; w (N, K) int8; scale (N,) fp32; out (M, N) bf16.
extern "C" int int8_matmul_nt_launch(const void* h, const void* w, const void* scale, void* out,
                                     int M, int K, int N, void* stream) {
  if (!shape_ok(h, w, M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((M + 7) / 8) {
    case 1: return nt_launch<1>(h, w, scale, out, M, K, N, s);
    case 2: return nt_launch<2>(h, w, scale, out, M, K, N, s);
    case 3: return nt_launch<3>(h, w, scale, out, M, K, N, s);
    default: return nt_launch<4>(h, w, scale, out, M, K, N, s);
  }
}
