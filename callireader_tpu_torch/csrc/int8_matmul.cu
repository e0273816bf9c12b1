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
// Bound on the H100: the int8 weight bytes (K*N), about 2*M flops per byte.
// - kn: a block owns BN = 256 columns x KC = 256 rows of K. 16 threads cover
//   the 256 columns in 16-byte loads (neighbouring threads, neighbouring
//   columns); the block's 256 threads are 16 K-slices of 16 rows each. Blocks
//   over (column tile, K chunk) keep even N = 4096 at 16 x 16 = 256 blocks for
//   the 132 SMs. Each block stages its K chunk of h in shared memory, sums its
//   slices in a fixed order and writes an fp32 partial; a second pass adds the
//   chunks in order, scales and rounds. Rows are processed MT = 4 at a time
//   (blockIdx over row groups re-reads the weight for M > 4).
// - nt: one pass over the weight for every M <= 32, on the tensor cores. A
//   persistent grid of one block an SM splits the N / 16 units of 16 weight
//   rows evenly; a block walks its units in tiles of up to 8 (128 rows),
//   each tile along K in stages of NT_KC = 256. A producer warp fills a ring
//   of stages (about 200 KB, so 150-190 KB of weight in flight an SM) by TMA:
//   a stage holds the tile's weight (one box of 16 rows x 256 bytes a unit)
//   and the matching 256 columns of all rows of h (one box, rows past M
//   zero-filled), so no lane reads h from global memory. Eight consumer
//   warps own a unit each and run mma.sync m16n8k16 (bf16 in, fp32 out) with
//   the weight rows, turned into bf16 in registers (exact: |q| <= 127), as A
//   and rows of h as B: n = 8 rows of h a product, up to four products per
//   A fragment at M = 32. The product is bound by bytes (2M <= 64 flops a
//   weight byte against the card's ~295), so mma.sync is enough. The 16 k of
//   one product are any 16 of the stage as long as A and B agree: a lane
//   loads 16 contiguous bytes of a weight row and 32 contiguous bytes of a
//   row of h, one register each per fragment slot pair, no shuffles.
//   Summation order, fixed by K alone: each 64-deep group of four products
//   starts from a zero accumulator, the four groups of a stage are added in
//   order into the stage's sum, the stages in order into the row's fp32
//   total; so a row's output does not depend on M (the rows that share the
//   launch) or on its place in a tile, and no tensor-core accumulation runs
//   longer than 64 terms.
// Each output's summation order depends on K alone (never on N, the column's
// place in a tile, or M), so the fused wqkv / w13 products, split, equal the
// separate products bit for bit. No atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

constexpr int MT = 4;          // rows of h per pass
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// kn
constexpr int CPT = 16;               // columns per thread (one 16-byte load)
constexpr int TPR = 16;               // threads across a column tile
constexpr int BN = TPR * CPT;         // 256 columns per block
constexpr int KSL = THREADS / TPR;    // 16 K-slices per block
constexpr int KC = 256;               // K rows per block
constexpr int KSR = KC / KSL;         // 16 rows per slice
// nt
constexpr int NT_UNIT = 16;                      // weight rows of a unit (a warp's mma M)
constexpr int NT_WARPS = 8;                      // consumer warps: up to 8 units a tile
constexpr int NT_THREADS = (NT_WARPS + 1) * 32;  // + the producer warp
constexpr int NT_KC = 256;                       // K of a stage
constexpr int NT_WBYTES = NT_WARPS * NT_UNIT * NT_KC;  // a stage's weight, 32 KB
constexpr int NT_SMEM = 220 * 1024;              // shared memory a block may take

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

__device__ __forceinline__ void i8x16_to_f32(const uint4& w, float* f) {
  i8x4_to_f32(w.x, f);
  i8x4_to_f32(w.y, f + 4);
  i8x4_to_f32(w.z, f + 8);
  i8x4_to_f32(w.w, f + 12);
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

// grid (ceil(N / BN), ceil(K / KC), ceil(M / MT)), block THREADS.
// part (NKC, M, N) fp32: the sum over chunk blockIdx.y.
__global__ void __launch_bounds__(THREADS) kn_partial(const __nv_bfloat16* __restrict__ h,
                                                      const int8_t* __restrict__ q,
                                                      float* __restrict__ part, int M, int K,
                                                      int N) {
  const int n0 = blockIdx.x * BN, kc = blockIdx.y, m0 = blockIdx.z * MT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tcol = tid % TPR, slice = tid / TPR;
  __shared__ float4 hs[KC];
  __shared__ float4 red[WARPS][MT][BN / 4];

  for (int k = tid; k < KC; k += THREADS) {
    const int kk = kc * KC + k;
    float v[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      v[m] = (m0 + m < M && kk < K) ? __bfloat162float(h[(long long)(m0 + m) * K + kk]) : 0.f;
    hs[k] = make_float4(v[0], v[1], v[2], v[3]);
  }
  __syncthreads();

  float acc[MT][CPT];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] = 0.f;

  const int n = n0 + tcol * CPT;
  const int kb = kc * KC + slice * KSR;
  if (n < N && kb < K) {
    const int8_t* wp = q + (long long)kb * N + n;
#pragma unroll 4
    for (int j = 0; j < KSR; ++j) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(wp + (long long)j * N));
      const float4 hv = hs[slice * KSR + j];
      float f[CPT];
      i8x16_to_f32(w, f);
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        acc[0][c] = fmaf(hv.x, f[c], acc[0][c]);
        acc[1][c] = fmaf(hv.y, f[c], acc[1][c]);
        acc[2][c] = fmaf(hv.z, f[c], acc[2][c]);
        acc[3][c] = fmaf(hv.w, f[c], acc[3][c]);
      }
    }
  }
  // slice 2*warp (lanes 0-15) + slice 2*warp+1 (lanes 16-31), same columns
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[m][c] += __shfl_down_sync(0xffffffffu, acc[m][c], 16);
  if (lane < 16) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c4 = 0; c4 < CPT / 4; ++c4)
        red[warp][m][tcol * (CPT / 4) + c4] =
            make_float4(acc[m][4 * c4], acc[m][4 * c4 + 1], acc[m][4 * c4 + 2], acc[m][4 * c4 + 3]);
  }
  __syncthreads();

  const float* redf = reinterpret_cast<const float*>(red);
  for (int i = tid; i < MT * BN; i += THREADS) {
    const int m = i / BN, col = i % BN;
    if (m0 + m < M && n0 + col < N) {
      float s = redf[m * BN + col];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += redf[(w * MT + m) * BN + col];
      part[((long long)kc * M + m0 + m) * N + n0 + col] = s;
    }
  }
}

// grid ceil(M * N / THREADS), block THREADS: chunks in order, scale, round.
__global__ void kn_combine(const float* __restrict__ part, const float* __restrict__ scale,
                           __nv_bfloat16* __restrict__ out, int M, int N, int NKC) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long MN = (long long)M * N;
  if (i >= MN) return;
  float s = part[i];
  for (int c = 1; c < NKC; ++c) s += part[c * MN + i];
  out[i] = __float2bfloat16_rn(s * scale[i % N]);
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
      cr::mbar_arrive(empty(st));
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
// boxes of box_inner x box_rows, unswizzled; out-of-bounds boxes fill zeros
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, const void* p, long long inner,
               long long rows, long long row_bytes, int box_inner, int box_rows) {
  const cr::EncodeTiled encode = cr::tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

// h (M, K) bf16; q (K, N) int8 at the layer's base; scale (N,) fp32;
// part (ceil(K / KC), M, N) fp32 scratch; out (M, N) bf16.
extern "C" int int8_matmul_kn_launch(const void* h, const void* q, const void* scale, void* part,
                                     void* out, int M, int K, int N, void* stream) {
  if (!shape_ok(h, q, M, K, N)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nkc = (K + KC - 1) / KC;
  dim3 grid((N + BN - 1) / BN, nkc, (M + MT - 1) / MT);
  kn_partial<<<grid, THREADS, 0, s>>>(static_cast<const __nv_bfloat16*>(h),
                                      static_cast<const int8_t*>(q), static_cast<float*>(part),
                                      M, K, N);
  const long long mn = (long long)M * N;
  kn_combine<<<(unsigned)((mn + THREADS - 1) / THREADS), THREADS, 0, s>>>(
      static_cast<const float*>(part), static_cast<const float*>(scale),
      static_cast<__nv_bfloat16*>(out), M, N, nkc);
  return (int)cudaGetLastError();
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
