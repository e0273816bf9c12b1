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
//   chunks in order, scales and rounds.
// - nt: a warp walks 8 weight rows along K in 16-byte loads, with the same 16
//   values of h per lane held in registers for all 8 rows; lanes are reduced
//   with a butterfly of shuffles. 64 rows a block, no second pass.
// Each output's summation order depends on K alone (never on N, the column's
// place in a tile, or M), so the fused wqkv / w13 products, split, equal the
// separate products bit for bit. No atomics.
// Rows are processed MT = 4 at a time (blockIdx over row groups re-reads the
// weight for M > 4; the decode path has M = batch = 4).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int NT_R = 8;               // weight rows per warp
constexpr int NT_ROWS = WARPS * NT_R; // 64 rows per block
constexpr int NT_STEP = 32 * 16;      // K elements per warp step

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

// 8 bf16 in 16 bytes -> 8 floats (exact)
__device__ __forceinline__ void bf16x8_to_f32(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
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

// grid (ceil(N / NT_ROWS), ceil(M / MT)), block THREADS.
__global__ void __launch_bounds__(THREADS) nt_kernel(const __nv_bfloat16* __restrict__ h,
                                                     const int8_t* __restrict__ w,
                                                     const float* __restrict__ scale,
                                                     __nv_bfloat16* __restrict__ out, int M, int K,
                                                     int N) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nb = blockIdx.x * NT_ROWS + warp * NT_R;
  const int m0 = blockIdx.y * MT;
  float acc[NT_R][MT];
#pragma unroll
  for (int r = 0; r < NT_R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m) acc[r][m] = 0.f;

  for (int k = lane * 16; k < K; k += NT_STEP) {
    float hv[MT][16];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if (m0 + m < M) {
        const uint4* hp = reinterpret_cast<const uint4*>(h + (long long)(m0 + m) * K + k);
        bf16x8_to_f32(__ldg(hp), hv[m]);
        bf16x8_to_f32(__ldg(hp + 1), hv[m] + 8);
      } else {
#pragma unroll
        for (int c = 0; c < 16; ++c) hv[m][c] = 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < NT_R; ++r) {
      if (nb + r < N) {
        const uint4 wv = __ldg(reinterpret_cast<const uint4*>(w + (long long)(nb + r) * K + k));
        float f[16];
        i8x16_to_f32(wv, f);
#pragma unroll
        for (int c = 0; c < 16; ++c)
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[r][m] = fmaf(hv[m][c], f[c], acc[r][m]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < NT_R; ++r)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][m] += __shfl_xor_sync(0xffffffffu, acc[r][m], off);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < NT_R; ++r) {
      const int n = nb + r;
      if (n >= N) continue;
      const float s = scale[n];
#pragma unroll
      for (int m = 0; m < MT; ++m)
        if (m0 + m < M) out[(long long)(m0 + m) * N + n] = __float2bfloat16_rn(acc[r][m] * s);
    }
  }
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
  dim3 grid((N + NT_ROWS - 1) / NT_ROWS, (M + MT - 1) / MT);
  nt_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(h), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(out), M, K, N);
  return (int)cudaGetLastError();
}
