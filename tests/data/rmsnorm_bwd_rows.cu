// Test fixture: the RMSNorm kernels as they were before the backward held its
// rows in registers and finished dw in its own launch. This backward walks
// groups of rpb rows a block, reads each row twice (once for the sum of g * x,
// again for dx), accumulates dw in shared memory and writes (blocks, E) fp32
// partials that the caller sums. tests/test_torch_rmsnorm.py builds this file
// on the card and requires csrc/rmsnorm.cu's backward to give the same dx
// bits; chip_smoke.py times it, plus the sum of its partials, beside the
// backward that replaced it. Its entry points keep their old arguments:
// (x, w, r, dy, dx, dw_part, rows, E, rpb, dtype, stream).
//
// RMSNorm forward and backward over rows of width E, statistics in fp32.
//
// Replaces callireader_tpu/kernels/rmsnorm.py (rms_norm_pallas: the forward
// pallas_call at :68 and the backward at :100). For x (rows, E) and w (E,):
//   forward:  r = 1 / sqrt(mean(x^2) + eps),  y = x * r * w
//   backward: g = w * dy,  dx = r * g - x * r^3 * sum_j(g_j x_j) / E,
//             dw = sum_rows dy * x * r   (per-block partials, summed outside)
// Two output roundings, a template parameter:
//   - fused (MODEL = false): y = T(x * r * w) rounded once: rms_norm_pallas.
//   - model (MODEL = true): y = T(T(x * r) * w), the model's plain
//     internlm2.rms_norm, which rounds x * r to the activation type T before
//     the product with the weight (a product of two bf16 values is exact in
//     fp32, so rounding it once is the framework's bf16 multiply). Its
//     backward rounds g = w * dy to T before the fp32 reduction and its dw
//     sums dy * T(x * r): what autodiff of that function computes.
// The TPU kernel stored r broadcast to (rows, 128) lanes; here r is (rows,).
//
// Bound on the H100: bytes (x, dy read once, y or dx written once; a few
// flops per byte). Forward: one block per row; each thread loads its 16-byte
// vectors of the row (every blockDim-th one: 2 at E = 4096 bf16, at most 8)
// and the weight's once into registers, then a warp-shuffle + shared-memory
// sum of squares, then y from the registers: one global read of x. Backward: one block per group of rows; per row a reduction of g * x,
// then dx; dw, when asked, accumulates in shared memory, each thread owning
// the same columns for every row of the block, and is written as an
// (n_blocks, E) fp32 partial: no atomics, the same bits on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_WIDTH = 8192;  // the widest row: the forward holds it in registers

template <typename T>
struct Vec;

// 8 bf16 in 16 bytes
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    unpack(*reinterpret_cast<const uint4*>(p), f);
  }
  __device__ static void unpack(const uint4 v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* f) {
    uint4 v;
    uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(p) = v;
  }
  __device__ static float round(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
};

// 4 fp32 in 16 bytes
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* f) {
    unpack(*reinterpret_cast<const uint4*>(p), f);
  }
  __device__ static void unpack(const uint4 v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
  __device__ static float round(float x) { return x; }
};

// Sum over the block in a fixed order (butterfly in each warp, then the
// warps' sums in order); every thread gets the same bits.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
  const int nw = blockDim.x >> 5;
  for (int i = 1; i < nw; ++i) s += red[i];
  __syncthreads();
  return s;
}

// grid rows, block threads_for(E); r_out may be null. A thread holds its NV
// vectors of x and of w in registers as loaded (16 bytes each, unconverted,
// so the registers a block needs stay few and an SM keeps many rows in
// flight). Its vector j starts at element (threadIdx.x + j * blockDim.x) *
// V::N, as a loop striding over the row would visit them, so the sum of
// squares adds in that order.
template <typename T, bool MODEL, int NV>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_fwd(const T* __restrict__ x,
                                                           const T* __restrict__ w,
                                                           T* __restrict__ y,
                                                           float* __restrict__ r_out, int E,
                                                           float eps) {
  using V = Vec<T>;
  __shared__ float red[MAX_THREADS / 32];
  const long long base = (long long)blockIdx.x * E;
  const int step = blockDim.x * V::N;
  uint4 xv[NV], wv[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = threadIdx.x * V::N + j * step;
    if (i < E) {
      xv[j] = *reinterpret_cast<const uint4*>(x + base + i);
      wv[j] = *reinterpret_cast<const uint4*>(w + i);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (threadIdx.x * V::N + j * step < E) {
      float f[V::N];
      V::unpack(xv[j], f);
#pragma unroll
      for (int k = 0; k < V::N; ++k) ss = fmaf(f[k], f[k], ss);
    }
  }
  ss = block_sum(ss, red);
  const float r = 1.0f / sqrtf(ss / (float)E + eps);
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = threadIdx.x * V::N + j * step;
    if (i < E) {
      float f[V::N], g[V::N], out[V::N];
      V::unpack(xv[j], f);
      V::unpack(wv[j], g);
#pragma unroll
      for (int k = 0; k < V::N; ++k)
        out[k] = MODEL ? V::round(f[k] * r) * g[k] : f[k] * r * g[k];
      V::store(y + base + i, out);
    }
  }
  if (r_out != nullptr && threadIdx.x == 0) r_out[blockIdx.x] = r;
}

// grid ceil(rows / rpb), block threads_for(E), dynamic shared E floats when
// dw_part is given. dw_part (gridDim.x, E) fp32 may be null.
template <typename T, bool MODEL>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_bwd(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ r,
    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ dw_part, int rows, int E,
    int rpb) {
  using V = Vec<T>;
  __shared__ float red[MAX_THREADS / 32];
  extern __shared__ float dw_acc[];
  const int step = blockDim.x * V::N;
  const bool want_dw = dw_part != nullptr;
  if (want_dw)
    for (int i = threadIdx.x * V::N; i < E; i += step)
#pragma unroll
      for (int k = 0; k < V::N; ++k) dw_acc[i + k] = 0.f;
  const int row0 = blockIdx.x * rpb;
  const int row1 = min(row0 + rpb, rows);
  for (int row = row0; row < row1; ++row) {
    const long long base = (long long)row * E;
    const float rr = r[row];
    float inner = 0.f;
    for (int i = threadIdx.x * V::N; i < E; i += step) {
      float xf[V::N], wf[V::N], df[V::N];
      V::load(x + base + i, xf);
      V::load(w + i, wf);
      V::load(dy + base + i, df);
#pragma unroll
      for (int k = 0; k < V::N; ++k) {
        const float g = MODEL ? V::round(wf[k] * df[k]) : wf[k] * df[k];
        inner = fmaf(g, xf[k], inner);
      }
    }
    inner = block_sum(inner, red);
    const float r3 = rr * rr * rr;
    for (int i = threadIdx.x * V::N; i < E; i += step) {
      float xf[V::N], wf[V::N], df[V::N], out[V::N];
      V::load(x + base + i, xf);
      V::load(w + i, wf);
      V::load(dy + base + i, df);
#pragma unroll
      for (int k = 0; k < V::N; ++k) {
        const float g = MODEL ? V::round(wf[k] * df[k]) : wf[k] * df[k];
        out[k] = rr * g - xf[k] * r3 * inner / (float)E;
        if (want_dw) dw_acc[i + k] += MODEL ? df[k] * V::round(xf[k] * rr) : df[k] * xf[k] * rr;
      }
      V::store(dx + base + i, out);
    }
  }
  if (want_dw)
    for (int i = threadIdx.x * V::N; i < E; i += step)
#pragma unroll
      for (int k = 0; k < V::N; ++k) dw_part[(long long)blockIdx.x * E + i + k] = dw_acc[i + k];
}

template <typename T>
int threads_for(int E) {
  const int vecs = E / Vec<T>::N;
  const int t = ((vecs + 31) / 32) * 32;
  return t < MAX_THREADS ? t : MAX_THREADS;
}

bool shape_ok(const void* x, const void* w, int rows, int E) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) % 16 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
  return aligned && rows > 0 && E > 0 && E <= MAX_WIDTH && E % 8 == 0;
}

// the forward built for the fewest vectors a thread that cover the row: NV =
// 1, 2, 4 (bf16) or 8 (fp32) up to MAX_WIDTH
template <typename T, bool MODEL, int NV>
void launch_fwd(int nv, const void* x, const void* w, void* y, void* r, int rows, int E,
                float eps, cudaStream_t stream) {
  if constexpr (NV < MAX_WIDTH / (MAX_THREADS * Vec<T>::N)) {
    if (nv > NV) return launch_fwd<T, MODEL, 2 * NV>(nv, x, w, y, r, rows, E, eps, stream);
  }
  rmsnorm_fwd<T, MODEL, NV><<<rows, threads_for<T>(E), 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      static_cast<float*>(r), E, eps);
}

template <typename T, bool MODEL>
int fwd(const void* x, const void* w, void* y, void* r, int rows, int E, float eps, void* stream) {
  if (!shape_ok(x, w, rows, E)) return (int)cudaErrorInvalidValue;
  const int per_pass = threads_for<T>(E) * Vec<T>::N;
  launch_fwd<T, MODEL, 1>((E + per_pass - 1) / per_pass, x, w, y, r, rows, E, eps,
                          static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

template <typename T, bool MODEL>
int bwd(const void* x, const void* w, const void* r, const void* dy, void* dx, void* dw_part,
        int rows, int E, int rpb, void* stream) {
  if (!shape_ok(x, w, rows, E) || rpb < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (rows + rpb - 1) / rpb;
  const size_t smem = dw_part != nullptr ? (size_t)E * sizeof(float) : 0;
  rmsnorm_bwd<T, MODEL><<<blocks, threads_for<T>(E), smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(r),
      static_cast<const T*>(dy), static_cast<T*>(dx), static_cast<float*>(dw_part), rows, E, rpb);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (rows, E) and w (E,) of one type: dtype 0 = bf16, 1 = fp32; r (rows,)
// fp32 or null.
#define RMSNORM_FWD(NAME, MODEL)                                                              \
  extern "C" int NAME(const void* x, const void* w, void* y, void* r, int rows, int E, float eps, \
                      int dtype, void* stream) {                                             \
    if (dtype == 0) return fwd<__nv_bfloat16, MODEL>(x, w, y, r, rows, E, eps, stream);      \
    if (dtype == 1) return fwd<float, MODEL>(x, w, y, r, rows, E, eps, stream);              \
    return (int)cudaErrorInvalidValue;                                                        \
  }

// x, dy, dx (rows, E), w (E,) of one type; r (rows,) fp32; dw_part
// (ceil(rows / rpb), E) fp32 or null.
#define RMSNORM_BWD(NAME, MODEL)                                                                 \
  extern "C" int NAME(const void* x, const void* w, const void* r, const void* dy, void* dx,     \
                      void* dw_part, int rows, int E, int rpb, int dtype, void* stream) {        \
    if (dtype == 0)                                                                              \
      return bwd<__nv_bfloat16, MODEL>(x, w, r, dy, dx, dw_part, rows, E, rpb, stream);          \
    if (dtype == 1) return bwd<float, MODEL>(x, w, r, dy, dx, dw_part, rows, E, rpb, stream);   \
    return (int)cudaErrorInvalidValue;                                                           \
  }

RMSNORM_FWD(rmsnorm_fwd_model_launch, true)
RMSNORM_FWD(rmsnorm_fwd_fused_launch, false)
RMSNORM_BWD(rmsnorm_bwd_model_launch, true)
RMSNORM_BWD(rmsnorm_bwd_fused_launch, false)
