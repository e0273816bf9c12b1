// RMSNorm forward and backward over rows of width E, statistics in fp32.
//
// Replaces callireader_tpu/kernels/rmsnorm.py (rms_norm_pallas: the forward
// pallas_call at :68 and the backward at :100). For x (rows, E) and w (E,):
//   forward:  r = 1 / sqrt(mean(x^2) + eps),  y = x * r * w
//   backward: g = w * dy,  dx = r * g - x * r^3 * sum_j(g_j x_j) / E,
//             dw = sum_rows dy * x * r   (finished inside the same launch)
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
// flops per byte). Both kernels give each thread its 16-byte vectors of a row
// (every blockDim-th one: 2 at E = 4096 bf16, at most 8) and hold them in
// registers, so x and dy are read from device memory once.
// Forward: one block per row; the weight's vectors are loaded beside x, then
// a warp-shuffle + shared-memory sum of squares, then y from the registers.
// Backward: a persistent grid of a few blocks an SM, each walking the rows
// blockIdx.x, blockIdx.x + gridDim.x, ...; the weight stays in registers for
// every row, and the next row's x, dy and r are loaded before this row's sum
// of g * x is reduced, so a row is always in flight while the block waits on
// its barrier. Each thread owns the same columns on every row, so dw
// accumulates in registers; with dw asked for, each block writes its fp32
// partial, the grid meets at one barrier (a cooperative launch: every block
// resident), and each block sums a slice of the columns over the partials in
// a fixed order: dw leaves the launch finished, with the same bits on every
// run (no atomics on the values). dx keeps each thread's elements and the
// order of the block's sum of the row-group kernel it replaced
// (tests/data/rmsnorm_bwd_rows.cu): the same bits in fp32; in bf16 a few
// elements in millions come out one bf16 ulp apart from it.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MAX_WIDTH = 8192;  // the widest row: the forward holds it in registers
constexpr int BWD_AHEAD = 1;  // rows a backward block has loading while it computes one

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

// dw's columns [blockIdx.x * per, ...) as float4s, summed over the P = gridDim.x
// partials (P, E) in a fixed order: ``splits`` runs of consecutive partials,
// each summed in order by one thread, then the runs' sums in order.
__device__ void finish_dw(const float* __restrict__ part, float* __restrict__ dw, int E) {
  __shared__ float4 runs[MAX_THREADS];
  const int P = gridDim.x, E4 = E / 4;
  const int per = (E4 + P - 1) / P;
  const int c0 = blockIdx.x * per;
  const int width = min(per, E4 - c0);
  if (width <= 0) return;
  const float4* p4 = reinterpret_cast<const float4*>(part);
  float4* d4 = reinterpret_cast<float4*>(dw);
  auto add = [](float4& a, const float4 b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  };
  if (width > (int)blockDim.x) {  // few blocks: a thread a column, every partial in order
    for (int c = c0 + threadIdx.x; c < c0 + width; c += blockDim.x) {
      float4 s = __ldcg(p4 + c);
      for (int p = 1; p < P; ++p) add(s, __ldcg(p4 + (long long)p * E4 + c));
      d4[c] = s;
    }
    return;
  }
  const int splits = min((int)blockDim.x / width, P);
  const int t = threadIdx.x;
  if (t < splits * width) {
    const int s = t / width, c = c0 + t % width;
    const int p0 = s * P / splits, p1 = (s + 1) * P / splits;
    float4 a = __ldcg(p4 + (long long)p0 * E4 + c);
    for (int p = p0 + 1; p < p1; ++p) add(a, __ldcg(p4 + (long long)p * E4 + c));
    runs[t] = a;
  }
  __syncthreads();
  if (t < width) {
    float4 a = runs[t];
    for (int s = 1; s < splits; ++s) add(a, runs[s * width + t]);
    d4[c0 + t] = a;
  }
}

// grid <= rows blocks (co-resident when DW: a cooperative launch), block
// threads_for(E). Thread vector j of a row starts at element (threadIdx.x +
// j * blockDim.x) * V::N, as the row-group kernel's loop visited them, so the
// sum of g * x adds in its order. DW: part (gridDim.x, E) fp32 scratch, dw
// (E,) fp32.
template <typename T, bool MODEL, int NV, bool DW>
__global__ void __launch_bounds__(MAX_THREADS, NV >= 8 ? 1 : 2) rmsnorm_bwd(
    const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ r,
    const T* __restrict__ dy, T* __restrict__ dx, float* __restrict__ part,
    float* __restrict__ dw, int rows, int E) {
  using V = Vec<T>;
  __shared__ float red[MAX_THREADS / 32];
  const int step = blockDim.x * V::N;
  // slot 0 holds the row being computed, slots 1..BWD_AHEAD the rows loading
  uint4 wv[NV], xs[BWD_AHEAD + 1][NV], ds[BWD_AHEAD + 1][NV];
  float rs[BWD_AHEAD + 1];
  float acc[NV][V::N];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int i = threadIdx.x * V::N + j * step;
    if (i < E) wv[j] = *reinterpret_cast<const uint4*>(w + i);
#pragma unroll
    for (int k = 0; k < V::N; ++k) acc[j][k] = 0.f;
  }
  auto load_row = [&](int row, uint4* xv, uint4* dv, float& rv) {
    if (row >= rows) return;
    rv = r[row];
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = threadIdx.x * V::N + j * step;
      if (i < E) {
        xv[j] = *reinterpret_cast<const uint4*>(x + (long long)row * E + i);
        dv[j] = *reinterpret_cast<const uint4*>(dy + (long long)row * E + i);
      }
    }
  };
#pragma unroll
  for (int a = 0; a < BWD_AHEAD; ++a) load_row(blockIdx.x + a * gridDim.x, xs[a], ds[a], rs[a]);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    // the loads of the row BWD_AHEAD strides on go out before this row's barrier
    load_row(row + BWD_AHEAD * gridDim.x, xs[BWD_AHEAD], ds[BWD_AHEAD], rs[BWD_AHEAD]);
    const float rr = rs[0];
    float inner = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (threadIdx.x * V::N + j * step < E) {
        float xf[V::N], wf[V::N], df[V::N];
        V::unpack(xs[0][j], xf);
        V::unpack(wv[j], wf);
        V::unpack(ds[0][j], df);
#pragma unroll
        for (int k = 0; k < V::N; ++k) {
          const float g = MODEL ? V::round(wf[k] * df[k]) : wf[k] * df[k];
          inner = fmaf(g, xf[k], inner);
        }
      }
    }
    inner = block_sum(inner, red);
    const float r3 = rr * rr * rr;
    const long long base = (long long)row * E;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = threadIdx.x * V::N + j * step;
      if (i < E) {
        float xf[V::N], wf[V::N], df[V::N], out[V::N];
        V::unpack(xs[0][j], xf);
        V::unpack(wv[j], wf);
        V::unpack(ds[0][j], df);
#pragma unroll
        for (int k = 0; k < V::N; ++k) {
          const float g = MODEL ? V::round(wf[k] * df[k]) : wf[k] * df[k];
          out[k] = rr * g - xf[k] * r3 * inner / (float)E;
          if (DW) acc[j][k] += MODEL ? df[k] * V::round(xf[k] * rr) : df[k] * xf[k] * rr;
        }
        V::store(dx + base + i, out);
      }
    }
#pragma unroll
    for (int a = 0; a < BWD_AHEAD; ++a) {
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        xs[a][j] = xs[a + 1][j];
        ds[a][j] = ds[a + 1][j];
      }
      rs[a] = rs[a + 1];
    }
  }
  if constexpr (DW) {
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int i = threadIdx.x * V::N + j * step;
      if (i < E)
#pragma unroll
        for (int k = 0; k < V::N; k += 4)
          *reinterpret_cast<float4*>(part + (long long)blockIdx.x * E + i + k) =
              make_float4(acc[j][k], acc[j][k + 1], acc[j][k + 2], acc[j][k + 3]);
    }
    __threadfence();
    cooperative_groups::this_grid().sync();
    finish_dw(part, dw, E);
  }
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

// blocks of ``kernel`` at ``threads`` the current device holds at once, kept
// in the kernel's own ``cache`` word (the device and the block size beside the
// count, so concurrent callers read a whole entry or none)
cudaError_t resident_blocks(const void* kernel, int threads,
                            std::atomic<unsigned long long>& slot, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long key = ((unsigned long long)(dev + 1) << 16 | (unsigned)threads) << 32;
  const unsigned long long seen = slot.load(std::memory_order_relaxed);
  if ((seen & ~0xffffffffull) == key) {
    *out = (int)(seen & 0xffffffffull);
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  *out = per_sm * sms;
  slot.store(key | (unsigned)*out, std::memory_order_relaxed);
  return cudaSuccess;
}

// the backward built for the fewest vectors a thread that cover the row, as
// the forward. Without dw: a plain launch of ``blocks``. With dw: a
// cooperative launch (every block resident, so the grid can meet at its
// barrier) of at most as many blocks as the card holds at once.
template <typename T, bool MODEL, int NV>
int launch_bwd(int nv, const void* x, const void* w, const void* r, const void* dy, void* dx,
               void* part, void* dw, int rows, int E, int blocks, cudaStream_t stream) {
  if constexpr (NV < MAX_WIDTH / (MAX_THREADS * Vec<T>::N)) {
    if (nv > NV)
      return launch_bwd<T, MODEL, 2 * NV>(nv, x, w, r, dy, dx, part, dw, rows, E, blocks, stream);
  }
  const int threads = threads_for<T>(E);
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const float* rt = static_cast<const float*>(r);
  const T* dyt = static_cast<const T*>(dy);
  T* dxt = static_cast<T*>(dx);
  float* pt = static_cast<float*>(part);
  float* dwt = static_cast<float*>(dw);
  if (dw == nullptr) {
    rmsnorm_bwd<T, MODEL, NV, false><<<blocks, threads, 0, stream>>>(xt, wt, rt, dyt, dxt, pt, dwt,
                                                                     rows, E);
    return (int)cudaGetLastError();
  }
  auto kernel = rmsnorm_bwd<T, MODEL, NV, true>;
  static std::atomic<unsigned long long> cache{0};
  int resident = 0;
  const cudaError_t err =
      resident_blocks(reinterpret_cast<const void*>(kernel), threads, cache, &resident);
  if (err != cudaSuccess) return (int)err;
  if (blocks > resident) blocks = resident;
  void* args[] = {&xt, &wt, &rt, &dyt, &dxt, &pt, &dwt, &rows, &E};
  const cudaError_t launched = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(blocks), dim3(threads), args, 0, stream);
  return (int)(launched != cudaSuccess ? launched : cudaGetLastError());
}

// blocks in [1, rows]; part (>= blocks, E) fp32 and dw (E,) fp32 together, or
// both null (no dw)
template <typename T, bool MODEL>
int bwd(const void* x, const void* w, const void* r, const void* dy, void* dx, void* part, void* dw,
        int rows, int E, int blocks, void* stream) {
  if (!shape_ok(x, w, rows, E) || blocks < 1 || blocks > rows || (part == nullptr) != (dw == nullptr))
    return (int)cudaErrorInvalidValue;
  const int per_pass = threads_for<T>(E) * Vec<T>::N;
  return launch_bwd<T, MODEL, 1>((E + per_pass - 1) / per_pass, x, w, r, dy, dx, part, dw, rows, E,
                                 blocks, static_cast<cudaStream_t>(stream));
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

// x, dy, dx (rows, E), w (E,) of one type; r (rows,) fp32; part (>= blocks, E)
// fp32 scratch and dw (E,) fp32, or both null; blocks the persistent grid.
#define RMSNORM_BWD(NAME, MODEL)                                                                 \
  extern "C" int NAME(const void* x, const void* w, const void* r, const void* dy, void* dx,     \
                      void* part, void* dw, int rows, int E, int blocks, int dtype,             \
                      void* stream) {                                                            \
    if (dtype == 0)                                                                              \
      return bwd<__nv_bfloat16, MODEL>(x, w, r, dy, dx, part, dw, rows, E, blocks, stream);      \
    if (dtype == 1) return bwd<float, MODEL>(x, w, r, dy, dx, part, dw, rows, E, blocks, stream); \
    return (int)cudaErrorInvalidValue;                                                           \
  }

RMSNORM_FWD(rmsnorm_fwd_model_launch, true)
RMSNORM_FWD(rmsnorm_fwd_fused_launch, false)
RMSNORM_BWD(rmsnorm_bwd_model_launch, true)
RMSNORM_BWD(rmsnorm_bwd_fused_launch, false)
