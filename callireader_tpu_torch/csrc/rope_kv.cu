// The decode token's rotate-half RoPE and its KV-cache write, one launch a
// layer.
//
// Replaces no TPU kernel: the JAX package leaves this glue to XLA, which fuses
// it into the decode step. The port's decode step ran it as plain PyTorch,
// sixteen launches a layer (for q and for k: cast to fp32, negate the half,
// cat, two products, the sum, the cast back; then two indexed cache writes).
// For one decode token of each row b:
//   q_out[b, h]                 = T(rope(q[b, h]))                  h < Hq
//   cache_k[rows[b], j, pos[b]] = C(T(rope(k[b, j])))               j < Hkv
//   cache_v[rows[b], j, pos[b]] = C(v[b, j])
// with rope(x)[d] = x[d] * cos[b, d] + rot(x)[d] * sin[b, d], rot(x) =
// [-x[half:], x[:half]], T the activations' type and C the cache's (bf16 or
// fp32 each). Each product and the sum are rounded to fp32 on their own
// (__fmul_rn / __fadd_rn: no contraction into an FMA), then the result to T
// with round-to-nearest-even: the bits of the plain form, which computes each
// of them as a separate elementwise operation. q, k and v are strided views
// (B, H, D) with the element (b, h, d) at b * sb + h * sh + d: the split of
// the fused wqkv product or three separate products, read in place. The
// destination is a pair of layer views (N, Hkv, T, D) with a row index and a
// position per row: the batch cache (rows 0..B-1, one slot), the serving slot
// pool (per-row lengths) or the page pool (page id, offset in the page).
//
// Bound on the H100: launch latency. A layer moves ~0.2 MB at the 8b decode
// shape (B=8, Hq=32, Hkv=8, D=128), 0.06 us at 3.35 TB/s; the launch costs a
// few us. So the design is one launch with one thread per (b, head, d < half)
// pair: each thread reads x[d] and x[d + half] (a warp reads neighbouring
// elements), writes both rotated values, and the key heads' threads copy the
// value pair too. No shared memory, no barrier, no host read: the decode's
// CUDA graphs capture it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float load(const float* p) { return *p; }

// x rounded to T, round-to-nearest-even
__device__ __forceinline__ float round_to(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_to(float x, const float*) { return x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* cos;  // (B, D) rows, contiguous
  const float* sin;
  const long long* rows;  // (B,) with stride rows_sb
  const long long* pos;   // (B,) with stride pos_sb
  void* q_out;            // (B, Hq, D) contiguous
  void* cache_k;          // (N, Hkv, T, D) with strides c_sn, c_sh, c_st, 1
  void* cache_v;
  long long q_sb, q_sh, k_sb, k_sh, v_sb, v_sh, rows_sb, pos_sb, c_sn, c_sh, c_st;
  int B, Hq, Hkv, D, N, T;
};

// the two rotated values of the pair (d, d + half)
__device__ __forceinline__ void rope_pair(float x0, float x1, const float* c, const float* s,
                                          int d, int half, float& y0, float& y1) {
  y0 = __fadd_rn(__fmul_rn(x0, c[d]), __fmul_rn(-x1, s[d]));
  y1 = __fadd_rn(__fmul_rn(x1, c[d + half]), __fmul_rn(x0, s[d + half]));
}

template <typename T, typename C>
__global__ void __launch_bounds__(THREADS) rope_kv(const Args a) {
  const int half = a.D >> 1;
  const int H = a.Hq + a.Hkv;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= a.B * H * half) return;
  const int d = idx % half;
  const int h = (idx / half) % H;
  const int b = idx / (half * H);
  const float* c = a.cos + (long long)b * a.D;
  const float* s = a.sin + (long long)b * a.D;
  const T* tag = nullptr;
  float y0, y1;
  if (h < a.Hq) {
    const T* x = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    rope_pair(load(x + d), load(x + d + half), c, s, d, half, y0, y1);
    T* out = static_cast<T*>(a.q_out) + ((long long)b * a.Hq + h) * a.D;
    store(out + d, y0);
    store(out + d + half, y1);
    return;
  }
  const int j = h - a.Hq;
  const long long r = a.rows[b * a.rows_sb], p = a.pos[b * a.pos_sb];
  // an index outside the cache faults, as the indexed writes it replaces do
  if (r < 0 || r >= a.N || p < 0 || p >= a.T) __trap();
  const long long at = r * a.c_sn + j * a.c_sh + p * a.c_st;
  const T* x = static_cast<const T*>(a.k) + b * a.k_sb + j * a.k_sh;
  rope_pair(load(x + d), load(x + d + half), c, s, d, half, y0, y1);
  C* ck = static_cast<C*>(a.cache_k) + at;
  store(ck + d, round_to(y0, tag));
  store(ck + d + half, round_to(y1, tag));
  const T* vx = static_cast<const T*>(a.v) + b * a.v_sb + j * a.v_sh;
  C* cv = static_cast<C*>(a.cache_v) + at;
  store(cv + d, load(vx + d));
  store(cv + d + half, load(vx + d + half));
}

template <typename T, typename C>
int launch(const Args& a, cudaStream_t stream) {
  const long long n = (long long)a.B * (a.Hq + a.Hkv) * (a.D / 2);
  rope_kv<T, C><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, q_out of one activation type (x_dtype: 0 = bf16, 1 = fp32), the
// two caches of one type (c_dtype, the same codes); cos, sin fp32 (B, D);
// rows, pos int64. Strides in elements.
extern "C" int rope_kv_launch(const void* q, const void* k, const void* v, const void* cos,
                              const void* sin, const void* rows, const void* pos, void* q_out,
                              void* cache_k, void* cache_v, long long q_sb, long long q_sh,
                              long long k_sb, long long k_sh, long long v_sb, long long v_sh,
                              long long rows_sb, long long pos_sb, long long c_sn, long long c_sh,
                              long long c_st, int B, int Hq, int Hkv, int D, int N, int T,
                              int x_dtype, int c_dtype, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || D < 2 || D % 2 || N < 1 || T < 1 ||
      (long long)B * (Hq + Hkv) * (D / 2) >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const float*>(cos), static_cast<const float*>(sin),
               static_cast<const long long*>(rows), static_cast<const long long*>(pos), q_out,
               cache_k, cache_v, q_sb, q_sh, k_sb, k_sh, v_sb, v_sh, rows_sb, pos_sb, c_sn, c_sh,
               c_st, B, Hq, Hkv, D, N, T};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && c_dtype == 0) return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  if (x_dtype == 0 && c_dtype == 1) return launch<__nv_bfloat16, float>(a, s);
  if (x_dtype == 1 && c_dtype == 0) return launch<float, __nv_bfloat16>(a, s);
  if (x_dtype == 1 && c_dtype == 1) return launch<float, float>(a, s);
  return (int)cudaErrorInvalidValue;
}
