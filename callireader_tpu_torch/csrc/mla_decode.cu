// Latent attention's decode (the absorbed form): for each batch row, 16
// query heads of 576 = [latent 512 | RoPE 64] against that row's cached
// latent rows [RMSNorm(c_kv) | rope(k_pe)] (one row a token, shared by every
// head), out = softmax(q k^T scale) c_kv (the first 512 of each row).
//
// No JAX counterpart (the JAX package's LLM is InternLM2). Bound on the H100:
// bytes, the valid latent rows (1152 B each) read once a step for all 16
// heads: ~4.4 MB a layer at a page batch (8 rows, ~3.8k keys each).
//
// Design. The 16 heads are exactly the M of mma.sync m16n8k16, so one pass
// over a row's keys serves every head on the tensor cores. A block owns one
// batch row and one split of that row's keys [0, slot] (the split bounds are
// read on the device, so one launch serves every step of a CUDA graph), and
// walks its split in chunks of 32 keys: two shared-memory stages filled by
// cp.async (a chunk whose keys are all invalid, a left-padded prompt's pad,
// is never loaded). Four warps:
//   - scores: warp w takes keys 8w .. 8w + 7 of the chunk, S (16 x 8) over
//     k = 576 (36 products; q from shared memory, the keys by ldmatrix),
//     scaled into the log2 domain and masked (kv_valid == 0 or past slot),
//     into shared memory;
//   - softmax: the 128 threads take 16 rows x 32 keys, 8 threads a row:
//     the running maximum and sum in fp32, P = 2^(S - m) split into bf16
//     hi and lo parts (a P rounded once to bf16 would miss the fp32 plain
//     version by far more than its tolerance; kernels/tolerance.py);
//   - P V: warp w owns 128 of the 512 output columns (16 n8 tiles), the
//     values are the chunk's first 512 columns read by ldmatrix.trans, and
//     O += P_hi V + P_lo V after O is scaled by the rows' alpha.
// Each split writes its fp32 O (16 x 512), row maxima and sums; a combine
// kernel (one block a (row, head)) merges the splits and rounds to bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NH = 16;      // query heads (the mma M)
constexpr int DL = 576;     // a latent row: latent 512, then RoPE 64
constexpr int DV = 512;     // the value part of a latent row
constexpr int KC = 32;      // keys a chunk
constexpr int THREADS = 128;
constexpr int LSTR = DL + 8;  // bf16 a shared row: 1168 B, eight rows in distinct banks
constexpr int PSTR = KC + 8;  // bf16 a row of P: 80 B
constexpr int STAGES = 2;
constexpr int SMEM = (NH * LSTR + STAGES * KC * LSTR + 2 * NH * PSTR) * 2 + NH * KC * 4 + 3 * NH * 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes = 0 fills zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += A B, m16n8k16, bf16 in, fp32 out
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Args {
  const __nv_bfloat16* q;   // (B, 16, 576)
  const __nv_bfloat16* kv;  // the layer's cache (B, T, 576), row b at b * kv_sb
  const int* valid;         // (B, T) 1 = attendable
  const long long* slot;    // (1,): keys 0 .. slot may be attended
  float* o_part;            // (B, splits, 16, 512)
  float* m_part;            // (B, splits, 16), log2 domain
  float* l_part;            // (B, splits, 16)
  long long kv_sb;
  int T, splits;
  float scale_log2;
};

// the first chunk at or after c (and before end) with a valid key: every warp
// reads the chunk's 32 validity flags and agrees by ballot
__device__ __forceinline__ int next_live(const int* valid, int c, int end, int lim, int lane) {
  for (; c < end; ++c) {
    const int j = c * KC + lane;
    const bool v = j < lim && valid[j] != 0;
    if (__any_sync(0xffffffffu, v)) return c;
  }
  return end;
}

__global__ void __launch_bounds__(THREADS) latent_decode_kernel(const Args a) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + NH * LSTR;
  __nv_bfloat16* ph_s = kv_s + STAGES * KC * LSTR;
  __nv_bfloat16* pl_s = ph_s + NH * PSTR;
  float* s_s = reinterpret_cast<float*>(pl_s + NH * PSTR);
  float* m_s = s_s + NH * KC;
  float* l_s = m_s + NH;
  float* a_s = l_s + NH;

  const int b = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int lim = static_cast<int>(*a.slot) + 1;  // keys 0 .. slot
  const int nct = (lim + KC - 1) / KC;
  const int begin = static_cast<int>((long long)split * nct / a.splits);
  const int end = static_cast<int>((long long)(split + 1) * nct / a.splits);
  const int* valid = a.valid + (long long)b * a.T;
  const __nv_bfloat16* kv = a.kv + b * a.kv_sb;

  // q: 16 rows of 576 (72 chunks of 16 B each)
  const __nv_bfloat16* q = a.q + (long long)b * NH * DL;
  for (int c = tid; c < NH * (DL / 8); c += THREADS) {
    const int r = c / (DL / 8), u = c % (DL / 8);
    cp_async16(smem_u32(q_s + r * LSTR + u * 8), q + r * DL + u * 8, 16);
  }
  auto load = [&](int st, int chunk) {
    __nv_bfloat16* dst = kv_s + st * KC * LSTR;
    for (int c = tid; c < KC * (DL / 8); c += THREADS) {
      const int r = c / (DL / 8), u = c % (DL / 8);
      const int j = chunk * KC + r;
      const bool in = j < a.T;
      cp_async16(smem_u32(dst + r * LSTR + u * 8), in ? kv + (long long)j * DL + u * 8 : kv, in ? 16 : 0);
    }
  };
  if (tid < NH) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  int cur = next_live(valid, begin, end, lim, lane);
  if (cur < end) load(0, cur);
  cp_commit();  // with q
  int nxt = cur < end ? next_live(valid, cur + 1, end, lim, lane) : end;
  if (nxt < end) load(1, nxt);
  cp_commit();

  float o[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  const int g = lane / 4, c4 = lane % 4;
  int st = 0;
  while (cur < end) {
    cp_wait<1>();
    __syncthreads();
    const __nv_bfloat16* ks = kv_s + st * KC * LSTR;

    // scores of keys 8 warp .. 8 warp + 7 for the 16 heads
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 3
    for (int kk = 0; kk < DL; kk += 32) {
      uint32_t bk[4], aq[4];
      ldsm_x4(bk, smem_u32(ks + (8 * warp + lane % 8) * LSTR + kk + (lane / 8) * 8));
      ldsm_x4(aq, smem_u32(q_s + (lane % 16) * LSTR + kk + (lane / 16) * 8));
      mma16816(sc, aq, bk[0], bk[1]);
      ldsm_x4(aq, smem_u32(q_s + (lane % 16) * LSTR + kk + 16 + (lane / 16) * 8));
      mma16816(sc, aq, bk[2], bk[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * warp + 2 * c4 + (e % 2), head = g + 8 * (e / 2);
      const int j = cur * KC + key;
      const bool ok = j < lim && valid[j] != 0;
      s_s[head * KC + key] = ok ? sc[e] * a.scale_log2 : -INFINITY;
    }
    __syncthreads();

    // online softmax: 8 threads a row, 4 keys each
    {
      const int row = tid / 8, part = tid % 8;
      float v[4], mx = -INFINITY;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = s_s[row * KC + 4 * part + e];
        mx = fmaxf(mx, v[e]);
      }
#pragma unroll
      for (int d = 1; d < 8; d *= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
      const float m_old = m_s[row], m_new = fmaxf(m_old, mx);
      const float mu = m_new == -INFINITY ? 0.f : m_new;  // nothing attendable yet: p = 0
      float sum = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(v[e] - mu);
        sum += p;
        const __nv_bfloat16 hi = __float2bfloat16_rn(p);
        ph_s[row * PSTR + 4 * part + e] = hi;
        pl_s[row * PSTR + 4 * part + e] = __float2bfloat16_rn(p - __bfloat162float(hi));
      }
#pragma unroll
      for (int d = 1; d < 8; d *= 2) sum += __shfl_xor_sync(0xffffffffu, sum, d);
      __syncwarp();
      if (part == 0) {
        const float alpha = exp2f(m_old - mu);
        a_s[row] = alpha;
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
      }
    }
    __syncthreads();

    // O = alpha O + P V over this warp's 128 columns
    const float al0 = a_s[g], al1 = a_s[g + 8];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[j][0] *= al0;
      o[j][1] *= al0;
      o[j][2] *= al1;
      o[j][3] *= al1;
    }
#pragma unroll
    for (int kt = 0; kt < KC / 16; ++kt) {
      uint32_t ph[4], pl[4];
      ldsm_x4(ph, smem_u32(ph_s + (lane % 16) * PSTR + 16 * kt + (lane / 16) * 8));
      ldsm_x4(pl, smem_u32(pl_s + (lane % 16) * PSTR + 16 * kt + (lane / 16) * 8));
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        uint32_t bv[4];
        ldsm_x4_t(bv, smem_u32(ks + (16 * kt + lane % 16) * LSTR + 128 * warp + 16 * np + (lane / 16) * 8));
        mma16816(o[2 * np], ph, bv[0], bv[1]);
        mma16816(o[2 * np], pl, bv[0], bv[1]);
        mma16816(o[2 * np + 1], ph, bv[2], bv[3]);
        mma16816(o[2 * np + 1], pl, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage and with P before they are refilled

    const int nn = nxt < end ? next_live(valid, nxt + 1, end, lim, lane) : end;
    if (nn < end) load(st, nn);
    cp_commit();
    cur = nxt;
    nxt = nn;
    st ^= 1;
  }
  cp_wait<0>();
  __syncthreads();

  const long long part = (long long)b * a.splits + split;
  float* op = a.o_part + part * NH * DV;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 128 * warp + 8 * j + 2 * c4;
    *reinterpret_cast<float2*>(op + g * DV + col) = make_float2(o[j][0], o[j][1]);
    *reinterpret_cast<float2*>(op + (g + 8) * DV + col) = make_float2(o[j][2], o[j][3]);
  }
  if (tid < NH) {
    a.m_part[part * NH + tid] = m_s[tid];
    a.l_part[part * NH + tid] = l_s[tid];
  }
}

// one block a (batch row, head): the splits' O merged by their maxima and sums
__global__ void __launch_bounds__(THREADS) latent_combine_kernel(const float* o_part, const float* m_part,
                                                                 const float* l_part, __nv_bfloat16* out,
                                                                 int splits) {
  const int b = blockIdx.x / NH, h = blockIdx.x % NH;
  float mx = -INFINITY;
  for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m_part[((long long)b * splits + s) * NH + h]);
  const float mu = mx == -INFINITY ? 0.f : mx;
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, l = 0.f;
  for (int s = 0; s < splits; ++s) {
    const long long part = (long long)b * splits + s;
    const float w = exp2f(m_part[part * NH + h] - mu);
    l += w * l_part[part * NH + h];
    const float4 v = *reinterpret_cast<const float4*>(o_part + (part * NH + h) * DV + 4 * threadIdx.x);
    acc[0] += w * v.x;
    acc[1] += w * v.y;
    acc[2] += w * v.z;
    acc[3] += w * v.w;
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  __nv_bfloat16* op = out + ((long long)b * NH + h) * DV + 4 * threadIdx.x;
  *reinterpret_cast<__nv_bfloat162*>(op) = __floats2bfloat162_rn(acc[0] * inv, acc[1] * inv);
  *reinterpret_cast<__nv_bfloat162*>(op + 2) = __floats2bfloat162_rn(acc[2] * inv, acc[3] * inv);
}

}  // namespace

// q (B, 16, 576), the layer's cache kv (B rows at kv_sb elements apart, T
// rows of 576 each), valid (B, T) int32, slot (1,) int64, scratch for the
// splits' partials -> out (B, 16, 512) bf16. All on the stream, no sync.
extern "C" int latent_decode_launch(const void* q, const void* kv, const void* valid, const void* slot,
                                    void* o_part, void* m_part, void* l_part, void* out, int B, int T,
                                    long long kv_sb, int splits, float scale, void* stream) {
  if (B <= 0 || splits <= 0 || kv_sb % 8) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(latent_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kv),
         static_cast<const int*>(valid), static_cast<const long long*>(slot),
         static_cast<float*>(o_part), static_cast<float*>(m_part), static_cast<float*>(l_part),
         kv_sb, T, splits, scale * 1.4426950408889634f};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  latent_decode_kernel<<<B * splits, THREADS, SMEM, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  latent_combine_kernel<<<B * NH, THREADS, 0, s>>>(static_cast<const float*>(o_part),
                                                   static_cast<const float*>(m_part),
                                                   static_cast<const float*>(l_part),
                                                   static_cast<__nv_bfloat16*>(out), splits);
  return (int)cudaGetLastError();
}
