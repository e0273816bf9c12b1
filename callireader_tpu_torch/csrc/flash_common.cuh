// Shared tile loop of the port's attention kernels (ViT packed-QKV attention
// and the LLM prefill flash attention). Plain CUDA C++ for sm_90a, no
// tensor-core instructions yet: scores and the weighted sum of V run as fp32
// FMAs on the CUDA cores, with K/V tiles staged in shared memory.
//
// Layout. One block owns ROWS = 64 query rows: QT = ROWS / G consecutive
// query positions for each of the G query heads that share one KV head, so
// every K/V tile a block stages serves the whole GQA group (no repeat_kv, and
// each KV element is read from device memory once per block). Each query row
// is owned by TPR = 4 neighbouring threads; thread `part` of a row holds the
// 16-byte vectors v*TPR + part of the row (interleaved so that the four
// threads read four neighbouring 16-byte words of a shared K/V row: no bank
// conflicts). A dot product is the sum of the four partial sums (two
// shuffles inside the quad).
//
// Softmax. Online softmax in fp32 over sub-tiles of SUB keys, in the log2
// domain (softmax scale * log2(e) folded into q). Masked keys get -inf and
// weigh exactly 0, so a row that attends to nothing ends with l == 0 and is
// written as zeros.
//
// Strides are in elements; every row start must be 16-byte aligned (the
// Python wrappers check D % 8 == 0 and the base pointers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cr {

constexpr int TPR = 4;                // threads per query row
constexpr int ROWS = 64;              // query rows per block
constexpr int KT = 64;                // keys per shared-memory tile
constexpr int SUB = 16;               // keys per online-softmax update
constexpr int NTHREADS = ROWS * TPR;  // 256

struct AttnArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  long long q_sb, q_sh, q_ss;  // batch, head, sequence strides (elements)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int Sq, Sk;
  int causal;
  int q_offset;      // query row i sits at key position i + q_offset
  const int* q_seg;  // (B, Sq) or null
  const int* k_seg;  // (B, Sk) or null
  float scale_log2;  // softmax scale * log2(e)
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* in) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// grid: (ceil(Sq / QT), number of KV heads, B); block: NTHREADS
template <int D, int G>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(const AttnArgs a) {
  constexpr int VPT = D / (8 * TPR);  // 16-byte vectors per thread per row
  constexpr int DPT = VPT * 8;
  constexpr int QT = ROWS / G;
  static_assert(D % (8 * TPR) == 0, "D must be a multiple of 32");
  static_assert(ROWS % G == 0, "group size must divide 64");
  static_assert(KT % SUB == 0, "SUB must divide KT");

  __shared__ __align__(16) __nv_bfloat16 ks[KT * D];
  __shared__ __align__(16) __nv_bfloat16 vs[KT * D];
  __shared__ int segs[KT];

  const int tid = threadIdx.x;
  const int row = tid / TPR, part = tid % TPR;
  const int g = row / QT, qi = row % QT;
  const int q0 = blockIdx.x * QT;
  const int qpos = q0 + qi;
  const int hkv = blockIdx.y, b = blockIdx.z;
  const int hq = hkv * G + g;
  const bool qvalid = qpos < a.Sq;

  float qr[DPT], acc[DPT];
  if (qvalid) {
    const __nv_bfloat16* qp = a.q + b * a.q_sb + hq * a.q_sh + (long long)qpos * a.q_ss;
#pragma unroll
    for (int v = 0; v < VPT; ++v) load8(qp + (v * TPR + part) * 8, qr + v * 8);
#pragma unroll
    for (int i = 0; i < DPT; ++i) qr[i] *= a.scale_log2;
  } else {
#pragma unroll
    for (int i = 0; i < DPT; ++i) qr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int qseg = (a.q_seg != nullptr && qvalid) ? a.q_seg[(long long)b * a.Sq + qpos] : 0;
  // causal: keys past the block's last query row are never attended
  const int q_last = min(q0 + QT, a.Sq) - 1 + a.q_offset;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;

  const __nv_bfloat16* kbase = a.k + b * a.k_sb + hkv * a.k_sh;
  const __nv_bfloat16* vbase = a.v + b * a.v_sb + hkv * a.v_sh;
  constexpr int NV = KT * D / 8;
  for (int k0 = 0; k0 < k_end; k0 += KT) {
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < NV; i += NTHREADS) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const int kp = k0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (kp < a.Sk) {
        kv = *reinterpret_cast<const uint4*>(kbase + (long long)kp * a.k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vbase + (long long)kp * a.v_ss + c);
      }
      *reinterpret_cast<uint4*>(ks + r * D + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * D + c) = vv;
    }
    if (tid < KT)
      segs[tid] = (a.k_seg != nullptr && k0 + tid < a.Sk) ? a.k_seg[(long long)b * a.Sk + k0 + tid] : 0;
    __syncthreads();

    const int nkeys = min(KT, k_end - k0);
    for (int j0 = 0; j0 < nkeys; j0 += SUB) {
      float s[SUB];
      float mloc = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const int j = j0 + jj;
        const __nv_bfloat16* kr = ks + j * D;
        float dot = 0.f;
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          float kf[8];
          load8(kr + (v * TPR + part) * 8, kf);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qr[v * 8 + e], kf[e], dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        dot += __shfl_xor_sync(0xffffffffu, dot, 2);
        const int kp = k0 + j;
        bool ok = qvalid && j < nkeys;
        if (a.causal) ok = ok && (kp <= qpos + a.q_offset);
        if (a.k_seg != nullptr) ok = ok && (segs[j] == qseg);
        s[jj] = ok ? dot : -INFINITY;
        mloc = fmaxf(mloc, s[jj]);
      }
      const float m_new = fmaxf(m, mloc);
      if (m_new == -INFINITY) continue;  // nothing attendable yet
      const float alpha = exp2f(m - m_new);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < SUB; ++jj) {
        const float p = exp2f(s[jj] - m_new);
        l += p;
        const __nv_bfloat16* vr = vs + (j0 + jj) * D;
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          float vf[8];
          load8(vr + (v * TPR + part) * 8, vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[v * 8 + e] = fmaf(p, vf[e], acc[v * 8 + e]);
        }
      }
      m = m_new;
    }
  }

  if (qvalid) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
    __nv_bfloat16* op = a.o + b * a.o_sb + hq * a.o_sh + (long long)qpos * a.o_ss;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      float t[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = acc[v * 8 + e] * inv;
      store8(op + (v * TPR + part) * 8, t);
    }
  }
}

template <int D, int G>
inline void launch_flash(const AttnArgs& a, int num_kv_heads, int batch, cudaStream_t stream) {
  constexpr int QT = ROWS / G;
  dim3 grid((a.Sq + QT - 1) / QT, num_kv_heads, batch);
  flash_fwd_kernel<D, G><<<grid, NTHREADS, 0, stream>>>(a);
}

}  // namespace cr
