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
// What bounds it on the H100: operations (2, 3 and 4 products of
// 2*D flops per attended (query, key) pair for the forward, dq and dk/dv)
// against a few tens of MB. This first version runs every product as fp32
// FMAs on the CUDA cores; tensor cores come later.
//
// Layout. Forward and dq: a block owns ROWS = 64 query rows, QT = ROWS / G
// positions of each of the G query heads that share one KV head, so each
// staged K/V tile serves the whole group; four threads own a row (16-byte
// vectors v * TPR + part), a dot product is the quad's sum (two shuffles).
// dk/dv: a block owns 64 keys of one KV head, four threads a key, and walks
// the G query heads times the query tiles that can see its keys, staging
// Q and dO; dK and dV stay in registers, so no atomics: the result is the
// same on every run. Scores live in the log2 domain (scale * log2(e) folded
// into q or k).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_vec.cuh"

namespace crt {

using cr::load8;
using cr::store8;

constexpr int TPR = 4;               // threads per query row (fwd, dq) or key (dk/dv)
constexpr int ROWS = 64;             // query rows (fwd, dq) or keys (dk/dv) per block
constexpr int KT = 64;               // keys per staged tile (fwd, dq)
constexpr int QR = 64;               // query rows per staged tile (dk/dv)
constexpr int SUB = 16;              // keys per online-softmax update (forward)
constexpr int NTHREADS = ROWS * TPR;  // 256
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NO_KEY_LSE = -1e30f;  // lse of a row with no attendable key

struct Args {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dO;  // output gradient (backward)
  const float* lse;         // (B, Hq, Sq) (backward)
  const float* dsum;        // (B, Hq, Sq) rowsum(dO * O) (backward)
  const int* q_seg;         // (B, Sq) or null
  const int* k_seg;         // (B, Sk) or null
  __nv_bfloat16* out;       // forward: o; dq kernel: dq; dk/dv kernel: dk
  __nv_bfloat16* out2;      // dk/dv kernel: dv
  float* lse_out;           // forward: lse
  int Hq, Hkv, Sq, Sk, causal;
  float scale;
};

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// Stage KT keys of K and V (and their segment ids) from key k0 into shared
// memory, zeros past Sk.
template <int D>
__device__ __forceinline__ void stage_kv(const Args& a, const __nv_bfloat16* kbase,
                                         const __nv_bfloat16* vbase, const int* kseg_row, int k0,
                                         __nv_bfloat16* ks, __nv_bfloat16* vs, int* segs) {
  constexpr int NV = KT * D / 8;
  const int tid = threadIdx.x;
  for (int i = tid; i < NV; i += NTHREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int kp = k0 + r;
    uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
    if (kp < a.Sk) {
      kv = *reinterpret_cast<const uint4*>(kbase + (long long)kp * D + c);
      vv = *reinterpret_cast<const uint4*>(vbase + (long long)kp * D + c);
    }
    *reinterpret_cast<uint4*>(ks + r * D + c) = kv;
    *reinterpret_cast<uint4*>(vs + r * D + c) = vv;
  }
  if (tid < KT) segs[tid] = (kseg_row != nullptr && k0 + tid < a.Sk) ? kseg_row[k0 + tid] : 0;
}

// ---------------------------------------------------------------- forward
// grid: (ceil(Sq / QT), Hkv, B); block: NTHREADS
template <int D, int G>
__global__ void __launch_bounds__(NTHREADS) fwd_lse_kernel(const Args a) {
  constexpr int VPT = D / (8 * TPR);
  constexpr int DPT = VPT * 8;
  constexpr int QT = ROWS / G;
  static_assert(D % (8 * TPR) == 0, "D must be a multiple of 32");
  static_assert(ROWS % G == 0, "group size must divide 64");

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
  const long long qrow = ((long long)b * a.Hq + hq) * a.Sq + qpos;
  const float sl2 = a.scale * LOG2E;

  float qr[DPT], acc[DPT];
  if (qvalid) {
    const __nv_bfloat16* qp = a.q + qrow * D;
#pragma unroll
    for (int v = 0; v < VPT; ++v) load8(qp + (v * TPR + part) * 8, qr + v * 8);
#pragma unroll
    for (int i = 0; i < DPT; ++i) qr[i] *= sl2;
  } else {
#pragma unroll
    for (int i = 0; i < DPT; ++i) qr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  const int qseg = (a.q_seg != nullptr && qvalid) ? a.q_seg[(long long)b * a.Sq + qpos] : 0;
  const int q_last = min(q0 + QT, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;

  const long long kvoff = ((long long)b * a.Hkv + hkv) * a.Sk * D;
  const int* kseg_row = a.k_seg != nullptr ? a.k_seg + (long long)b * a.Sk : nullptr;
  for (int k0 = 0; k0 < k_end; k0 += KT) {
    __syncthreads();  // the previous tile has been consumed
    stage_kv<D>(a, a.k + kvoff, a.v + kvoff, kseg_row, k0, ks, vs, segs);
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
        dot = quad_sum(dot);
        bool ok = qvalid && j < nkeys;
        if (a.causal) ok = ok && (k0 + j <= qpos);
        if (kseg_row != nullptr) ok = ok && (segs[j] == qseg);
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
    __nv_bfloat16* op = a.out + qrow * D;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      float t[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = acc[v * 8 + e] * inv;
      store8(op + (v * TPR + part) * 8, t);
    }
    // natural-log lse: m is in log2 units
    if (part == 0) a.lse_out[qrow] = l > 0.f ? m * LN2 + logf(l) : NO_KEY_LSE;
  }
}

// ---------------------------------------------------------------- dq
// grid: (ceil(Sq / QT), Hkv, B); block: NTHREADS
template <int D, int G>
__global__ void __launch_bounds__(NTHREADS) dq_kernel(const Args a) {
  constexpr int VPT = D / (8 * TPR);
  constexpr int DPT = VPT * 8;
  constexpr int QT = ROWS / G;

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
  const long long qrow = ((long long)b * a.Hq + hq) * a.Sq + qpos;
  const float sl2 = a.scale * LOG2E;

  float qr[DPT], dor[DPT], dqa[DPT];
  // lse2 = +inf makes every P of the row exp2(-inf) = 0: rows past Sq and
  // rows that attend to nothing
  float lse2 = INFINITY, di = 0.f;
  if (qvalid) {
    const __nv_bfloat16* qp = a.q + qrow * D;
    const __nv_bfloat16* dp = a.dO + qrow * D;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      load8(qp + (v * TPR + part) * 8, qr + v * 8);
      load8(dp + (v * TPR + part) * 8, dor + v * 8);
    }
#pragma unroll
    for (int i = 0; i < DPT; ++i) qr[i] *= sl2;
    const float L = a.lse[qrow];
    if (L > 0.5f * NO_KEY_LSE) lse2 = L * LOG2E;
    di = a.dsum[qrow];
  } else {
#pragma unroll
    for (int i = 0; i < DPT; ++i) qr[i] = dor[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) dqa[i] = 0.f;
  const int qseg = (a.q_seg != nullptr && qvalid) ? a.q_seg[(long long)b * a.Sq + qpos] : 0;
  const int q_last = min(q0 + QT, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;

  const long long kvoff = ((long long)b * a.Hkv + hkv) * a.Sk * D;
  const int* kseg_row = a.k_seg != nullptr ? a.k_seg + (long long)b * a.Sk : nullptr;
  for (int k0 = 0; k0 < k_end; k0 += KT) {
    __syncthreads();
    stage_kv<D>(a, a.k + kvoff, a.v + kvoff, kseg_row, k0, ks, vs, segs);
    __syncthreads();

    const int nkeys = min(KT, k_end - k0);
    // one key at a time: its K row stays in registers from the score to
    // the dQ update (a group of keys with an array of their dS spills)
#pragma unroll 2
    for (int j = 0; j < nkeys; ++j) {
      const __nv_bfloat16* kr = ks + j * D;
      const __nv_bfloat16* vr = vs + j * D;
      float kf[DPT];
      float dot = 0.f, dpv = 0.f;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        float vf[8];
        load8(kr + (v * TPR + part) * 8, kf + v * 8);
        load8(vr + (v * TPR + part) * 8, vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          dot = fmaf(qr[v * 8 + e], kf[v * 8 + e], dot);
          dpv = fmaf(dor[v * 8 + e], vf[e], dpv);
        }
      }
      dot = quad_sum(dot);
      dpv = quad_sum(dpv);
      bool ok = qvalid;
      if (a.causal) ok = ok && (k0 + j <= qpos);
      if (kseg_row != nullptr) ok = ok && (segs[j] == qseg);
      const float ds = (ok ? exp2f(dot - lse2) : 0.f) * (dpv - di);
#pragma unroll
      for (int i = 0; i < DPT; ++i) dqa[i] = fmaf(ds, kf[i], dqa[i]);
    }
  }

  if (qvalid) {
    __nv_bfloat16* op = a.out + qrow * D;
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      float t[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) t[e] = dqa[v * 8 + e] * a.scale;
      store8(op + (v * TPR + part) * 8, t);
    }
  }
}

// ---------------------------------------------------------------- dk / dv
// grid: (ceil(Sk / ROWS), Hkv, B); block: NTHREADS
template <int D, int G>
__global__ void __launch_bounds__(NTHREADS) dkdv_kernel(const Args a) {
  constexpr int VPT = D / (8 * TPR);
  constexpr int DPT = VPT * 8;

  __shared__ __align__(16) __nv_bfloat16 qs[QR * D];
  __shared__ __align__(16) __nv_bfloat16 dos[QR * D];
  __shared__ float lse2s[QR];
  __shared__ float dis[QR];
  __shared__ int qsegs[QR];

  const int tid = threadIdx.x;
  const int krow = tid / TPR, part = tid % TPR;
  const int k0 = blockIdx.x * ROWS;
  const int kpos = k0 + krow;
  const int hkv = blockIdx.y, b = blockIdx.z;
  const bool kvalid = kpos < a.Sk;
  const long long krow_off = (((long long)b * a.Hkv + hkv) * a.Sk + kpos) * D;
  const float sl2 = a.scale * LOG2E;

  float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
  if (kvalid) {
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      load8(a.k + krow_off + (v * TPR + part) * 8, kr + v * 8);
      load8(a.v + krow_off + (v * TPR + part) * 8, vr + v * 8);
    }
#pragma unroll
    for (int i = 0; i < DPT; ++i) kr[i] *= sl2;
  } else {
#pragma unroll
    for (int i = 0; i < DPT; ++i) kr[i] = vr[i] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) dka[i] = dva[i] = 0.f;
  const int kseg = (a.k_seg != nullptr && kvalid) ? a.k_seg[(long long)b * a.Sk + kpos] : 0;
  const int* qseg_row = a.q_seg != nullptr ? a.q_seg + (long long)b * a.Sq : nullptr;
  // causal: queries before the block's first key see none of its keys
  const int q_begin = a.causal ? k0 : 0;

  for (int g = 0; g < G; ++g) {
    const int hq = hkv * G + g;
    const long long hrow = ((long long)b * a.Hq + hq) * a.Sq;
    const __nv_bfloat16* qbase = a.q + hrow * D;
    const __nv_bfloat16* dbase = a.dO + hrow * D;
    for (int q0 = q_begin; q0 < a.Sq; q0 += QR) {
      __syncthreads();  // the previous tile has been consumed
      constexpr int NV = QR * D / 8;
      for (int i = tid; i < NV; i += NTHREADS) {
        const int r = i / (D / 8), c = (i % (D / 8)) * 8;
        const int qp = q0 + r;
        uint4 qv = make_uint4(0u, 0u, 0u, 0u), dv = make_uint4(0u, 0u, 0u, 0u);
        if (qp < a.Sq) {
          qv = *reinterpret_cast<const uint4*>(qbase + (long long)qp * D + c);
          dv = *reinterpret_cast<const uint4*>(dbase + (long long)qp * D + c);
        }
        *reinterpret_cast<uint4*>(qs + r * D + c) = qv;
        *reinterpret_cast<uint4*>(dos + r * D + c) = dv;
      }
      if (tid < QR) {
        const int qp = q0 + tid;
        float l2 = INFINITY, d = 0.f;
        int sg = 0;
        if (qp < a.Sq) {
          const float L = a.lse[hrow + qp];
          if (L > 0.5f * NO_KEY_LSE) l2 = L * LOG2E;
          d = a.dsum[hrow + qp];
          if (qseg_row != nullptr) sg = qseg_row[qp];
        }
        lse2s[tid] = l2;
        dis[tid] = d;
        qsegs[tid] = sg;
      }
      __syncthreads();

      const int nrows = min(QR, a.Sq - q0);
      for (int i = 0; i < nrows; ++i) {
        const __nv_bfloat16* qrow = qs + i * D;
        const __nv_bfloat16* drow = dos + i * D;
        float dot = 0.f, dpv = 0.f;
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          float qf[8], df[8];
          load8(qrow + (v * TPR + part) * 8, qf);
          load8(drow + (v * TPR + part) * 8, df);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            dot = fmaf(qf[e], kr[v * 8 + e], dot);
            dpv = fmaf(df[e], vr[v * 8 + e], dpv);
          }
        }
        dot = quad_sum(dot);
        dpv = quad_sum(dpv);
        bool ok = kvalid;
        if (a.causal) ok = ok && (q0 + i >= kpos);
        if (qseg_row != nullptr) ok = ok && (qsegs[i] == kseg);
        const float p = ok ? exp2f(dot - lse2s[i]) : 0.f;
        // a warp whose 8 keys all miss this query row skips the two updates
        if (!__any_sync(0xffffffffu, p != 0.f)) continue;
        const float ds = p * (dpv - dis[i]);
#pragma unroll
        for (int v = 0; v < VPT; ++v) {
          float qf[8], df[8];
          load8(qrow + (v * TPR + part) * 8, qf);
          load8(drow + (v * TPR + part) * 8, df);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            dva[v * 8 + e] = fmaf(p, df[e], dva[v * 8 + e]);
            dka[v * 8 + e] = fmaf(ds, qf[e], dka[v * 8 + e]);
          }
        }
      }
    }
  }

  if (kvalid) {
#pragma unroll
    for (int v = 0; v < VPT; ++v) {
      float t[8], u[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        t[e] = dka[v * 8 + e] * a.scale;
        u[e] = dva[v * 8 + e];
      }
      store8(a.out + krow_off + (v * TPR + part) * 8, t);
      store8(a.out2 + krow_off + (v * TPR + part) * 8, u);
    }
  }
}

inline Args make_args(const void* q, const void* k, const void* v, const void* q_seg,
                      const void* k_seg, int Hq, int Hkv, int Sq, int Sk, int causal, float scale) {
  Args a{};
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.q_seg = static_cast<const int*>(q_seg);
  a.k_seg = static_cast<const int*>(k_seg);
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.causal = causal;
  a.scale = scale;
  return a;
}

// Instantiated for the LLM shape of every full-width preset (D = 128, G = 4).
inline bool supported(int Hq, int Hkv, int D) {
  return Hkv > 0 && Hq % Hkv == 0 && D == 128 && Hq / Hkv == 4;
}

}  // namespace crt

extern "C" int attn_train_fwd_launch(const void* q, const void* k, const void* v, void* out,
                                     void* lse, const void* q_seg, const void* k_seg, int B,
                                     int Hq, int Hkv, int Sq, int Sk, int D, int causal,
                                     float scale, void* stream) {
  if (!crt::supported(Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  crt::Args a = crt::make_args(q, k, v, q_seg, k_seg, Hq, Hkv, Sq, Sk, causal, scale);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.lse_out = static_cast<float*>(lse);
  constexpr int QT = crt::ROWS / 4;
  dim3 grid((Sq + QT - 1) / QT, Hkv, B);
  crt::fwd_lse_kernel<128, 4><<<grid, crt::NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int attn_train_dq_launch(const void* q, const void* k, const void* v, const void* dO,
                                    const void* lse, const void* dsum, const void* q_seg,
                                    const void* k_seg, void* dq, int B, int Hq, int Hkv, int Sq,
                                    int Sk, int D, int causal, float scale, void* stream) {
  if (!crt::supported(Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  crt::Args a = crt::make_args(q, k, v, q_seg, k_seg, Hq, Hkv, Sq, Sk, causal, scale);
  a.dO = static_cast<const __nv_bfloat16*>(dO);
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.out = static_cast<__nv_bfloat16*>(dq);
  constexpr int QT = crt::ROWS / 4;
  dim3 grid((Sq + QT - 1) / QT, Hkv, B);
  crt::dq_kernel<128, 4><<<grid, crt::NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int attn_train_dkv_launch(const void* q, const void* k, const void* v, const void* dO,
                                     const void* lse, const void* dsum, const void* q_seg,
                                     const void* k_seg, void* dk, void* dv, int B, int Hq,
                                     int Hkv, int Sq, int Sk, int D, int causal, float scale,
                                     void* stream) {
  if (!crt::supported(Hq, Hkv, D)) return (int)cudaErrorInvalidValue;
  crt::Args a = crt::make_args(q, k, v, q_seg, k_seg, Hq, Hkv, Sq, Sk, causal, scale);
  a.dO = static_cast<const __nv_bfloat16*>(dO);
  a.lse = static_cast<const float*>(lse);
  a.dsum = static_cast<const float*>(dsum);
  a.out = static_cast<__nv_bfloat16*>(dk);
  a.out2 = static_cast<__nv_bfloat16*>(dv);
  dim3 grid((Sk + crt::ROWS - 1) / crt::ROWS, Hkv, B);
  crt::dkdv_kernel<128, 4><<<grid, crt::NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
