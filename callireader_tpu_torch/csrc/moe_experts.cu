// Routed experts of a sparse (MoE) layer as two grouped bf16 products on the
// tensor cores, with the rows of each expert found on the device:
//   gate_up: act[p] = SwiGLU(h[order[p] / topk] W13[e])  for the routed pairs p
//            of expert e, in the pairs' order sorted by expert;
//   down:    y[order[p]] = act[p] W2[e]                  (each pair's own slot).
// order (P,) int32 is the sorted pairs' slots (token * topk + choice) and
// offsets (n + 1,) int32 the first sorted pair of each expert, both made on
// the device, so nothing is read back to size or place a tile: the grid
// is sized on the host from P alone (an upper bound on the tiles), and each
// block finds its (expert, row tile) by walking the offsets; blocks past the
// last tile exit, and an expert with no rows has no tile.
//
// No JAX counterpart: the JAX package's MoE (models/moe.py's) runs every
// expert on every token. Bound on the H100:
//   - decode (a few tokens, <= 16 rows an expert): bytes. Each touched
//     expert's weights are read once a step (a block streams one 64 x 128
//     slab of K x N per stage) and an expert without rows is never read.
//     BM = 16 rows a tile: one mma M; four warps of 16 x 32.
//   - prefill (thousands of rows an expert): operations. BM = 128, eight
//     warps of 64 x 32, three stages.
// Tiles: BN = 128 output columns, BK = 64; cp.async stages in shared memory
// with rows padded by 16 bytes (ldmatrix's eight rows land in distinct
// banks); mma.sync m16n8k16 (bf16 in, fp32 out), A by ldmatrix, B (the
// weight, (K, N) row-major) by ldmatrix.trans.
// SwiGLU in the epilogue: W13's columns come in groups of 16, eight gate
// columns then the eight up columns of the same outputs (models/mla_moe.py's
// fuse_w13), so a thread's accumulators of two neighbouring n8 tiles hold
// the gate and up of the same two outputs. Rounded as the plain version
// rounds: gate and up to bf16, silu(gate) in fp32 to bf16, the product to
// bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;
constexpr int BK = 64;

template <int BM, int WM, int WN, int STAGES>
struct Cfg {
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int TM = BM / WM;  // rows of a warp tile
  static constexpr int TN = BN / WN;  // columns of a warp tile
  static constexpr int MT = TM / 16;  // m16 tiles a warp
  static constexpr int NT = TN / 8;   // n8 tiles a warp
  static constexpr int A_STRIDE = BK + 8;  // bf16 a shared row of A: 144 B
  static constexpr int B_STRIDE = BN + 8;  // bf16 a shared row of B: 272 B
  static constexpr int A_ELEMS = BM * A_STRIDE;
  static constexpr int STAGE_ELEMS = A_ELEMS + BK * B_STRIDE;
  static constexpr int SMEM = STAGES * STAGE_ELEMS * 2;
  static constexpr int A_CHUNKS = BM * BK / 8 / THREADS;  // 16-byte copies of A a thread a stage
  static_assert(BM * BK / 8 % THREADS == 0 && BK * BN / 8 % THREADS == 0, "even copies");
  static_assert(MT >= 1 && NT % 2 == 0, "warp tiles of m16 x (2 n8)");
};

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

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// silu(bf16(g)) rounded to bf16, times bf16(u), rounded: the plain form's steps
__device__ __forceinline__ float swiglu(float g, float u) {
  const float gb = bf16r(g);
  const float s = bf16r(gb / (1.f + expf(-gb)));
  return s * bf16r(u);
}

struct Args {
  const __nv_bfloat16* a;  // gate_up: h (T, K), rows gathered; down: act (P, K), rows in order
  const int* order;        // (P,) the slot of each sorted pair
  const int* offsets;      // (n + 1,) the first sorted pair of each expert
  const __nv_bfloat16* w;  // (n, K, N) the experts' weights, (in, out)
  __nv_bfloat16* out;      // gate_up: act (P, N / 2); down: y (P, N) by slot
  int n_experts, K, N, topk;
};

template <int BM, int WM, int WN, int STAGES, bool UP>
__global__ void __launch_bounds__(WM * WN * 32) moe_kernel(const Args a) {
  using C = Cfg<BM, WM, WN, STAGES>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  // this block's tile: the expert whose row tiles hold blockIdx.y
  int t = blockIdx.y, e = 0, start = 0, rows = 0;
  for (; e < a.n_experts; ++e) {
    const int s0 = a.offsets[e], c = a.offsets[e + 1] - s0;
    const int tiles = (c + BM - 1) / BM;
    if (t < tiles) {
      start = s0 + t * BM;
      rows = min(BM, c - t * BM);
      break;
    }
    t -= tiles;
  }
  if (e == a.n_experts) return;
  const int n0 = blockIdx.x * BN;
  const __nv_bfloat16* w = a.w + (long long)e * a.K * a.N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;

  // the A rows this thread copies, fixed over the stages
  const __nv_bfloat16* a_src[C::A_CHUNKS];
  int a_ok[C::A_CHUNKS];
#pragma unroll
  for (int i = 0; i < C::A_CHUNKS; ++i) {
    const int c = tid + i * C::THREADS, r = c / (BK / 8);
    a_ok[i] = r < rows ? 16 : 0;
    const long long src = r < rows ? (UP ? a.order[start + r] / a.topk : start + r) : 0;
    a_src[i] = a.a + src * a.K + (c % (BK / 8)) * 8;
  }
  auto load_stage = [&](int stage, int k0) {
    __nv_bfloat16* sa = smem + stage * C::STAGE_ELEMS;
    __nv_bfloat16* sb = sa + C::A_ELEMS;
#pragma unroll
    for (int i = 0; i < C::A_CHUNKS; ++i) {
      const int c = tid + i * C::THREADS;
      cp_async16(smem_u32(sa + (c / (BK / 8)) * C::A_STRIDE + (c % (BK / 8)) * 8), a_src[i] + k0, a_ok[i]);
    }
#pragma unroll
    for (int c = tid; c < BK * BN / 8; c += C::THREADS) {
      const int r = c / (BN / 8), u = c % (BN / 8);
      cp_async16(smem_u32(sb + r * C::B_STRIDE + u * 8), w + (long long)(k0 + r) * a.N + n0 + u * 8, 16);
    }
  };

  float acc[C::MT][C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < C::NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  const int KT = a.K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_stage(s, s * BK);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed for all; stage kt - 1's slot is free to refill
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_stage(nk % STAGES, nk * BK);
    cp_commit();
    const __nv_bfloat16* sa = smem + (kt % STAGES) * C::STAGE_ELEMS;
    const __nv_bfloat16* sb = sa + C::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[C::MT][4];
#pragma unroll
      for (int mt = 0; mt < C::MT; ++mt)
        ldsm_x4(af[mt], smem_u32(sa + (wm * C::TM + mt * 16 + lane % 16) * C::A_STRIDE + kk + (lane / 16) * 8));
#pragma unroll
      for (int np = 0; np < C::NT / 2; ++np) {
        uint32_t bf[4];
        ldsm_x4_t(bf, smem_u32(sb + (kk + lane % 16) * C::B_STRIDE + wn * C::TN + np * 16 + (lane / 16) * 8));
#pragma unroll
        for (int mt = 0; mt < C::MT; ++mt) {
          mma16816(acc[mt][2 * np], af[mt], bf[0], bf[1]);
          mma16816(acc[mt][2 * np + 1], af[mt], bf[2], bf[3]);
        }
      }
    }
  }
  cp_wait<0>();

  // epilogue: acc[mt][j][2 rr + i] is row wm TM + 16 mt + lane / 4 + 8 rr,
  // column n0 + wn TN + 8 j + 2 (lane % 4) + i
  const int g = lane / 4, c4 = lane % 4;
#pragma unroll
  for (int mt = 0; mt < C::MT; ++mt) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = wm * C::TM + mt * 16 + g + 8 * rr;
      if (r >= rows) continue;
      const int p = start + r;
      if constexpr (UP) {
        __nv_bfloat16* op = a.out + (long long)p * (a.N / 2) + (n0 + wn * C::TN) / 2 + 2 * c4;
#pragma unroll
        for (int q = 0; q < C::NT / 2; ++q)
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * q) =
              __floats2bfloat162_rn(swiglu(acc[mt][2 * q][2 * rr], acc[mt][2 * q + 1][2 * rr]),
                                    swiglu(acc[mt][2 * q][2 * rr + 1], acc[mt][2 * q + 1][2 * rr + 1]));
      } else {
        __nv_bfloat16* op = a.out + (long long)a.order[p] * a.N + n0 + wn * C::TN + 2 * c4;
#pragma unroll
        for (int j = 0; j < C::NT; ++j)
          *reinterpret_cast<__nv_bfloat162*>(op + 8 * j) =
              __floats2bfloat162_rn(acc[mt][j][2 * rr], acc[mt][j][2 * rr + 1]);
      }
    }
  }
}

template <int BM, int WM, int WN, int STAGES, bool UP>
int launch(const Args& a, int P, cudaStream_t stream) {
  using C = Cfg<BM, WM, WN, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(moe_kernel<BM, WM, WN, STAGES, UP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return (int)e;
  // an upper bound on the row tiles: sum over experts of ceil(rows / BM)
  const int tiles = (P + BM - 1) / BM + (P < a.n_experts ? P : a.n_experts);
  if (P == 0) return 0;
  moe_kernel<BM, WM, WN, STAGES, UP><<<dim3(a.N / BN, tiles), C::THREADS, C::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// small (decode: at most 16 tokens, so at most 16 rows an expert): one row tile an expert
template <bool UP>
int dispatch(const Args& a, int P, int small, cudaStream_t s) {
  if (a.K % BK || a.N % BN) return (int)cudaErrorInvalidValue;
  return small ? launch<16, 1, 4, 4, UP>(a, P, s) : launch<128, 2, 4, 3, UP>(a, P, s);
}

}  // namespace

// h (T, K) bf16, order (P,) int32, offsets (n + 1,) int32, w13 (n, K, N) bf16
// -> act (P, N / 2) bf16. small: every expert has at most 16 rows.
extern "C" int moe_gate_up_launch(const void* h, const void* order, const void* offsets, const void* w13,
                                  void* act, int P, int n, int K, int N, int topk, int small, void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(h), static_cast<const int*>(order),
               static_cast<const int*>(offsets), static_cast<const __nv_bfloat16*>(w13),
               static_cast<__nv_bfloat16*>(act), n, K, N, topk};
  return dispatch<true>(a, P, small, static_cast<cudaStream_t>(stream));
}

// act (P, K) bf16, order, offsets, w2 (n, K, N) bf16 -> y (P, N) bf16, row
// order[p] written from act row p.
extern "C" int moe_down_launch(const void* act, const void* order, const void* offsets, const void* w2,
                               void* y, int P, int n, int K, int N, int small, void* stream) {
  const Args a{static_cast<const __nv_bfloat16*>(act), static_cast<const int*>(order),
               static_cast<const int*>(offsets), static_cast<const __nv_bfloat16*>(w2),
               static_cast<__nv_bfloat16*>(y), n, K, N, 1};
  return dispatch<false>(a, P, small, static_cast<cudaStream_t>(stream));
}
