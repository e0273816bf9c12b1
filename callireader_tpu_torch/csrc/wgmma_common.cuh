// Hopper machinery shared by the port's tensor-core and copy-engine kernels
// (the forward attention loop of flash_common.cuh, the training backward of
// flash_attention_bwd.cu, the int8 products of int8_matmul.cu, the paged
// decode of paged_decode.cu), sm_90a: mbarriers, TMA and bulk loads, cluster
// barriers and distributed shared memory, wgmma with its shared-memory
// descriptors over swizzled 64-row tiles, and the TMA map encoder, fetched
// from libcuda at run time (no -lcuda).
#pragma once

#include <cuda.h>  // CUtensorMap; its encoder is a libcuda entry point fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cr {

constexpr int WG_ROWS = 64;      // rows of a warpgroup's accumulator tile (the wgmma M)
constexpr int WG_THREADS = 128;  // threads of a warpgroup

// A (D, S, H, B) operand: base pointer, sizes and element strides
struct Operand {
  const void* p;
  long long S, H, B;
  long long ss, sh, sb;
};

// ------------------------------------------------------------------ PTX

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// a consumer done reading a stage through the generic proxy (ld, ldmatrix)
// hands it back to the async proxy that refills it (TMA, bulk copies):
// without this fence the refill may land before the reads, seen on the H100
__device__ __forceinline__ void mbar_release_stage(uint32_t bar) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive(bar);
}

// arrive, and expect `bytes` more from TMA before the phase completes
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one TMA box of a 4-D map into shared memory, reported to `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// one TMA box of a 2-D map into shared memory, reported to `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte aligned)
// into shared memory by one bulk copy, reported to `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// every thread of every block of the cluster: writes to shared memory before
// it are seen by reads of any block after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::
                   : "memory");
}

__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the shared-memory address `addr` of this block, in block `rank` of the cluster
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The ids of rows r .. r + 63 of one batch row's ids `seg` (n = rows left,
// >= 1), two a lane of a warp; rows past the end take the first row's id
// (they are masked or weigh 0 otherwise). -> the warp's (min, max). A tile
// of keys whose range is disjoint from a query tile's holds no attended pair.
__device__ __forceinline__ int2 tile_ids(const int* seg, int n, int lane, int& s0, int& s1) {
  const int first = seg[0];
  s0 = lane < n ? seg[lane] : first;
  s1 = 32 + lane < n ? seg[32 + lane] : first;
  return make_int2(__reduce_min_sync(0xffffffffu, min(s0, s1)),
                   __reduce_max_sync(0xffffffffu, max(s0, s1)));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to an accumulator across a wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d (64 x 64, fp32) = (scale_d ? d : 0) + A B: A (64 x 16) and B (16 x 64)
// bf16 in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, fp32) += A B: A (64 x 16) bf16 in registers, in the fragment
// layout of a 64 x 16 slice of the fp32 accumulator (two bf16 a register:
// rows r and r + 8, columns 2c, 2c + 1 and 2c + 8, 2c + 9 of each quad's
// lane c), B (16 x N) bf16 in shared memory, MN-major (trans-b).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),
        "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// The fp32 accumulator d (64 x 64) as the register A fragments of four 64 x 16
// slices (k16 steps), split in two bf16 parts: hi = bf16(x), lo = bf16(x - hi).
// hi[t][e] holds d[8t + 2e], d[8t + 2e + 1], which is wgmma's A layout for
// keys 16t .. 16t + 15 (see wgmma_rs_n64).
__device__ __forceinline__ void split_bf16_frags(const float (&d)[32], uint32_t (&hi)[4][4],
                                                 uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = d[8 * t + 2 * e], x1 = d[8 * t + 2 * e + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
      hi[t][e] = *reinterpret_cast<const uint32_t*>(&h);
      lo[t][e] = *reinterpret_cast<const uint32_t*>(&l);
    }
  }
}


// ---------------------------------------------------- shared-memory tiles

// A tile of 64 rows by D bf16 columns (192: latent attention's query and key
// heads, three column blocks), stored as D / (RB / 2) column blocks
// of 64 rows of RB bytes (RB = 128, or 64 when D = 32), each with the swizzle
// of that width that TMA writes and wgmma reads: the 16-byte chunk c of row r
// sits at chunk c ^ (address bits 7..9), so a row's chunks land in distinct
// banks. Tile bases are 1024-byte aligned.
template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128 || D == 192, "head dim must be 32, 64, 128 or 192");
  static constexpr int RB = D * 2 >= 128 ? 128 : D * 2;  // bytes of a row of a column block
  static constexpr int NCB = D * 2 / RB;                 // column blocks
  static constexpr int BYTES = 64 * D * 2;
  static constexpr uint64_t MODE = RB == 128 ? 1 : 2;    // 128- or 64-byte swizzle

  // wgmma shared-memory descriptor: start address, leading byte offset 16
  // (unused by these swizzled layouts), stride byte offset = 8 rows
  static __device__ __forceinline__ uint64_t desc(uint32_t addr) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
           (static_cast<uint64_t>(8 * RB / 16) << 32) | (MODE << 62);
  }

  // K-major operand (Q as A, K as B): columns 16 t .. 16 t + 15
  static __device__ __forceinline__ uint64_t k_step(uint32_t tile, int t) {
    return desc(tile + (t * 32 / RB) * (64 * RB) + (t * 32) % RB);
  }

  // MN-major operand (V as B): rows 16 t .. 16 t + 15 of column block cb
  static __device__ __forceinline__ uint64_t mn_step(uint32_t tile, int cb, int t) {
    return desc(tile + cb * (64 * RB) + t * 16 * RB);
  }
};

// libcuda's TMA map encoder, fetched once through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a map of `x` in boxes of one column block by `rows` rows, swizzled as Tile<D>
template <int D>
inline bool encode_map(CUtensorMap* map, const Operand& x, int rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)x.S, (cuuint64_t)x.H, (cuuint64_t)x.B};
  const cuuint64_t strides[3] = {(cuuint64_t)x.ss * 2, (cuuint64_t)x.sh * 2, (cuuint64_t)x.sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)Tile<D>::RB / 2, (cuuint32_t)rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x.p), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                Tile<D>::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace cr
