// Single-token GQA decode attention of every slot over its own pages of a
// global page pool.
//
// Replaces callireader_tpu/kernels/paged_decode.py (paged_flash_decode).
// q (B, Hq, D) bf16; kpool/vpool (L, NPAGES, Hkv, page, D) bf16, read in place
// at `layer`; page_table (B, P) int32, the pool page of each of a slot's P
// entries; valid (B, P, page) int32, 1 = attendable; out (B, Hq, D) bf16.
//
// Bound on the H100: the bytes of the live keys and values,
// 2 * live * Hkv * D * 2, about 4 flops a byte (2 G D for each K row and each
// V row), far below the CUDA cores' ~20 fp32 flops a byte: the kernel is
// bound by bytes and by how many of them are in flight.
// - A block owns a run of PD_RUN table entries of one (slot, KV head): grid
//   (ceil(P / PD_RUN), Hkv, B). Blocks whose run holds no live key end at
//   once and the hardware hands their SMs the next blocks, so the live pages
//   spread over the card whatever the mask. A chunk is up to 64 keys of one
//   page (two a page at page 128).
// - The producer warp first reads the run's page ids and validity, all in
//   one round trip (a warp ballot a chunk), and lists the live chunks in
//   table order: an entry
//   outside the pool or a chunk with no valid key is never read for K or V,
//   nor is its address formed. Then one lane copies each live chunk's K
//   rows, V rows and flags (16 KB, 16 KB and 256 bytes at D = 128, each
//   contiguous in the pool) by 1-D bulk copies (cp.async.bulk) into a ring
//   of PD_STAGES stages that mbarriers hand over: ~100 KB a block, two
//   blocks an SM, up to six chunks in flight an SM.
// - Four consumer warps read each stage once for all G = 4 query heads
//   (decode_common.cuh's WarpSoftmax): warp w owns keys 16w .. 16w + 15 of
//   every chunk (a chunk holds a multiple of 16 keys) and keeps its own
//   online softmax over them in fp32 across the run; a masked key's V is
//   never used.
// - At the run's end the four warps' states merge in warp order into one
//   partial (max, sum, weighted V) per (slot, query head, run) (merge_run);
//   the second pass (decode_combine) merges a slot's runs in table order.
//   The order is fixed by the table alone, so the same inputs give the same
//   bits, and dead entries, wherever they point, change nothing. A slot
//   with no valid key gives zeros.
#include "decode_common.cuh"
#include "wgmma_common.cuh"

namespace {

using decode::DD;
using decode::DG;
using decode::DKW;
using decode::DROW;
using decode::DWARPS;

constexpr int PD_RUN = 4;                         // table entries a block
constexpr int PD_CHUNK = 64;                      // keys of a ring stage
constexpr int PD_MAX_PAGE = 128;
constexpr int PD_MAXC = PD_RUN * (PD_MAX_PAGE / PD_CHUNK);  // chunks a run
constexpr int PD_THREADS = (DWARPS + 1) * 32;     // the consumer warps + the producer warp
constexpr int PD_STAGES = 3;
constexpr int PD_ROWS = PD_CHUNK * DROW;          // a chunk's K (or V) bytes
constexpr int PD_STAGE = 2 * PD_ROWS + PD_CHUNK * 4;
// ring, barriers, live chunk list, per-warp scores; the warps' states at the end reuse the ring
constexpr int PD_BARS = PD_STAGES * PD_STAGE;
constexpr int PD_LIST = PD_BARS + 2 * PD_STAGES * 8;
constexpr int PD_SCORES = PD_LIST + 16 + PD_MAXC * 16;
constexpr int PD_SMEM = PD_SCORES + DWARPS * DKW * 16;
static_assert(decode::MERGE_BYTES <= PD_BARS, "the warps' states go where the ring was");

struct Chunk {
  long long rows;  // pool element of the chunk's first key row
  int flags;       // its first validity flag
  int n;           // its keys
};

struct PagedArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* kpool;
  const __nv_bfloat16* vpool;
  const int* table;
  const int* valid;
  float* part_acc;  // (B * Hq, NR, D)
  float* part_ml;   // (B * Hq, NR, 2)
  int Hkv, P, page, NPAGES, layer, NR;
  float scale_log2;
};

__global__ void __launch_bounds__(PD_THREADS, 2) paged_kernel(const __grid_constant__ PagedArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = cr::smem_u32(smem);
  auto full = [&](int st) { return base + PD_BARS + 8 * st; };
  auto empty = [&](int st) { return base + PD_BARS + 8 * (PD_STAGES + st); };
  int* n_live = reinterpret_cast<int*>(smem + PD_LIST);
  Chunk* live = reinterpret_cast<Chunk*>(smem + PD_LIST + 16);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int run = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const long long qrow0 = ((long long)b * a.Hkv + hkv) * DG;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < PD_STAGES; ++st) {
      cr::mbar_init(full(st), 1);
      cr::mbar_init(empty(st), DWARPS * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  float qf[DG][16];  // a consumer lane's part of the prescaled q
  if (warp == DWARPS) {
    // producer: the live chunks of the run, in table order. Every load of
    // the run (its page ids, and 4 flags a lane of each entry) is issued
    // before any is used: one memory latency, not one an entry
    const long long e0 = (long long)b * a.P + run * PD_RUN;
    const int ne = min(PD_RUN, a.P - run * PD_RUN);
    const int pid_l = lane < ne ? a.table[e0 + lane] : -1;
    int4 fl[PD_RUN];
#pragma unroll
    for (int e = 0; e < PD_RUN; ++e)
      fl[e] = e < ne && 4 * lane < a.page
                  ? *reinterpret_cast<const int4*>(a.valid + (e0 + e) * a.page + 4 * lane)
                  : make_int4(0, 0, 0, 0);
    int count = 0;
#pragma unroll
    for (int e = 0; e < PD_RUN; ++e) {
      const int pid = __shfl_sync(0xffffffffu, pid_l, e);
      // lanes 16c .. 16c + 15 hold chunk c's flags
      const unsigned any = __ballot_sync(0xffffffffu, (fl[e].x | fl[e].y | fl[e].z | fl[e].w) != 0);
      if (pid < 0 || pid >= a.NPAGES) continue;  // outside the pool (or past the table): dead
#pragma unroll
      for (int c = 0; c < PD_MAX_PAGE / PD_CHUNK; ++c) {
        if (c * PD_CHUNK >= a.page || ((any >> (16 * c)) & 0xFFFFu) == 0) continue;
        const long long page0 = ((long long)a.layer * a.NPAGES + pid) * a.Hkv + hkv;
        if (lane == 0)
          live[count] = Chunk{(page0 * a.page + c * PD_CHUNK) * DD,
                              static_cast<int>((e0 + e) * a.page + c * PD_CHUNK),
                              min(PD_CHUNK, a.page - c * PD_CHUNK)};
        ++count;
      }
    }
    if (lane == 0) *n_live = count;
  } else {
    decode::load_q(a.q + qrow0 * DD, a.scale_log2, lane, qf);
  }
  __syncthreads();
  const int count = *n_live;

  decode::WarpSoftmax st;
  if (warp == DWARPS) {
    if (lane == 0) {
      for (int i = 0; i < count; ++i) {
        const int sg = i % PD_STAGES;
        if (i >= PD_STAGES) cr::mbar_wait(empty(sg), (i / PD_STAGES - 1) & 1);
        const Chunk c = live[i];
        const uint32_t s = base + sg * PD_STAGE;
        cr::mbar_arrive_tx(full(sg), c.n * (2 * DROW + 4));
        cr::bulk_load(s, a.kpool + c.rows, c.n * DROW, full(sg));
        cr::bulk_load(s + PD_ROWS, a.vpool + c.rows, c.n * DROW, full(sg));
        cr::bulk_load(s + 2 * PD_ROWS, a.valid + c.flags, c.n * 4, full(sg));
      }
    }
    __syncwarp();
  } else {
    float4* sc = reinterpret_cast<float4*>(smem + PD_SCORES) + warp * DKW;
    const int kw0 = warp * DKW;
    st.init();
    for (int i = 0; i < count; ++i) {
      const int sg = i % PD_STAGES;
      cr::mbar_wait(full(sg), (i / PD_STAGES) & 1);
      const uint8_t* ks = smem + sg * PD_STAGE;
      const int* fs = reinterpret_cast<const int*>(ks + 2 * PD_ROWS);
      // a chunk holds a multiple of 16 keys: a warp has all 16 of its keys or none
      const unsigned bits =
          kw0 < live[i].n ? __ballot_sync(0xffffffffu, lane < DKW && fs[kw0 + lane] != 0) & 0xFFFFu
                          : 0u;
      st.step(ks + kw0 * DROW, ks + PD_ROWS + kw0 * DROW, bits, qf, sc, lane);
      __syncwarp();
      cr::mbar_release_stage(empty(sg));
    }
    st.finish();
  }
  decode::merge_run(st, smem, a.part_acc, a.part_ml, qrow0, a.NR, run);
}

}  // namespace

extern "C" int paged_decode_run() { return PD_RUN; }

// part_acc (B * Hq, NR, D) and part_ml (B * Hq, NR, 2) fp32 scratch, NR =
// ceil(P / PD_RUN).
extern "C" int paged_decode_launch(const void* q, const void* kpool, const void* vpool,
                                   const void* page_table, const void* valid, void* part_acc,
                                   void* part_ml, void* out, int B, int Hq, int Hkv, int P,
                                   int page, int NPAGES, int D, int layer, float scale,
                                   void* stream) {
  // Instantiated for the LLM shape of every full-width preset: D = 128, G = 4.
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (D != DD || Hkv <= 0 || Hq != DG * Hkv || page <= 0 || page > PD_MAX_PAGE || page % 16 ||
      B <= 0 || P <= 0 || !aligned(valid) || !aligned(kpool) || !aligned(vpool))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      cudaFuncSetAttribute(paged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, PD_SMEM);
  if (e == cudaSuccess)  // all of L1 as shared memory, so two blocks fit an SM
    e = cudaFuncSetAttribute(paged_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  PagedArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.kpool = static_cast<const __nv_bfloat16*>(kpool);
  a.vpool = static_cast<const __nv_bfloat16*>(vpool);
  a.table = static_cast<const int*>(page_table);
  a.valid = static_cast<const int*>(valid);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.Hkv = Hkv;
  a.P = P;
  a.page = page;
  a.NPAGES = NPAGES;
  a.layer = layer;
  a.NR = (P + PD_RUN - 1) / PD_RUN;
  a.scale_log2 = scale * 1.4426950408889634f;
  paged_kernel<<<dim3(a.NR, Hkv, B), PD_THREADS, PD_SMEM, s>>>(a);
  decode::decode_combine<DD><<<B * Hq, DD, 0, s>>>(static_cast<const float*>(part_acc),
                                                       static_cast<const float*>(part_ml),
                                                       static_cast<__nv_bfloat16*>(out), a.NR);
  return (int)cudaGetLastError();
}
