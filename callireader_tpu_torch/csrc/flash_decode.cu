// Single-token GQA decode attention over the whole stacked KV cache.
//
// Replaces callireader_tpu/kernels/decode_attention.py (flash_decode).
// q (B, Hq, D) bf16; cache_k/cache_v (L, B, Hkv, S, D) bf16, read in place at
// `layer` (no per-layer slice is ever materialised); valid (B, S) int32,
// 1 = attendable; out (B, Hq, D) bf16.
//
// Bound on the H100: the bytes of the valid keys and values,
// 2 * valid * Hkv * D * 2, about 4 flops a byte: the kernel is bound by bytes
// and by how many of them are in flight. It is the paged kernel's design
// (paged_decode.cu) on the contiguous layout, where a 64-key chunk of one
// (row, KV head) is 16 KB of K rows and 16 KB of V rows, each contiguous.
// - A block owns a run of R chunks of one (row, KV head): grid (NR, Hkv, B),
//   NR = ceil(ceil(S / 64) / R). The wrapper picks R from (B, Hkv, S) alone
//   (kernels/decode_attention.py run_chunks), so that batch 1 still fills
//   the card and the same shape always sums in the same order.
// - The producer warp reads the run's validity flags, two a lane a chunk,
//   all loads issued before any is used (one round trip), and a warp ballot
//   a chunk gives its 64-bit mask; it lists the chunks holding a valid key in
//   order. A chunk with no valid key (left padding, the unwritten tail) is
//   never read for K or V. Flags are read with plain loads, which take any S
//   (a row's flags are 16-byte aligned only when S % 4 == 0). Then one lane
//   copies each live chunk's K and V rows (n * 256 bytes each, n <= 64 keys,
//   any n) by 1-D bulk copies (cp.async.bulk) into a ring of FD_STAGES
//   stages that mbarriers hand over: 96 KB a block, two blocks an SM.
// - Four consumer warps read each stage once for all G = 4 query heads
//   (decode_common.cuh's WarpSoftmax): warp w owns keys 16w .. 16w + 15 of
//   every chunk and keeps its own online softmax over them in fp32 across
//   the run. A masked key's K and V (for a ragged chunk, rows past its end,
//   which hold an earlier chunk's data) are never used. Each consumer hands
//   a stage back through mbar_release_stage (its fence.proxy.async orders
//   the generic reads before the next bulk copy into the stage).
// - At the run's end the four warps' states merge in warp order into one
//   partial per (row, query head, run) (merge_run); the second pass
//   (decode_combine) merges a row's runs in run order. The order is fixed
//   by (B, Hkv, S) alone, so the same inputs give the same bits. A row with
//   no valid key gives zeros.
#include "decode_common.cuh"
#include "wgmma_common.cuh"

namespace {

using decode::DD;
using decode::DG;
using decode::DKW;
using decode::DROW;
using decode::DWARPS;

constexpr int FD_CHUNK = 64;                      // keys of a ring stage
constexpr int FD_MAX_RUN = 8;                     // chunks a block walks at most
constexpr int FD_THREADS = (DWARPS + 1) * 32;     // the consumer warps + the producer warp
constexpr int FD_STAGES = 3;
constexpr int FD_BLOCKS = 6 / FD_STAGES;          // blocks an SM holds: 32 KB stages in 227 KB
constexpr int FD_ROWS = FD_CHUNK * DROW;          // a chunk's K (or V) bytes
constexpr int FD_STAGE = 2 * FD_ROWS;
// ring, barriers, live chunk list, per-warp scores; the warps' states at the end reuse the ring
constexpr int FD_BARS = FD_STAGES * FD_STAGE;
constexpr int FD_LIST = FD_BARS + 2 * FD_STAGES * 8;
constexpr int FD_SCORES = FD_LIST + 16 + FD_MAX_RUN * 16;
constexpr int FD_SMEM = FD_SCORES + DWARPS * DKW * 16;
static_assert(decode::MERGE_BYTES <= FD_BARS, "the warps' states go where the ring was");

struct Chunk {
  unsigned long long mask;  // bit k: key k of the chunk is valid
  int c;                    // chunk index in the row
  int n;                    // its keys
};

struct DecodeArgs {
  const __nv_bfloat16* q;
  const __nv_bfloat16* ck;
  const __nv_bfloat16* cv;
  const int* valid;
  float* part_acc;  // (B * Hq, NR, D)
  float* part_ml;   // (B * Hq, NR, 2)
  int B, Hkv, S, layer, R, NR;
  float scale_log2;
};

__global__ void __launch_bounds__(FD_THREADS, FD_BLOCKS) decode_kernel(const __grid_constant__ DecodeArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = cr::smem_u32(smem);
  auto full = [&](int st) { return base + FD_BARS + 8 * st; };
  auto empty = [&](int st) { return base + FD_BARS + 8 * (FD_STAGES + st); };
  int* n_live = reinterpret_cast<int*>(smem + FD_LIST);
  Chunk* live = reinterpret_cast<Chunk*>(smem + FD_LIST + 16);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int run = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const long long qrow0 = ((long long)b * a.Hkv + hkv) * DG;
  const long long head0 = (((long long)a.layer * a.B + b) * a.Hkv + hkv) * (long long)a.S * DD;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < FD_STAGES; ++st) {
      cr::mbar_init(full(st), 1);
      cr::mbar_init(empty(st), DWARPS * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  float qf[DG][16];  // a consumer lane's part of the prescaled q
  if (warp == DWARPS) {
    // producer: the run's live chunks, in order. Lane l reads keys l and
    // 32 + l of every chunk, all loads issued before any is used
    const int c0 = run * a.R;
    const int* vrow = a.valid + (long long)b * a.S;
    int f0[FD_MAX_RUN], f1[FD_MAX_RUN];
#pragma unroll
    for (int c = 0; c < FD_MAX_RUN; ++c) {
      const int k = (c0 + c) * FD_CHUNK + lane;
      const bool in_run = c < a.R;
      f0[c] = in_run && k < a.S ? vrow[k] : 0;
      f1[c] = in_run && k + 32 < a.S ? vrow[k + 32] : 0;
    }
    int count = 0;
#pragma unroll
    for (int c = 0; c < FD_MAX_RUN; ++c) {
      const unsigned lo = __ballot_sync(0xffffffffu, f0[c] != 0);
      const unsigned hi = __ballot_sync(0xffffffffu, f1[c] != 0);
      if ((lo | hi) == 0) continue;  // outside the row, or no valid key: never read
      if (lane == 0)
        live[count] = Chunk{lo | (static_cast<unsigned long long>(hi) << 32), c0 + c,
                            min(FD_CHUNK, a.S - (c0 + c) * FD_CHUNK)};
      ++count;
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
        const int sg = i % FD_STAGES;
        if (i >= FD_STAGES) cr::mbar_wait(empty(sg), (i / FD_STAGES - 1) & 1);
        const Chunk c = live[i];
        const uint32_t s = base + sg * FD_STAGE;
        const long long rows = head0 + (long long)c.c * FD_CHUNK * DD;
        cr::mbar_arrive_tx(full(sg), 2 * c.n * DROW);
        cr::bulk_load(s, a.ck + rows, c.n * DROW, full(sg));
        cr::bulk_load(s + FD_ROWS, a.cv + rows, c.n * DROW, full(sg));
      }
    }
    __syncwarp();
  } else {
    float4* sc = reinterpret_cast<float4*>(smem + FD_SCORES) + warp * DKW;
    const int kw0 = warp * DKW;
    st.init();
    for (int i = 0; i < count; ++i) {
      const int sg = i % FD_STAGES;
      cr::mbar_wait(full(sg), (i / FD_STAGES) & 1);
      const uint8_t* ks = smem + sg * FD_STAGE + kw0 * DROW;
      st.step(ks, ks + FD_ROWS, static_cast<unsigned>(live[i].mask >> kw0) & 0xFFFFu, qf, sc,
              lane);
      __syncwarp();
      cr::mbar_release_stage(empty(sg));
    }
    st.finish();
  }
  decode::merge_run(st, smem, a.part_acc, a.part_ml, qrow0, a.NR, run);
}

}  // namespace

extern "C" int flash_decode_chunk() { return FD_CHUNK; }
extern "C" int flash_decode_max_run() { return FD_MAX_RUN; }

// part: (B * Hq, NR, D + 2) fp32 scratch, the runs' weighted V and then their
// (max, sum); NR = ceil(ceil(S / FD_CHUNK) / R), 1 <= R <= FD_MAX_RUN.
extern "C" int flash_decode_launch(const void* q, const void* ck, const void* cv,
                                   const void* valid, void* part, void* out, int B, int Hq,
                                   int Hkv, int S, int D, int layer, int R, float scale,
                                   void* stream) {
  // Instantiated for the LLM shape of every full-width preset: D = 128, G = 4.
  auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (D != DD || Hkv <= 0 || Hq != DG * Hkv || B <= 0 || S <= 0 || layer < 0 || R < 1 ||
      R > FD_MAX_RUN || !aligned(ck) || !aligned(cv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      cudaFuncSetAttribute(decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, FD_SMEM);
  if (e == cudaSuccess)  // all of L1 as shared memory, so FD_BLOCKS blocks fit an SM
    e = cudaFuncSetAttribute(decode_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  DecodeArgs a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.ck = static_cast<const __nv_bfloat16*>(ck);
  a.cv = static_cast<const __nv_bfloat16*>(cv);
  a.valid = static_cast<const int*>(valid);
  a.B = B;
  a.Hkv = Hkv;
  a.S = S;
  a.layer = layer;
  a.R = R;
  a.NR = ((S + FD_CHUNK - 1) / FD_CHUNK + R - 1) / R;
  a.part_acc = static_cast<float*>(part);
  a.part_ml = a.part_acc + (long long)B * Hq * a.NR * DD;
  a.scale_log2 = scale * 1.4426950408889634f;
  decode_kernel<<<dim3(a.NR, Hkv, B), FD_THREADS, FD_SMEM, s>>>(a);
  decode::decode_combine<DD><<<B * Hq, DD, 0, s>>>(a.part_acc, a.part_ml,
                                                       static_cast<__nv_bfloat16*>(out), a.NR);
  return (int)cudaGetLastError();
}
