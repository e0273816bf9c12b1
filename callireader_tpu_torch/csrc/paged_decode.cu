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
// - Four consumer warps read each stage once for all G = 4 query heads. Warp
//   w owns keys 16w .. 16w + 15 of every chunk (a chunk holds a multiple of
//   16 keys) and keeps its own online softmax (max, sum, weighted V) over
//   them in fp32 across the run. q K: eight lanes a key, each 16 of the 128
//   dims (two 16-byte loads, the eight lanes of a load phase on one
//   contiguous 128-byte half row, so no bank conflict; the loads of all 16
//   keys issued first), reduced by three shuffles a key for the four heads
//   together. The chunk's max by warp shuffles, no serial loop. P V: a lane
//   owns 4 dims of all four heads and walks the warp's valid keys, four
//   keys' loads at a time (an 8-byte load a lane, one 256-byte V row a
//   warp); a masked key's V is never used.
// - At the run's end the four warps' states merge in warp order into one
//   partial (max, sum, weighted V) per (slot, query head, run); the second
//   pass (decode_common.cuh's decode_combine) merges a slot's runs in table
//   order. The order is fixed by the table alone, so the same inputs give
//   the same bits, and dead entries, wherever they point, change nothing.
//   A slot with no valid key gives zeros.
#include "decode_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int PD_D = 128;
constexpr int PD_G = 4;
constexpr int PD_RUN = 4;                         // table entries a block
constexpr int PD_CHUNK = 64;                      // keys of a ring stage
constexpr int PD_MAX_PAGE = 128;
constexpr int PD_MAXC = PD_RUN * (PD_MAX_PAGE / PD_CHUNK);  // chunks a run
constexpr int PD_WARPS = 4;                       // consumer warps, 16 keys of a chunk each
constexpr int PD_KW = PD_CHUNK / PD_WARPS;
constexpr int PD_THREADS = (PD_WARPS + 1) * 32;   // + the producer warp
constexpr int PD_STAGES = 3;
constexpr int PD_ROWS = PD_CHUNK * PD_D * 2;      // a chunk's K (or V) bytes
constexpr int PD_STAGE = 2 * PD_ROWS + PD_CHUNK * 4;
// ring, barriers, live chunk list, per-warp scores; the warps' states at the end reuse the ring
constexpr int PD_BARS = PD_STAGES * PD_STAGE;
constexpr int PD_LIST = PD_BARS + 2 * PD_STAGES * 8;
constexpr int PD_SCORES = PD_LIST + 16 + PD_MAXC * 16;
constexpr int PD_SMEM = PD_SCORES + PD_WARPS * PD_KW * 16;

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

__device__ __forceinline__ float2 bf16x2_to_f2(uint32_t w) {
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xFFFF0000u));
}

__global__ void __launch_bounds__(PD_THREADS, 2) paged_kernel(const __grid_constant__ PagedArgs a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = cr::smem_u32(smem);
  auto full = [&](int st) { return base + PD_BARS + 8 * st; };
  auto empty = [&](int st) { return base + PD_BARS + 8 * (PD_STAGES + st); };
  int* n_live = reinterpret_cast<int*>(smem + PD_LIST);
  Chunk* live = reinterpret_cast<Chunk*>(smem + PD_LIST + 16);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int run = blockIdx.x, hkv = blockIdx.y, b = blockIdx.z;
  const long long qrow0 = ((long long)b * a.Hkv + hkv) * PD_G;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < PD_STAGES; ++st) {
      cr::mbar_init(full(st), 1);
      cr::mbar_init(empty(st), PD_WARPS * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // consumer lane roles: q K lane l = lane % 8 of key quarter lane / 8 holds
  // dims 8l .. 8l + 7 and 64 + 8l .. 64 + 8l + 7 of the 4 heads, prescaled
  float qf[PD_G][16];
  if (warp == PD_WARPS) {
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
          live[count] = Chunk{(page0 * a.page + c * PD_CHUNK) * PD_D,
                              static_cast<int>((e0 + e) * a.page + c * PD_CHUNK),
                              min(PD_CHUNK, a.page - c * PD_CHUNK)};
        ++count;
      }
    }
    if (lane == 0) *n_live = count;
  } else {
    const int l = lane % 8;
    const __nv_bfloat16* qp = a.q + qrow0 * PD_D;
#pragma unroll
    for (int h = 0; h < PD_G; ++h)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qf[h][e] = __bfloat162float(qp[h * PD_D + 8 * l + e]) * a.scale_log2;
        qf[h][8 + e] = __bfloat162float(qp[h * PD_D + 64 + 8 * l + e]) * a.scale_log2;
      }
  }
  __syncthreads();
  const int count = *n_live;

  float m[PD_G], lsum[PD_G], acc[PD_G][4];
  if (warp == PD_WARPS) {
    if (lane == 0) {
      for (int i = 0; i < count; ++i) {
        const int st = i % PD_STAGES;
        if (i >= PD_STAGES) cr::mbar_wait(empty(st), (i / PD_STAGES - 1) & 1);
        const Chunk c = live[i];
        const uint32_t s = base + st * PD_STAGE;
        cr::mbar_arrive_tx(full(st), c.n * (2 * PD_D * 2 + 4));
        cr::bulk_load(s, a.kpool + c.rows, c.n * PD_D * 2, full(st));
        cr::bulk_load(s + PD_ROWS, a.vpool + c.rows, c.n * PD_D * 2, full(st));
        cr::bulk_load(s + 2 * PD_ROWS, a.valid + c.flags, c.n * 4, full(st));
      }
    }
    __syncwarp();
  } else {
    const int quarter = lane / 8, l = lane % 8;
    const bool hi4 = lane & 4, hi2 = lane & 2;
    const int hq = (hi4 ? 2 : 0) + (hi2 ? 1 : 0);  // the head a lane's reduced score is for
    float4* sc = reinterpret_cast<float4*>(smem + PD_SCORES) + warp * PD_KW;
#pragma unroll
    for (int h = 0; h < PD_G; ++h) {
      m[h] = -INFINITY;
      lsum[h] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][e] = 0.f;
    }
    for (int i = 0; i < count; ++i) {
      const int st = i % PD_STAGES;
      cr::mbar_wait(full(st), (i / PD_STAGES) & 1);
      const uint8_t* ks = smem + st * PD_STAGE;
      const uint8_t* vs = ks + PD_ROWS;
      const int* fs = reinterpret_cast<const int*>(ks + 2 * PD_ROWS);
      // a chunk holds a multiple of 16 keys: a warp has all 16 of its keys or none
      const int kw0 = warp * PD_KW;
      if (kw0 < live[i].n) {
        // q K: four keys a pass, a quarter warp each; the four passes' loads first
        uint4 kv[4][2];
#pragma unroll
        for (int p4 = 0; p4 < 4; ++p4) {
          const uint8_t* kr = ks + (kw0 + 4 * p4 + quarter) * (PD_D * 2);
          kv[p4][0] = *reinterpret_cast<const uint4*>(kr + 16 * l);
          kv[p4][1] = *reinterpret_cast<const uint4*>(kr + 128 + 16 * l);
        }
#pragma unroll
        for (int p4 = 0; p4 < 4; ++p4) {
          const uint32_t wv[8] = {kv[p4][0].x, kv[p4][0].y, kv[p4][0].z, kv[p4][0].w,
                                  kv[p4][1].x, kv[p4][1].y, kv[p4][1].z, kv[p4][1].w};
          float d[PD_G] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float2 kf = bf16x2_to_f2(wv[e]);
#pragma unroll
            for (int h = 0; h < PD_G; ++h) {
              d[h] = fmaf(qf[h][2 * e], kf.x, d[h]);
              d[h] = fmaf(qf[h][2 * e + 1], kf.y, d[h]);
            }
          }
          // over the quarter's 8 lanes: halve the heads twice, then pair up
          float a0 = hi4 ? d[2] : d[0], a1 = hi4 ? d[3] : d[1];
          a0 += __shfl_xor_sync(0xffffffffu, hi4 ? d[0] : d[2], 4);
          a1 += __shfl_xor_sync(0xffffffffu, hi4 ? d[1] : d[3], 4);
          float sr = hi2 ? a1 : a0;
          sr += __shfl_xor_sync(0xffffffffu, hi2 ? a0 : a1, 2);
          sr += __shfl_xor_sync(0xffffffffu, sr, 1);
          if ((l & 1) == 0) reinterpret_cast<float*>(sc + 4 * p4 + quarter)[hq] = sr;
        }
        __syncwarp();
        // online softmax over the warp's 16 keys: lane k < 16 has key k
        const bool ok = lane < PD_KW && fs[kw0 + lane] != 0;
        const float4 s4 = ok ? sc[lane] : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
        const float sv[PD_G] = {s4.x, s4.y, s4.z, s4.w};
        float p[PD_G];
#pragma unroll
        for (int h = 0; h < PD_G; ++h) {
          float mx = sv[h];
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          mx = __shfl_sync(0xffffffffu, mx, 0);
          const float mn = fmaxf(m[h], mx);
          const float alpha = mn == -INFINITY ? 1.f : exp2f(m[h] - mn);
          p[h] = ok ? exp2f(sv[h] - mn) : 0.f;
          lsum[h] = fmaf(lsum[h], alpha, p[h]);
          m[h] = mn;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[h][e] *= alpha;
        }
        __syncwarp();
        if (lane < PD_KW) sc[lane] = make_float4(p[0], p[1], p[2], p[3]);
        __syncwarp();
        // P V: lane owns dims 4 lane .. 4 lane + 3; four keys' loads at a time
#pragma unroll
        for (int k0 = 0; k0 < PD_KW; k0 += 4) {
          const int4 f4 = *reinterpret_cast<const int4*>(fs + kw0 + k0);
          const int fk[4] = {f4.x, f4.y, f4.z, f4.w};
          uint2 v[4];
          float4 pk[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            v[u] = *reinterpret_cast<const uint2*>(vs + (kw0 + k0 + u) * (PD_D * 2) + 8 * lane);
            pk[u] = sc[k0 + u];
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (fk[u] == 0) continue;  // a masked key's V is never used
            const float2 v01 = bf16x2_to_f2(v[u].x), v23 = bf16x2_to_f2(v[u].y);
            const float vv[4] = {v01.x, v01.y, v23.x, v23.y};
            const float pp[PD_G] = {pk[u].x, pk[u].y, pk[u].z, pk[u].w};
#pragma unroll
            for (int h = 0; h < PD_G; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[h][e] = fmaf(pp[h], vv[e], acc[h][e]);
          }
        }
      }
      __syncwarp();
      cr::mbar_release_stage(empty(st));
    }
#pragma unroll
    for (int h = 0; h < PD_G; ++h)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) lsum[h] += __shfl_xor_sync(0xffffffffu, lsum[h], o);
  }
  __syncthreads();  // the ring is free: each warp's state goes there
  float* wacc = reinterpret_cast<float*>(smem);        // (warps, G, D)
  float* wml = wacc + PD_WARPS * PD_G * PD_D;          // (warps, G, 2)
  if (warp < PD_WARPS) {
#pragma unroll
    for (int h = 0; h < PD_G; ++h) {
      *reinterpret_cast<float4*>(wacc + (warp * PD_G + h) * PD_D + 4 * lane) =
          make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
      if (lane == 0) {
        wml[(warp * PD_G + h) * 2] = m[h];
        wml[(warp * PD_G + h) * 2 + 1] = lsum[h];
      }
    }
  }
  __syncthreads();
  // merge the warps in order: thread d of head h (4 x 128 = 512 outputs)
  for (int o = threadIdx.x; o < PD_G * PD_D; o += PD_THREADS) {
    const int h = o / PD_D, d = o % PD_D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < PD_WARPS; ++w) mx = fmaxf(mx, wml[(w * PD_G + h) * 2]);
    const long long row = (qrow0 + h) * a.NR + run;
    if (mx == -INFINITY) {  // no valid key in the run: the combine skips it
      if (d == 0) {
        a.part_ml[row * 2] = -INFINITY;
        a.part_ml[row * 2 + 1] = 0.f;
      }
      continue;
    }
    float L = 0.f, s = 0.f;
#pragma unroll
    for (int w = 0; w < PD_WARPS; ++w) {
      const float mw = wml[(w * PD_G + h) * 2];
      if (mw == -INFINITY) continue;
      const float c = exp2f(mw - mx);
      L = fmaf(wml[(w * PD_G + h) * 2 + 1], c, L);
      s = fmaf(wacc[(w * PD_G + h) * PD_D + d], c, s);
    }
    a.part_acc[row * PD_D + d] = s;
    if (d == 0) {
      a.part_ml[row * 2] = mx;
      a.part_ml[row * 2 + 1] = L;
    }
  }
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
  if (D != PD_D || Hkv <= 0 || Hq != PD_G * Hkv || page <= 0 || page > PD_MAX_PAGE || page % 16 ||
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
  decode::decode_combine<PD_D><<<B * Hq, PD_D, 0, s>>>(static_cast<const float*>(part_acc),
                                                       static_cast<const float*>(part_ml),
                                                       static_cast<__nv_bfloat16*>(out), a.NR);
  return (int)cudaGetLastError();
}
