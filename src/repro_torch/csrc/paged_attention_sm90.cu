// Paged decode attention for Hopper (sm_90a), float32, bfloat16 or float16
// pools:
// pages split across blocks (flash-decoding), the query rows of a kv head
// in tiles, pages fed to a shared-memory ring by bulk TMA copies (or by the
// producer warp's own loads where a bulk copy cannot read the pool).
//
// Replaces src/repro/kernels/paged_attention/kernel.py::paged_attention (the
// Pallas TPU kernel, body `_kernel`) for every shape the wrapper accepts:
// any batch, any g = Hq / Hkv, any number of kv heads, any head dim d, any
// page size, any row width in bytes and any pool base address. Three
// routes (the C entry's tile_rows picks one, ops.group_tile_rows):
//   - the mma route (paged_attention_sm90_mma_kernel, further down) for g
//     >= 8 at d <= 256: every query row of a kv head in one block, the
//     products on the tensor cores;
//   - the register route below for the other shapes up to d = 2048 (a row
//     of q in a lane group's registers, the products on the CUDA cores);
//   - the wide route (paged_attention_sm90_wide_kernel) past d = 2048: d
//     split across the CTAs of a thread-block cluster, the scores summed
//     over distributed shared memory.
// Same function and conventions as that kernel and as ref.py:
//
//   q          (B, Hq, d)            out (B, Hq, d), same dtype as q
//   k/v pages  (P, Hkv, page, d)     page_table (B, n_slots) int32
//   lengths    (B,) int32            g = Hq / Hkv query rows per kv head
//
// Scores are scaled by 1/sqrt(d), then an optional tanh softcap; keys at
// positions >= length do not count; the softmax is float32; the output is
// acc / max(l, 1e-30), so a sequence of length 0 gets zeros. Slots that
// start at or past the length are never read, so their page ids may be
// garbage. A page id outside [0, P) inside the length makes that (b,
// kv-head) output NaN.
//
// Bound: the K and V bytes of the live pages; the arithmetic is 4 g d flops
// per key against 2 d elt bytes. For small g that is far below the memory
// line of the CUDA cores (67 TFLOP/s over 3.35 TB/s, 20 flop/byte), and
// what counts is bytes in flight on every SM: the register route. Past it
// (g = 12 in 2-byte types is 12 flop/byte, MQA's g = 48-71 is 48-71) the
// CUDA cores' chain of shuffles and exps set the pace, and the mma route
// takes the products to the tensor cores, whose ridge (295 flop/byte in
// bf16) leaves the bytes the bound.
//
// The register route:
//
// * Group tiles. A block holds G query rows of one kv head in registers
//   (G = ops.tile_rows: the power of two >= g up to 8, halved while a
//   lane's floats of q, G * NVL * VEC, would pass 64), and the g rows are
//   ceil(g / G) tiles, the last one partial where G does not divide g (g =
//   71: eight tiles of 8 and one of 7). The tile is the fastest-varying
//   block index, so the tiles of one (b, kv head, split) are resident
//   together and read the same pages, the first from device memory and the
//   others from L2.
// * Grid. Every block index lies in the grid's x dimension (2^31 - 1
//   blocks; y and z hold 65,535, fewer than the sequences or kv heads a
//   call may have): x = tile + n_tiles * (split + n_split * (kv head + Hkv *
//   b)), ops.paged_block.
// * Split (flash-decoding). A block walks the run of `pps` slots [split * pps, (split + 1) * pps) up
//   to the length. ops._pages_per_split picks pps on the host from B, the
//   kv heads times the tiles, n_slots and the SM count, never from
//   lengths. A block whose run starts at or past the length exits at once
//   and writes nothing. With one split the block writes its rows of the
//   output; with more, each block writes its float32 partial (acc[d], m,
//   l) per query row to a workspace (B, Hq, n_split, d + 2), and a second
//   kernel merges the live splits (those whose run starts below the
//   length, which it recomputes from `lengths`) by the log-sum-exp rule.
//   No live split: 0. A split that met a bad id writes m = NaN, and the
//   merge gives NaN.
// * Staging. A ring stage holds R rows of K and R rows of V: a whole page
//   where it is at most 32 KiB, else R = 32 KiB / row (a page of 512 keys
//   at d = 128 in float32 is 8 stages); only the live rows of a page are
//   staged. For one (page id, kv head) the rows are contiguous, so where
//   both pool bases and the row width are multiples of 16 bytes a stage
//   is one cp.async.bulk per tensor, issued by lane 0 of a producer warp;
//   otherwise (24-byte rows, a pool 4 bytes off alignment) the producer
//   warp's 32 lanes fill the stage with 2-byte loads, each row padded with
//   zeros to a multiple of 16 bytes. Each stage has a full mbarrier (lane
//   0's arrival, after the warp's loads or with the bulk copies' bytes)
//   and an empty one (one arrival per consumer warp). The producer reads
//   the page ids of the live slots only (32 at a time, one per lane). A
//   bad id is passed down the ring as a flag instead of rows, and the
//   producer stops there. The ring holds about 32 KiB (2 stages at the
//   serving page of 16 keys, d = 128, float32): what keeps bytes in
//   flight is the number of blocks resident on an SM, and a deeper ring
//   costs blocks (at the serving shape 3 and 4 stages ran slower than 2 on
//   the H100).
// * No block barrier in the page loop. Each of four consumer warps takes
//   every fourth step of a stage, a step being kpw consecutive keys, one
//   per group of lpk lanes; a lane holds NVL 16-byte vectors of the
//   pre-scaled q rows in registers (NVL = pick_nvl; d = 2048 is 16 vectors
//   a lane in float32), reads the same vectors of its key's K row from
//   shared memory, and the group's shuffles reduce the score. Per chunk of
//   up to 4 steps (2 at G = 8, for registers) and query row: one max across
//   the warp, one rescale of the accumulator, one exp per key; then p . V
//   from the same lanes, each lane owning its vectors of d. A warp keeps its
//   own running max; at the end the lane groups' sums add by shuffles and
//   the warps merge through the (now free) ring, G rows of d floats per
//   warp. float32 throughout, the scores in log2 units (q pre-scaled by
//   log2(e) / sqrt(d), exp2 for exp); only the order of the sums and that
//   rounding differ from ref.py. The consumers' time per stage is a chain
//   of latencies (shared loads, shuffles, exp), so warps that waited on
//   each other at every stage would set the pace instead of the copies.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kConsumerWarps = 4;
constexpr int kConsumers = kConsumerWarps * 32;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kMaxStages = 4;
constexpr int kRingBytes = 32768;          // ring size aimed at, >= 2 stages
constexpr int kMaxTile = 32768;            // one stage's rows of K (or V)
constexpr int kMaxRows = 8;                // query rows of a group tile
constexpr int kMaxLaneFloats = 64;         // G * NVL * VEC: q's registers
constexpr int kSmemBudget = 232448;        // a block's shared memory on H100
constexpr int kRingOff = 384;              // barriers, flags, warps' m and l
constexpr int kWideThreads = 256;          // the wide route's block: 8 warps
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideCols = 2048;            // its columns of d per CTA
constexpr int kWideKeys = 32;              // its keys per chunk, one a lane
constexpr int kMaxCluster = 8;             // its CTAs a cluster (portable)
constexpr int kWideCombineCols = 1024;     // its combine's columns a block
constexpr int kMmaMinGroup = 8;            // the mma route: g >= 8 ...
constexpr int kMmaMaxD = 256;              // ... at d <= 256
constexpr int kMmaMaxRows = 64;            // its query rows of a row tile
constexpr int kMmaMaxStages = 8;           // its ring: up to 8 stages of
constexpr int kMmaRingBytes = 65536;       // about 64 KiB in all

// At most 128 bytes: on the H100 a larger struct (the same fields and five
// more ints) gave other register allocations and ran the serving and bench
// shapes 1.5-4.5% slower. What derives from d is computed in the kernel.
struct Params {
  const void* q;
  const unsigned char* k;
  const unsigned char* v;
  const int* page_table;
  const int* lengths;
  void* out;
  float* ws;
  int Hkv, g, d, page, n_slots, P, pps, n_split, n_tiles;
  int rows_per_stage, bulk;
  int stages, tile_stride, stage_bytes;
  float scale;   // 1/sqrt(d) * log2(e): scores in log2 units
  float cap_in;  // softcap c: ln(2) / c; 0: none
};

// One launch's shape plan, or false where the shape is not taken.
struct Plan {
  int nvl, row_stride, rows_per_stage, stages, tile_stride, stage_bytes,
      smem;
  int mw, dinst;  // the mma route: m16 tiles a warp, head dims of its instance
};

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

inline int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Vectors per lane for G rows and nv 16-byte vectors per row: as many as
// keep q's registers at 32 floats, and enough for 32 lanes to cover a row.
int pick_nvl(int G, int vec, int nv) {
  int nvl = 4;
  while (nvl > 1 && G * nvl * vec > 32) nvl /= 2;
  while (nvl * 32 < nv) nvl *= 2;
  return nvl;
}

// Whether head dim d at elt bytes per element takes the wide route: one
// query row's 16-byte vectors, spread over 32 lanes, pass a lane's 64 floats
// (d > 2048 in every type). make_plan refuses exactly these at G = 1.
bool wide_route(int d, int elt) {
  const int nv = (d * elt + 15) / 16;
  return pow2_at_least((nv + 31) / 32) * (16 / elt) > kMaxLaneFloats;
}

// The ring for rows of d elements of elt bytes and pages of `page` keys: a
// stage holds R keys of K and R of V (a whole page up to 32 KiB of each),
// 2 to max_stages stages of about ring_bytes in all.
void ring_plan(int d, int page, int elt, int ring_bytes, int max_stages,
               Plan* pl) {
  pl->row_stride = round_up(d * elt, 16);
  pl->rows_per_stage = kMaxTile / pl->row_stride;  // >= 4: rows <= 8 KiB
  if (pl->rows_per_stage > page) pl->rows_per_stage = page;
  if (pl->rows_per_stage < 1) pl->rows_per_stage = 1;
  pl->tile_stride = round_up(pl->rows_per_stage * pl->row_stride, 128);
  pl->stage_bytes = 2 * pl->tile_stride;
  pl->stages = ring_bytes / pl->stage_bytes;
  if (pl->stages > max_stages) pl->stages = max_stages;
  if (pl->stages < 2) pl->stages = 2;
}

// G query rows per tile (a power of two up to 8 whose q fits a lane's 64
// floats; ops.tile_rows chooses it), head dim d, elt bytes per element.
bool make_plan(int G, int d, int page, int elt, Plan* pl) {
  if (G < 1 || G > kMaxRows || (G & (G - 1)) || d < 1 || page < 1 ||
      (elt != 2 && elt != 4))
    return false;
  const int vec = 16 / elt, row = d * elt, nv = (row + 15) / 16;
  if (G * pow2_at_least((nv + 31) / 32) * vec > kMaxLaneFloats) return false;
  pl->nvl = pick_nvl(G, vec, nv);
  ring_plan(d, page, elt, kRingBytes, kMaxStages, pl);
  const int ring = pl->stages * pl->stage_bytes;
  const int red = kConsumerWarps * G * nv * vec * 4;  // the warps' sums
  pl->smem = kRingOff + (ring > red ? ring : red);
  return pl->smem <= kSmemBudget;
}

// Whether g query rows per kv head at head dim d take the mma route
// (ops.mma_route; every type, elt is there for the rule's signature): g >=
// 9, and g = 8, where it ran 1.5x (float32) and 3.0x (bfloat16, float16)
// faster than the register route on the H100 at 64/8, d = 128, in turns.
bool mma_route(int g, int d, int elt) {
  return elt > 0 && g >= kMmaMinGroup && d >= 1 && d <= kMmaMaxD;
}

// Query rows of the mma route's row tile for g rows per kv head: g rounded
// up to whole m16 tiles, at most kMmaMaxRows (g = 71: a tile of 64 and one
// of 7).
int mma_tile_rows(int g) {
  const int r = round_up(g, 16);
  return r < kMmaMaxRows ? r : kMmaMaxRows;
}

// m16 tiles a warp holds (2 where d <= 128 and the tile has 32 rows or
// more: a K or V fragment then feeds two products) and the head dim of the
// instance (64, 128 or 256) for a row tile of `rows` at head dim d.
void mma_shape(int rows, int d, int* mw, int* dinst) {
  *dinst = d <= 64 ? 64 : d <= 128 ? 128 : 256;
  *mw = *dinst <= 128 && rows >= 32 ? 2 : 1;
}

// Row groups of a tile of `rows` live rows: ceil(rows / (16 mw)) rounded up
// to 1, 2 or 4; the 4 consumer warps are row groups x key groups.
__host__ __device__ inline int mma_row_groups(int rows, int mw) {
  const int n = ((rows + 15) / 16 + mw - 1) / mw;
  return n > 2 ? 4 : n;
}

// The mma route's plan: the ring as the register route's, q's rows of the
// tile in shared memory after it (float32 as TF32 hi and lo), and at the end
// the warps' m, l and accumulators where the ring and q were.
bool make_mma_plan(int rows, int g, int d, int page, int elt, Plan* pl) {
  if (g < 1 || d < 1 || d > kMmaMaxD || page < 1 || (elt != 2 && elt != 4) ||
      rows != mma_tile_rows(g))
    return false;
  mma_shape(rows, d, &pl->mw, &pl->dinst);
  pl->nvl = 0;
  ring_plan(d, page, elt, kMmaRingBytes, kMmaMaxStages, pl);
  const int ks = elt == 4 ? 8 : 16;                   // the mma's depth
  const int qs = round_up(d, ks) + (elt == 4 ? 4 : 8);  // q's row stride
  const int rows_p = mma_row_groups(rows, pl->mw) * 16 * pl->mw;
  const int q_bytes = rows_p * qs * elt * (elt == 4 ? 2 : 1);
  const int ring = pl->stages * pl->stage_bytes + q_bytes;
  const int red = 2 * kConsumerWarps * 32 * 4 +
                  kConsumerWarps * 16 * pl->mw * round_up(d, 8) * 4;
  pl->smem = kRingOff + (ring > red ? ring : red);
  return pl->smem <= kSmemBudget;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// 16 bytes of T from shared memory, as floats.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* f) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x;
    f[1] = x.y;
    f[2] = x.z;
    f[3] = x.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* f) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};
template <>
struct Vec<__half> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const unsigned char* p,
                                              float* f) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __half22float2(h[i]);
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::
          "r"(bar)
      : "memory");
}

// Spins on try_wait; a wait that never ends (a fault in the ring's
// bookkeeping) traps after ~2^28 tries instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One contiguous run of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// nr rows of row_bytes each from global memory (contiguous, 2-byte
// aligned, as every float32, bfloat16 or float16 pool is) into shared
// memory rows of row_stride bytes, the padding zeroed; the producer warp's
// 32 lanes, 2 bytes at a time.
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const unsigned char* src, int nr,
                                          int row_bytes, int row_stride,
                                          int lane) {
  const int live = row_bytes / 2, per_row = row_stride / 2;
  const uint16_t* s = reinterpret_cast<const uint16_t*>(src);
  uint16_t* t = reinterpret_cast<uint16_t*>(dst);
  for (int idx = lane; idx < nr * per_row; idx += 32) {
    const int r = idx / per_row, u = idx - r * per_row;
    t[idx] = u < live ? s[r * live + u] : uint16_t(0);
  }
}

// The four consumer warps only (the producer warp has left).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// The producer warp: the page ids of the live slots (32 at a time, one per
// lane), then the live rows of each page, R at a time, one stage each. Lane
// 0 waits for the stage, issues its bulk copies and arrives; where the lanes
// fill it with their own loads, all of them wait first and lane 0 arrives
// after them. A bad id goes down the ring as a flag instead of rows, and
// the producer stops there. Both routes that stage pages use it.
template <typename T>
__device__ __forceinline__ void produce(const Params& p, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty,
                                        int* stage_bad, int b, int h,
                                        int slot0, int n_pages, int n_keys,
                                        int lane) {
  const int d = p.d, page = p.page, R = p.rows_per_stage;
  const int* pt = p.page_table + (size_t)b * p.n_slots + slot0;
  const bool narrow = !p.bulk;
  const int row_bytes = d * (int)sizeof(T);
  const int row_stride = (row_bytes + 15) & ~15;  // a row in the ring
  int s = 0, round = 0;  // the ring's next stage and how often it wrapped
  for (int i0 = 0; i0 < n_pages; i0 += 32) {
    const int mine = i0 + lane < n_pages ? pt[i0 + lane] : 0;
    const int n = min(32, n_pages - i0);
    for (int j = 0; j < n; ++j) {
      const int pid = __shfl_sync(0xffffffffu, mine, j);
      const bool bad = pid < 0 || pid >= p.P;  // the same for every lane
      const int t_end = min(page, n_keys - (slot0 + i0 + j) * page);
      const size_t first = ((size_t)pid * p.Hkv + h) * page;  // its row
      for (int r0 = 0; r0 < t_end; r0 += R) {
        if (round > 0 && (lane == 0 || (narrow && !bad)))
          mbar_wait(smem_u32(&empty[s]), (round - 1) & 1);
        const int nr = min(R, t_end - r0);
        const size_t off = (first + r0) * row_bytes;
        unsigned char* kt = ring + s * p.stage_bytes;
        if (narrow && !bad) {
          load_rows(kt, p.k + off, nr, row_bytes, row_stride, lane);
          load_rows(kt + p.tile_stride, p.v + off, nr, row_bytes,
                    row_stride, lane);
          __threadfence_block();
          __syncwarp();  // every lane's stores before lane 0's arrival
        }
        if (lane == 0) {
          const uint32_t fb = smem_u32(&full[s]);
          stage_bad[s] = bad;
          if (bad || narrow) {
            mbar_arrive(fb);
          } else {
            const uint32_t bytes = nr * row_bytes;
            mbar_expect_tx(fb, 2 * bytes);
            bulk_load(smem_u32(kt), p.k + off, bytes, fb);
            bulk_load(smem_u32(kt + p.tile_stride), p.v + off, bytes, fb);
          }
        }
        if (bad) return;
        if (++s == p.stages) {
          s = 0;
          ++round;
        }
      }
    }
  }
}

// G: query rows of a tile. NVL: 16-byte vectors of a row per lane; a
// group of lpk = pow2 >= ceil(nv / NVL) lanes holds one key's row, so a
// warp covers kpw = 32 / lpk keys per step. One block per SM is all the
// launch bound asks for, so ptxas gives every instance the registers it
// needs (no spills; without it, it held some at 72 or 128 and spilled).
template <typename T, int G, int NVL>
__global__ void __launch_bounds__(kThreads, 1)
paged_attention_sm90_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int VEC = Vec<T>::N;
  // steps per max and rescale: 4 (a warp's whole share of a serving page),
  // fewer where G query rows of scores would crowd the registers
  constexpr int kChunk = G <= 4 ? 4 : 2;
  // x = tile + n_tiles * (split + n_split * (h + Hkv * b)); no division
  // by the tiles where the group is one tile
  unsigned x = blockIdx.x;
  int tile = 0;
  if (p.n_tiles > 1) {
    const unsigned xt = x / (unsigned)p.n_tiles;
    tile = (int)(x - xt * (unsigned)p.n_tiles);
    x = xt;
  }
  const unsigned xs = x / (unsigned)p.n_split;
  const int split = (int)(x - xs * (unsigned)p.n_split);
  const int h = (int)(xs % (unsigned)p.Hkv), b = (int)(xs / (unsigned)p.Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d = p.d, page = p.page, R = p.rows_per_stage;
  const int rows = min(G, p.g - tile * G);  // query rows of this tile
  const int n_keys = min(max(p.lengths[b], 0), p.n_slots * page);
  const int slot0 = split * p.pps;
  const int n_pages = min(p.pps, (n_keys + page - 1) / page - slot0);
  // the tile's first q row
  const size_t row0 = ((size_t)b * p.Hkv + h) * p.g + (size_t)tile * G;
  T* out = static_cast<T*>(p.out);
  if (n_pages <= 0) {  // the run starts at or past the length
    if (p.n_split == 1)
      for (int i = tid; i < rows * d; i += kThreads)
        out[row0 * d + i] = from_f32<T>(0.f);
    return;
  }

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  int* stage_bad = reinterpret_cast<int*>(smem + 16 * kMaxStages);
  float* m_sm = reinterpret_cast<float*>(smem + 128);  // [warp][8]
  float* l_sm = m_sm + kConsumerWarps * 8;             // [warp][8]
  unsigned char* ring = smem + kRingOff;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    produce<T>(p, ring, full, empty, stage_bad, b, h, slot0, n_pages, n_keys,
               lane);
    return;
  }

  // Consumers. Warp w takes the steps w, w + 4, ... of every stage, a step
  // being kpw consecutive keys, one per lane group; it keeps its own
  // running max (the same in all its lanes), and each lane its partial sum
  // and its slice of the accumulator for the keys of its group.
  const int nv = (d * (int)sizeof(T) + 15) / 16;  // 16-byte vectors per row
  const int rs = nv * 16;  // a row in shared memory (row_stride)
  int lpk = 1;
  while (lpk * NVL < nv && lpk < 32) lpk <<= 1;
  const int kpw = 32 / lpk, lig = lane % lpk, kig = lane / lpk;
  const int kpw_log2 = __ffs(kpw) - 1;

  float qr[G][NVL][VEC], acc[G][NVL][VEC], m[G], l[G];
  const T* q = static_cast<const T*>(p.q);
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int i = 0; i < NVL; ++i) {
      const int j = lig + lpk * i;
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[gi][i][c] = 0.f;
      if (nv * 16 == d * (int)sizeof(T)) {  // whole vectors: no element mask
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          qr[gi][i][c] =
              gi < rows && j < nv
                  ? to_f32(q[(row0 + gi) * d + j * VEC + c]) * p.scale
                  : 0.f;
      } else {
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          qr[gi][i][c] =
              gi < rows && j < nv && j * VEC + c < d
                  ? to_f32(q[(row0 + gi) * d + j * VEC + c]) * p.scale
                  : 0.f;
      }
    }
  }

  bool bad = false;
  int s = 0;
  uint32_t phase = 0;  // of the full barriers in this round of the ring
  for (int i = 0; i < n_pages && !bad; ++i) {
    const int t_end = min(page, n_keys - (slot0 + i) * page);
    for (int r0 = 0; r0 < t_end; r0 += R) {
      mbar_wait(smem_u32(&full[s]), phase);
      if (stage_bad[s]) {  // the same for every consumer; nothing follows
        bad = true;
        break;
      }
      const unsigned char* kt = ring + s * p.stage_bytes;
      const unsigned char* vt = kt + p.tile_stride;
      const int nr = min(R, t_end - r0);  // keys in this stage
      const int n_steps = (nr + kpw - 1) >> kpw_log2;
      // chunks of kChunk steps: one max and one rescale per chunk per row
      // (one per stage where the warp has at most kChunk steps of it)
      for (int c0 = warp; c0 < n_steps; c0 += kConsumerWarps * kChunk) {
        float sc[kChunk][G];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int st = c0 + kConsumerWarps * c;  // warp-uniform
          const int t = st * kpw + kig;
#pragma unroll
          for (int gi = 0; gi < G; ++gi) sc[c][gi] = -INFINITY;
          if (st < n_steps) {
            float part[G];
#pragma unroll
            for (int gi = 0; gi < G; ++gi) part[gi] = 0.f;
            if (t < nr) {
#pragma unroll
              for (int i2 = 0; i2 < NVL; ++i2) {
                const int j = lig + lpk * i2;
                if (j < nv) {
                  float kv[VEC];
                  Vec<T>::load(kt + t * rs + j * 16, kv);
#pragma unroll
                  for (int gi = 0; gi < G; ++gi)
#pragma unroll
                    for (int e = 0; e < VEC; ++e)
                      part[gi] += qr[gi][i2][e] * kv[e];
                }
              }
            }
            for (int off = lpk / 2; off > 0; off >>= 1)
#pragma unroll
              for (int gi = 0; gi < G; ++gi)
                part[gi] += __shfl_xor_sync(0xffffffffu, part[gi], off);
            if (t < nr) {
#pragma unroll
              for (int gi = 0; gi < G; ++gi) {
                float x = part[gi];
                if (p.cap_in != 0.f) x = tanhf(x * p.cap_in) / p.cap_in;
                sc[c][gi] = x;
              }
            }
          }
        }
        // the warp's max over the chunk (step c0 holds a live key: finite)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          float mx = sc[0][gi];
#pragma unroll
          for (int c = 1; c < kChunk; ++c) mx = fmaxf(mx, sc[c][gi]);
          for (int off = lpk; off < 32; off <<= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[gi], mx);
          const float corr = exp2f(m[gi] - m_new);  // 0 at the first chunk
          m[gi] = m_new;
          l[gi] *= corr;
#pragma unroll
          for (int i2 = 0; i2 < NVL; ++i2)
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[gi][i2][e] *= corr;
        }
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int t = (c0 + kConsumerWarps * c) * kpw + kig;
          if (c0 + kConsumerWarps * c < n_steps && t < nr) {
            float pr[G];
#pragma unroll
            for (int gi = 0; gi < G; ++gi) {
              pr[gi] = exp2f(sc[c][gi] - m[gi]);
              l[gi] += pr[gi];
            }
#pragma unroll
            for (int i2 = 0; i2 < NVL; ++i2) {
              const int j = lig + lpk * i2;
              if (j < nv) {
                float vv[VEC];
                Vec<T>::load(vt + t * rs + j * 16, vv);
#pragma unroll
                for (int gi = 0; gi < G; ++gi)
#pragma unroll
                  for (int e = 0; e < VEC; ++e)
                    acc[gi][i2][e] += pr[gi] * vv[e];
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
      if (++s == p.stages) {
        s = 0;
        phase ^= 1;
      }
    }
  }

  // Merge: the lane groups of a warp share its max, so their sums add;
  // then the warps merge through shared memory (the ring is free: every
  // copy issued has landed and been read).
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
    for (int off = lpk; off < 32; off <<= 1) {
      l[gi] += __shfl_xor_sync(0xffffffffu, l[gi], off);
#pragma unroll
      for (int i2 = 0; i2 < NVL; ++i2)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[gi][i2][e] += __shfl_xor_sync(0xffffffffu, acc[gi][i2][e], off);
    }
  consumer_sync();
  const int dp = nv * VEC;  // a row's floats, padded to whole vectors
  float* red = reinterpret_cast<float*>(ring);  // [warp][G][dp]
  if (!bad) {
    if (lane == 0)
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        if (gi < rows) {
          m_sm[warp * 8 + gi] = m[gi];
          l_sm[warp * 8 + gi] = l[gi];
        }
    if (kig == 0)
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int i2 = 0; i2 < NVL; ++i2) {
          const int j = lig + lpk * i2;
          if (gi < rows && j < nv) {
            float4* dst = reinterpret_cast<float4*>(
                red + ((size_t)warp * G + gi) * dp + j * VEC);
#pragma unroll
            for (int e = 0; e < VEC; e += 4)
              dst[e / 4] = make_float4(acc[gi][i2][e], acc[gi][i2][e + 1],
                                       acc[gi][i2][e + 2], acc[gi][i2][e + 3]);
          }
        }
  }
  consumer_sync();
  for (int idx = tid; idx < rows * d; idx += kConsumers) {
    const int gi = idx / d, e = idx - gi * d;
    float M = -INFINITY, L = 0.f, A = 0.f;
    if (!bad) {
      for (int w = 0; w < kConsumerWarps; ++w) M = fmaxf(M, m_sm[w * 8 + gi]);
      for (int w = 0; w < kConsumerWarps; ++w) {
        const float mw = m_sm[w * 8 + gi];
        if (mw == -INFINITY) continue;  // this warp saw no key
        const float c = exp2f(mw - M);
        L += l_sm[w * 8 + gi] * c;
        A += red[((size_t)w * G + gi) * dp + e] * c;
      }
    }
    if (p.n_split == 1) {
      out[(row0 + gi) * d + e] = from_f32<T>(bad ? NAN : A / fmaxf(L, 1e-30f));
    } else {
      float* w = p.ws + ((row0 + gi) * p.n_split + split) * (size_t)(d + 2);
      w[e] = A;
      if (e == 0) {
        w[d] = bad ? NAN : M;
        w[d + 1] = bad ? NAN : L;
      }
    }
  }
}

// Merges the live splits' partials of one (b, q head) by the log-sum-exp
// rule, m in log2 units: out = sum_s acc_s 2^(m_s - M) / max(sum_s l_s
// 2^(m_s - M), 1e-30), M = max_s m_s. A NaN m (a bad id) gives NaN; no live
// split gives 0. The grid's y shares a row's columns out (the wide route:
// a block for every kWideCombineCols columns; 1 elsewhere).
template <typename T>
__global__ void __launch_bounds__(128)
paged_attention_sm90_combine(const float* __restrict__ ws,
                             const int* __restrict__ lengths,
                             T* __restrict__ out, int Hq, int d, int page,
                             int n_slots, int pps, int n_split) {
  const int hq = (int)(blockIdx.x % (unsigned)Hq);
  const int b = (int)(blockIdx.x / (unsigned)Hq);
  const int n_keys = min(max(lengths[b], 0), n_slots * page);
  const int n_live = ((n_keys + page - 1) / page + pps - 1) / pps;
  const size_t row = (size_t)b * Hq + hq;
  const float* w = ws + row * n_split * (size_t)(d + 2);
  float M = -INFINITY;
  bool bad = false;
  for (int s = 0; s < n_live; ++s) {
    const float ms = w[s * (size_t)(d + 2) + d];
    bad = bad || isnan(ms);
    M = fmaxf(M, ms);
  }
  for (int e = threadIdx.x + blockIdx.y * blockDim.x; e < d;
       e += blockDim.x * gridDim.y) {
    float o = 0.f;
    if (bad) {
      o = NAN;
    } else if (M != -INFINITY) {
      float L = 0.f, A = 0.f;
      for (int s = 0; s < n_live; ++s) {
        const float* ws_s = w + s * (size_t)(d + 2);
        const float c = exp2f(ws_s[d] - M);
        L += ws_s[d + 1] * c;
        A += ws_s[e] * c;
      }
      o = A / fmaxf(L, 1e-30f);
    }
    out[row * d + e] = from_f32<T>(o);
  }
}


// ---- the mma route: g >= 8 at d <= 256 -------------------------------------
//
// Every query row of a kv head in one block (a row tile of up to 64 rows;
// past 64, as Falcon-7B's 71, a second tile), the products on the tensor
// cores: S = q.K^T and P.V by mma.sync with float32 accumulators, as the
// TPU kernel multiplies its (g, d) block by a page on the MXU. The producer
// warp, the ring, the bad-id flag, the split and the combine kernel are the
// register route's.
//
// * q. The tile's rows go to shared memory once per block, unscaled, rows
//   past g and columns past d zero (float32 as TF32 hi and lo, split once);
//   log2(e) / sqrt(d) scales the float32 accumulator, so 2-byte q stays
//   exact. Rows are padded by 8 (2-byte) or 4 (float32) elements so that a
//   fragment's loads hit 32 banks.
// * Warps. The 4 consumer warps are row groups x key groups: a warp holds MW
//   m16 tiles of rows (16 MW rows, all d columns of their accumulator in
//   registers) and takes every KG-th unit of 16 keys, counted across the
//   stages, so a page of 16 keys is one unit and the warps of a row group
//   take turns. Rows of a group past g do no work.
// * Products. bf16 and f16: m16n8k16; the product of two 2-byte values is
//   exact in float32, so S is the TPU kernel's float32 product up to the
//   order of the sums. P.V (the TPU kernel's p is float32): f16 takes P in
//   one rounding, as K2's f16 route does; bf16 as P_hi + P_lo (two
//   products), as K2's bf16 route does (whether one rounding meets the bf16
//   bar is not measured). float32: 3xTF32 m16n8k8 (lo.hi + hi.lo + hi.hi),
//   K and V split as they are read from shared memory, P in registers; the
//   accumulator holds keys 2t and 2t + 1 where the tf32 A fragment has its
//   columns t and t + 4, so those columns take keys 2t and 2t + 1 and V's
//   rows follow that order. Every product of a unit
//   starts from zero and is added to the accumulator in float32 (mma.sync
//   truncates what it adds to).
// * Softmax. Per unit and row: the softcap, keys at or past the stage's
//   live rows to -inf, the max over the quad's lanes (two shuffles), the
//   rescale, exp2 (log2 units), a per-lane sum reduced at the end.
// * Merge. Each warp's m, l and accumulator go to shared memory (the ring
//   and q, free once every warp is done), and the row group's warps merge
//   by the log-sum-exp rule as the register route's warps do.
//
// Bound: bytes, as the register route's (4 g d flops per key against 2 d
// elt bytes is 12-71 flop/byte at g = 12-71 in 2-byte types, far below the
// tensor cores' ridge). The ring holds up to 8 stages of about 64 KiB (the
// register route's 4 and 32 KiB): the warps of a row group take turns at
// the units, so each then has its next unit in flight while it works (in
// float32, where a stage of 16 keys is 16 KiB, 4 stages ran 1.42x faster
// than 2 on the H100; benchmarks_torch/paged_variants.py times these
// choices). The ring's rows are staged unpadded (one bulk copy per page),
// so a fragment's 8 key rows share 4 banks; reads without those conflicts
// ran at most 7% faster. What sets the pace is the blocks' fixed work (q's
// load, the first stages' latency, the merge) and the latency of each
// unit's chain of loads, products and exps with few warps a SM: a build
// that skipped the products ran in 0.4-0.6 of the time.

// d += a.b, m16n8k16 (bf16 or f16) or m16n8k8 (tf32), float32 accumulators
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4],
                                                   const uint32_t (&a)[4],
                                                   const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma<float>(float (&c)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// x = hi + lo: hi is x rounded to TF32 (ties away from zero, as
// cvt.rna.tf32.f32), lo = x - hi exactly; the tensor core reads lo's top
// bits (tests/tf32_split.py).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// Two floats as one register of two 2-byte values, the first in the low
// half; and the rounding error of each (P_lo).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x0, float x1);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float x0, float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float x0, float x1) {
  const __half2 h = __floats2half2_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t bf16_rest(float x0, float x1,
                                              uint32_t hi) {
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  return pack2<__nv_bfloat16>(x0 - __bfloat162float(h.x),
                              x1 - __bfloat162float(h.y));
}

__device__ __forceinline__ uint32_t ld_u32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ uint32_t ld_u16(const unsigned char* p) {
  return *reinterpret_cast<const uint16_t*>(p);
}

// Blocks an SM should hold, which caps each instance's registers: 3 for the
// 2-byte instances with one m16 tile a warp, 2 for two m16 tiles at d <=
// 128 (the 2-byte d = 128 ones then spill 152 bytes), else 1 (the float32
// d = 128 two-tile instance holds 231 registers). Against one block a SM
// (benchmarks_torch/paged_variants.py's one_block) these ran the bf16
// group shapes up to 1.4x and the float32 d = 64 instance 1.39x faster on
// the H100.
template <typename T, int D, int MW>
constexpr int mma_min_blocks() {
  return D == 256 ? 1
         : sizeof(T) == 4 ? (D == 64 && MW == 2 ? 2 : 1)
                          : (MW == 1 ? 3 : 2);
}

// T: float32, bfloat16 or float16. D: the instance's widest head dim (64,
// 128, 256; d <= D at run time). MW: m16 tiles of rows a warp holds.
template <typename T, int D, int MW>
__global__ void __launch_bounds__(kThreads, (mma_min_blocks<T, D, MW>()))
paged_attention_sm90_mma_kernel(const Params p, int tile_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int KS = kF32 ? 8 : 16;  // the mma's depth
  constexpr int NT = D / 8;          // n8 tiles of the output columns
  constexpr int ELT = sizeof(T);
  // x = tile + n_tiles * (split + n_split * (h + Hkv * b))
  unsigned x = blockIdx.x;
  int tile = 0;
  if (p.n_tiles > 1) {
    const unsigned xt = x / (unsigned)p.n_tiles;
    tile = (int)(x - xt * (unsigned)p.n_tiles);
    x = xt;
  }
  const unsigned xs = x / (unsigned)p.n_split;
  const int split = (int)(x - xs * (unsigned)p.n_split);
  const int h = (int)(xs % (unsigned)p.Hkv), b = (int)(xs / (unsigned)p.Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d = p.d, page = p.page, R = p.rows_per_stage;
  const int rows = min(tile_rows, p.g - tile * tile_rows);
  const int n_keys = min(max(p.lengths[b], 0), p.n_slots * page);
  const int slot0 = split * p.pps;
  const int n_pages = min(p.pps, (n_keys + page - 1) / page - slot0);
  const size_t row0 =
      ((size_t)b * p.Hkv + h) * p.g + (size_t)tile * tile_rows;
  T* out = static_cast<T*>(p.out);
  if (n_pages <= 0) {  // the run starts at or past the length
    if (p.n_split == 1)
      for (int i = tid; i < rows * d; i += kThreads)
        out[row0 * d + i] = from_f32<T>(0.f);
    return;
  }

  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMmaMaxStages;
  int* stage_bad = reinterpret_cast<int*>(smem + 16 * kMmaMaxStages);
  unsigned char* ring = smem + kRingOff;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    produce<T>(p, ring, full, empty, stage_bad, b, h, slot0, n_pages, n_keys,
               lane);
    return;
  }

  // Consumers: warp = row group + n_rg * key group.
  const int g8 = lane >> 2, t4 = lane & 3;  // the fragments' row and column
  const int n_rg = mma_row_groups(rows, MW), n_kg = kConsumerWarps / n_rg;
  const int rg = warp % n_rg, kg = warp / n_rg;
  const int rb = rg * 16 * MW;          // the warp's first row of the tile
  const int dq = round_up(d, KS);       // q's columns in shared memory
  const int qs = dq + (kF32 ? 4 : 8);   // q's row stride, elements
  const int rs = round_up(d * ELT, 16);  // a ring row, bytes
  const int dp = rs / ELT;              // its elements (zero past d)
  const int rows_p = n_rg * 16 * MW;
  unsigned char* qa = ring + p.stages * p.stage_bytes;
  {
    // 16-byte vectors where q's base and rows allow (QV of them in flight
    // per thread), else one element at a time
    const T* q = static_cast<const T*>(p.q) + row0 * d;
    uint32_t* qh = reinterpret_cast<uint32_t*>(qa);
    uint32_t* ql = qh + rows_p * qs;
    constexpr int VE = 16 / ELT, QV = 8;
    if (reinterpret_cast<uintptr_t>(p.q) % 16 == 0 && d * ELT % 16 == 0) {
      const int nvr = dq / VE, n = rows_p * nvr;  // vectors a row, in all
      for (int i0 = tid; i0 < n; i0 += kConsumers * QV) {
        uint4 v[QV];
#pragma unroll
        for (int k = 0; k < QV; ++k) {
          const int i = i0 + k * kConsumers, r = i / nvr, c = (i % nvr) * VE;
          v[k] = i < n && r < rows && c < d
                     ? *reinterpret_cast<const uint4*>(q + (size_t)r * d + c)
                     : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int k = 0; k < QV; ++k) {
          const int i = i0 + k * kConsumers, r = i / nvr, c = (i % nvr) * VE;
          if (i >= n) break;
          if constexpr (kF32) {
            const float f[4] = {__uint_as_float(v[k].x),
                                __uint_as_float(v[k].y),
                                __uint_as_float(v[k].z),
                                __uint_as_float(v[k].w)};
            uint4 hi, lo;
            split_tf32(f[0], hi.x, lo.x);
            split_tf32(f[1], hi.y, lo.y);
            split_tf32(f[2], hi.z, lo.z);
            split_tf32(f[3], hi.w, lo.w);
            *reinterpret_cast<uint4*>(qh + r * qs + c) = hi;
            *reinterpret_cast<uint4*>(ql + r * qs + c) = lo;
          } else {
            *reinterpret_cast<uint4*>(qa + (r * qs + c) * 2) = v[k];
          }
        }
      }
    } else {
      for (int i = tid; i < rows_p * dq; i += kConsumers) {
        const int r = i / dq, c = i - r * dq;
        const bool live = r < rows && c < d;
        if constexpr (kF32) {
          split_tf32(live ? q[(size_t)r * d + c] : 0.f, qh[r * qs + c],
                     ql[r * qs + c]);
        } else {
          reinterpret_cast<T*>(qa)[r * qs + c] =
              live ? q[(size_t)r * d + c] : from_f32<T>(0.f);
        }
      }
    }
  }
  consumer_sync();

  float o[MW][NT][4], m[MW][2], l[MW][2];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[mi][hf] = -INFINITY;
      l[mi][hf] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][nt][e] = 0.f;
  }

  bool bad = false;
  int s = 0, u = 0;    // the ring's stage; units of 16 keys seen so far
  uint32_t phase = 0;  // of the full barriers in this round of the ring
  for (int i = 0; i < n_pages && !bad; ++i) {
    const int t_end = min(page, n_keys - (slot0 + i) * page);
    for (int r0 = 0; r0 < t_end; r0 += R) {
      mbar_wait(smem_u32(&full[s]), phase);
      if (stage_bad[s]) {  // the same for every consumer; nothing follows
        bad = true;
        break;
      }
      const unsigned char* kt = ring + s * p.stage_bytes;
      const unsigned char* vt = kt + p.tile_stride;
      const int nr = min(R, t_end - r0);  // keys in this stage
      const int nu = (nr + 15) >> 4;      // its units of 16 keys
      const int j0 = ((kg - u) % n_kg + n_kg) % n_kg;
      for (int j = rb < rows ? j0 : nu; j < nu; j += n_kg) {
        const int kb = j * 16;  // the unit's first key in the stage
        // S = q.K^T: sc[mi][n8 tile of keys][c]
        float sc[MW][2][4];
#pragma unroll
        for (int mi = 0; mi < MW; ++mi)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) sc[mi][nt][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D / KS; ++ks) {
          if (ks * KS >= d) break;
          if constexpr (kF32) {
            const int c = ks * KS + t4;
            uint32_t bh[2][2], bl[2][2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const int key = kb + 8 * nt + g8;
              const unsigned char* kr = kt + key * rs;
              split_tf32(key < nr && c < dp
                             ? *reinterpret_cast<const float*>(kr + c * 4)
                             : 0.f,
                         bh[nt][0], bl[nt][0]);
              split_tf32(key < nr && c + 4 < dp
                             ? *reinterpret_cast<const float*>(kr + c * 4 + 16)
                             : 0.f,
                         bh[nt][1], bl[nt][1]);
            }
            const uint32_t* qh = reinterpret_cast<const uint32_t*>(qa);
            const uint32_t* ql = qh + rows_p * qs;
#pragma unroll
            for (int mi = 0; mi < MW; ++mi) {
              if (rb + 16 * mi >= rows) break;
              const int r = rb + 16 * mi + g8;
              const int i0 = r * qs + c, i1 = i0 + 8 * qs;
              const uint32_t ah[4] = {qh[i0], qh[i1], qh[i0 + 4], qh[i1 + 4]};
              const uint32_t al[4] = {ql[i0], ql[i1], ql[i0 + 4], ql[i1 + 4]};
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) {
                mma<float>(sc[mi][nt], al, bh[nt]);
                mma<float>(sc[mi][nt], ah, bl[nt]);
                mma<float>(sc[mi][nt], ah, bh[nt]);
              }
            }
          } else {
            const int c = ks * KS + 2 * t4;
            uint32_t bk[2][2];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const int key = kb + 8 * nt + g8;
              const unsigned char* kr = kt + key * rs + c * 2;
              bk[nt][0] = key < nr && c < dp ? ld_u32(kr) : 0u;
              bk[nt][1] = key < nr && c + 8 < dp ? ld_u32(kr + 16) : 0u;
            }
#pragma unroll
            for (int mi = 0; mi < MW; ++mi) {
              if (rb + 16 * mi >= rows) break;
              const unsigned char* qr =
                  qa + ((rb + 16 * mi + g8) * qs + c) * 2;
              const uint32_t a[4] = {ld_u32(qr), ld_u32(qr + 16 * qs),
                                     ld_u32(qr + 16), ld_u32(qr + 16 * qs + 16)};
#pragma unroll
              for (int nt = 0; nt < 2; ++nt) mma<T>(sc[mi][nt], a, bk[nt]);
            }
          }
        }
        // the softmax: scale, softcap, mask, then per row (g8 and g8 + 8 of
        // each m16 tile) the unit's max over the quad and the rescale
#pragma unroll
        for (int mi = 0; mi < MW; ++mi) {
          if (rb + 16 * mi >= rows) break;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float mx = -INFINITY;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                float v = sc[mi][nt][2 * hf + e] * p.scale;
                if (p.cap_in != 0.f) v = tanhf(v * p.cap_in) / p.cap_in;
                v = kb + 8 * nt + 2 * t4 + e < nr ? v : -INFINITY;
                sc[mi][nt][2 * hf + e] = v;
                mx = fmaxf(mx, v);
              }
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            // key kb is live: mx is finite
            const float m_new = fmaxf(m[mi][hf], mx);
            const float corr = exp2f(m[mi][hf] - m_new);  // 0 at the first
            m[mi][hf] = m_new;
            float sum = 0.f;
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float pr = exp2f(sc[mi][nt][2 * hf + e] - m_new);
                sc[mi][nt][2 * hf + e] = pr;
                sum += pr;
              }
            l[mi][hf] = l[mi][hf] * corr + sum;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              o[mi][nt][2 * hf] *= corr;
              o[mi][nt][2 * hf + 1] *= corr;
            }
          }
        }
        // O += P.V, n8 tile by n8 tile of the columns
        if constexpr (kF32) {
          // A: P's keys 2t and 2t + 1 of each n8 tile of S in the k order
          // (t, t + 4); split once
          uint32_t ph[MW][2][4], pl[MW][2][4];
#pragma unroll
          for (int mi = 0; mi < MW; ++mi)
#pragma unroll
            for (int kt2 = 0; kt2 < 2; ++kt2) {
              const float a[4] = {sc[mi][kt2][0], sc[mi][kt2][2],
                                  sc[mi][kt2][1], sc[mi][kt2][3]};
#pragma unroll
              for (int e = 0; e < 4; ++e)
                split_tf32(a[e], ph[mi][kt2][e], pl[mi][kt2][e]);
            }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt * 8 >= d) break;
            const int col = nt * 8 + g8;
            float acc[MW][4];
#pragma unroll
            for (int mi = 0; mi < MW; ++mi)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[mi][e] = 0.f;
#pragma unroll
            for (int kt2 = 0; kt2 < 2; ++kt2) {
              const int k0 = kb + 8 * kt2 + 2 * t4;
              uint32_t vh[2], vl[2];
#pragma unroll
              for (int e = 0; e < 2; ++e)
                split_tf32(k0 + e < nr && col < dp
                               ? *reinterpret_cast<const float*>(
                                     vt + (k0 + e) * rs + col * 4)
                               : 0.f,
                           vh[e], vl[e]);
#pragma unroll
              for (int mi = 0; mi < MW; ++mi) {
                if (rb + 16 * mi >= rows) break;
                mma<float>(acc[mi], pl[mi][kt2], vh);
                mma<float>(acc[mi], ph[mi][kt2], vl);
                mma<float>(acc[mi], ph[mi][kt2], vh);
              }
            }
#pragma unroll
            for (int mi = 0; mi < MW; ++mi)
#pragma unroll
              for (int e = 0; e < 4; ++e) o[mi][nt][e] += acc[mi][e];
          }
        } else {
          // A: P of keys (2t, 2t + 1) and (2t + 8, 2t + 9), rows g8 and
          // g8 + 8: the S accumulators' own layout
          constexpr bool kLo = std::is_same<T, __nv_bfloat16>::value;
          uint32_t ph[MW][4], pl[MW][4];
#pragma unroll
          for (int mi = 0; mi < MW; ++mi) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float v0 = sc[mi][e >> 1][2 * (e & 1)];
              const float v1 = sc[mi][e >> 1][2 * (e & 1) + 1];
              ph[mi][e] = pack2<T>(v0, v1);
              if constexpr (kLo) pl[mi][e] = bf16_rest(v0, v1, ph[mi][e]);
            }
          }
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            if (nt * 8 >= d) break;
            const int col = nt * 8 + g8;
            const int k0 = kb + 2 * t4;
            const unsigned char* vc = vt + col * 2;
            const bool cl = col < dp;
            uint32_t bv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = k0 + 8 * e;
              const uint32_t v0 = cl && k < nr ? ld_u16(vc + k * rs) : 0u;
              const uint32_t v1 =
                  cl && k + 1 < nr ? ld_u16(vc + (k + 1) * rs) : 0u;
              bv[e] = v0 | (v1 << 16);
            }
#pragma unroll
            for (int mi = 0; mi < MW; ++mi) {
              if (rb + 16 * mi >= rows) break;
              float acc[4] = {0.f, 0.f, 0.f, 0.f};
              if constexpr (kLo) mma<T>(acc, pl[mi], bv);
              mma<T>(acc, ph[mi], bv);
#pragma unroll
              for (int e = 0; e < 4; ++e) o[mi][nt][e] += acc[e];
            }
          }
        }
      }
      u += nu;
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
      if (++s == p.stages) {
        s = 0;
        phase ^= 1;
      }
    }
  }

  // Merge: a row's sum over its quad, then the warps of a row group through
  // shared memory (the ring and q are free: every copy issued has landed and
  // been read, every warp is past its last product).
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[mi][hf] += __shfl_xor_sync(0xffffffffu, l[mi][hf], 1);
      l[mi][hf] += __shfl_xor_sync(0xffffffffu, l[mi][hf], 2);
    }
  consumer_sync();
  constexpr int WR = 16 * MW;  // a warp's rows
  const int dr = round_up(d, 8);
  float* m_sm = reinterpret_cast<float*>(ring);  // [warp][32]
  float* l_sm = m_sm + kConsumerWarps * 32;      // [warp][32]
  float* red = l_sm + kConsumerWarps * 32;       // [warp][WR][dr]
  if (!bad) {
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
      if (rb + 16 * mi >= rows) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int rl = 16 * mi + 8 * hf + g8;
        if (t4 == 0) {
          m_sm[warp * 32 + rl] = m[mi][hf];
          l_sm[warp * 32 + rl] = l[mi][hf];
        }
        float* dst = red + ((size_t)warp * WR + rl) * dr + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          if (nt * 8 >= d) break;
          *reinterpret_cast<float2*>(dst + nt * 8) =
              make_float2(o[mi][nt][2 * hf], o[mi][nt][2 * hf + 1]);
        }
      }
    }
  }
  consumer_sync();
  const int dc = (d + 3) / 4;  // 4 columns a thread at a time
  for (int idx = tid; idx < rows * dc; idx += kConsumers) {
    const int r = idx / dc, e0 = (idx - r * dc) * 4;
    const int w0 = r / WR, rl = r - w0 * WR;  // row group, row in the group
    float M = -INFINITY, L = 0.f, A[4] = {0.f, 0.f, 0.f, 0.f};
    if (!bad) {
      for (int k = 0; k < n_kg; ++k)
        M = fmaxf(M, m_sm[(w0 + n_rg * k) * 32 + rl]);
      for (int k = 0; k < n_kg; ++k) {
        const int w = w0 + n_rg * k;
        const float mw = m_sm[w * 32 + rl];
        if (mw == -INFINITY) continue;  // this warp saw no key
        const float c = exp2f(mw - M);
        L += l_sm[w * 32 + rl] * c;
        const float4 a = *reinterpret_cast<const float4*>(
            red + ((size_t)w * WR + rl) * dr + e0);
        A[0] += a.x * c;
        A[1] += a.y * c;
        A[2] += a.z * c;
        A[3] += a.w * c;
      }
    }
    const int ne = min(4, d - e0);
    if (p.n_split == 1) {
      T* o_row = out + (row0 + r) * d + e0;
      for (int e = 0; e < ne; ++e)
        o_row[e] = from_f32<T>(bad ? NAN : A[e] / fmaxf(L, 1e-30f));
    } else {
      float* w = p.ws + ((row0 + r) * p.n_split + split) * (size_t)(d + 2);
      for (int e = 0; e < ne; ++e) w[e0 + e] = A[e];
      if (e0 == 0) {
        w[d] = bad ? NAN : M;
        w[d + 1] = bad ? NAN : L;
      }
    }
  }
}

// ---- the wide route: d > 2048 --------------------------------------------
//
// A row of q no longer fits a lane group's registers, so nothing of a row is
// held whole. d is cut into slices of kWideCols (2048, the register route's
// widest row), and a thread-block cluster of n = min(slices, kMaxCluster)
// CTAs takes one (group tile of G query rows, split, kv head, sequence):
// CTA r of it owns slice r, for the scores and for the output. Its 256
// threads hold the slice's accumulator, 8 floats a row each, in registers,
// and its shared memory q's slice of the tile's G rows (64 KiB at G = 8 in
// float32), staged once. The keys of the split's run go by in chunks of
// 32:
//
// 1. Partial scores. Warp w takes keys w, w + 8, w + 16 and w + 24 of the
//    chunk; its lanes stream the slice's columns of the four K rows from
//    device memory in 16-byte vectors where the pools and the row width
//    allow it, else 2 bytes at a time, and dot them with q's slice from
//    shared memory (staged by warps 1-7, by cp.async where q is 16-byte
//    aligned, while warp 0 reads the first chunk's page ids); shuffles
//    reduce. Each CTA reads only its own columns of K: K is read once in
//    all.
// 2. Sum. The partials (G x 32 floats) go to shared memory, in one of two
//    buffers by the chunk's parity; after a cluster barrier warp gi of
//    every CTA reads row gi of all n partials through distributed shared
//    memory and sums them in rank order 0, 1, ..., n - 1, so every CTA
//    holds the same bits of the scores, and so the same running max and
//    sum. Then scale, softcap, the chunk's max, the running max and sum in
//    log2 units, p into shared memory, the accumulator's correction. A
//    buffer is written again two chunks later, after the next barrier,
//    which no peer passes before its reads of it: one barrier a chunk, and
//    one more whose wait ends the block, after its output is written.
// 3. p.V. Each thread reads its slice columns of the chunk's live V rows
//    and adds p-weighted sums to its accumulator.
//
// The slice is the fastest block index, x = slice + n_slp * (tile +
// n_tiles * (split + n_split * (kv head + Hkv * b))), so the cluster dims
// (n, 1, 1) divide the grid (ops.paged_block). Past kMaxCluster slices the
// slices go in groups of one cluster each (n_slp: the slices rounded up to
// whole groups; a padding CTA owns no column): CTA r of every group sums
// the scores over slices r, r + n, ..., its q staged again for each of
// them per chunk, and each group recomputes the scores. m and l of a split
// go to the workspace from slice 0; the combine kernel is the register
// route's, its grid's y sharing out each row's columns (a block for every
// kWideCombineCols: with one block a row it took 0.171 of 0.195 ms at d =
// 16,384, g = 8 on an H100 at 700 W, benchmarks_torch/wide_variants.py).

// One element of T at a 2-byte aligned address, as a float.
template <typename T>
__device__ __forceinline__ float ld2(const unsigned char* p) {
  const uint16_t* u = reinterpret_cast<const uint16_t*>(p);
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float((uint32_t)u[0] | ((uint32_t)u[1] << 16));
  } else {
    T x;
    *reinterpret_cast<uint16_t*>(&x) = u[0];
    return to_f32(x);
  }
}

// Thread-block clusters: every thread of the cluster arrives, then waits;
// the arrival releases this thread's shared-memory writes to the cluster,
// the wait acquires the others'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// The float at shared-memory address `addr` of CTA `rank` of the cluster.
__device__ __forceinline__ float ld_cluster(uint32_t addr, uint32_t rank) {
  uint32_t a;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(a) : "memory");
  return v;
}

// The wide route's slices, CTAs a cluster, and the slices with the last
// group's padding, for head dim d (ops.wide_plan).
void wide_plan(int d, int* n_sl, int* n_cl, int* n_slp) {
  *n_sl = (d + kWideCols - 1) / kWideCols;
  *n_cl = *n_sl < kMaxCluster ? *n_sl : kMaxCluster;
  *n_slp = (*n_sl + *n_cl - 1) / *n_cl * *n_cl;
}

// G: query rows of a tile; vecm bit 0: 16-byte loads of K and V (pools and
// the row width 16-byte aligned), else 2-byte loads; bit 1: 16-byte copies
// of q (its base and rows 16-byte aligned), else element by element (the
// same for every thread: one instance serves all). n_slices: slices of d;
// n_cl: CTAs a cluster.
template <typename T, int G>
__global__ void __launch_bounds__(kWideThreads, 1)
paged_attention_sm90_wide_kernel(const Params p, int n_slices, int n_cl,
                                 int vecm) {
  constexpr int VEC = Vec<T>::N;
  constexpr int ACC = 8;                    // a row's slice floats a thread
  constexpr int KPW = kWideKeys / kWideWarps;  // keys per warp per chunk
  extern __shared__ uint4 q_s4[];           // [G][kWideCols] of T: q's slice
  const T* q_s = reinterpret_cast<const T*>(q_s4);
  __shared__ float part_s[2][G][kWideKeys];  // partial scores, by chunk parity
  __shared__ float sc[G][kWideKeys];        // p
  __shared__ float corr_s[G], m_s[G], l_s[G];
  __shared__ long long key_row[kWideKeys];  // each key's row in the pools
  __shared__ int bad_s;
  const int n_slp = (n_slices + n_cl - 1) / n_cl * n_cl;
  const unsigned x = blockIdx.x;
  const unsigned x1 = x / (unsigned)n_slp;
  const int slice = (int)(x - x1 * (unsigned)n_slp);
  const unsigned x2 = x1 / (unsigned)p.n_tiles;
  const int tile = (int)(x1 - x2 * (unsigned)p.n_tiles);
  const unsigned xs = x2 / (unsigned)p.n_split;
  const int split = (int)(x2 - xs * (unsigned)p.n_split);
  const int h = (int)(xs % (unsigned)p.Hkv), b = (int)(xs / (unsigned)p.Hkv);
  const int rank = slice % n_cl;  // the CTA's rank in its cluster
  const bool resident = n_slp == n_cl;  // one group: q's slice stays
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int d = p.d, page = p.page;
  const int rows = min(G, p.g - tile * G);
  const int n_keys = min(max(p.lengths[b], 0), p.n_slots * page);
  const long long k_begin = (long long)split * p.pps * page;
  const long long k_end = min((long long)n_keys, k_begin +
                                                     (long long)p.pps * page);
  const size_t row0 = ((size_t)b * p.Hkv + h) * p.g + (size_t)tile * G;
  const int c0 = slice * kWideCols;
  // this thread's columns of the slice: 16-byte vectors tid and tid + 256
  // (float32) or tid (2-byte types), or 2-byte loads of columns tid + 256 i
  auto col = [&](int i) {
    return (vecm & 1) ? c0 + (tid + kWideThreads * (i / VEC)) * VEC + i % VEC
                : c0 + tid + kWideThreads * i;
  };
  T* out = static_cast<T*>(p.out);
  if (k_end <= k_begin) {  // the run starts at or past the length (the
                           // same in every CTA of the cluster)
    if (p.n_split == 1)
      for (int gi = 0; gi < rows; ++gi)
#pragma unroll
        for (int i = 0; i < ACC; ++i)
          if (col(i) < d) out[(row0 + gi) * d + col(i)] = from_f32<T>(0.f);
    return;
  }
  const int elt = (int)sizeof(T), row_bytes = d * elt;
  const T* qt = static_cast<const T*>(p.q) + row0 * d;
  // q's slice s of the tile's rows into q_s as it is (T), zeros past d and
  // past the tile's rows, by threads t0, t0 + 1, ... of the block: 16-byte
  // cp.async copies where q's base and rows are 16-byte aligned (vecm bit
  // 1), else element by element; the caller waits (cp_wait_all) and syncs
  auto stage_q = [&](int s, int t0) {
    const int cs = s * kWideCols;
    const uint32_t qs = static_cast<uint32_t>(__cvta_generic_to_shared(q_s4));
    if (vecm & 2) {
      constexpr int UPR = kWideCols / VEC;  // 16-byte units a row
      for (int i = tid - t0; i < G * UPR; i += kWideThreads - t0) {
        const int gi = i / UPR, c = cs + (i % UPR) * VEC;
        const bool ok = gi < rows && c < d;  // d is a multiple of VEC
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                         qs + 16 * i),
                     "l"(ok ? qt + (size_t)gi * d + c : qt), "r"(ok ? 16 : 0)
                     : "memory");
      }
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
      T* q_w = reinterpret_cast<T*>(q_s4);
      for (int i = tid - t0; i < G * kWideCols; i += kWideThreads - t0) {
        const int gi = i / kWideCols, c = cs + i % kWideCols;
        q_w[i] = gi < rows && c < d ? qt[(size_t)gi * d + c]
                                    : from_f32<T>(0.f);
      }
    }
  };
  auto staged = [] {  // this thread's copies of q have landed
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  };
  float acc[G][ACC];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[gi][i] = 0.f;
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  if (tid == 0) bad_s = 0;
  bool bad = false;
  int parity = 0;  // which part_s this chunk writes
  for (long long k0 = k_begin; k0 < k_end && !bad; k0 += kWideKeys) {
    const int nk = (int)min((long long)kWideKeys, k_end - k0);
    __syncthreads();  // the last chunk's p and rows are read
    if (tid < kWideKeys) {
      long long r = -1;
      if (tid < nk) {
        const long long pos = k0 + tid;
        const int slot = (int)(pos / page);
        const int pid = p.page_table[(size_t)b * p.n_slots + slot];
        if (pid < 0 || pid >= p.P)
          bad_s = 1;
        else
          r = ((long long)pid * p.Hkv + h) * page + (pos - (long long)slot *
                                                                page);
      }
      key_row[tid] = r;
    } else if (resident && k0 == k_begin) {
      stage_q(slice, kWideKeys);  // beside warp 0's page ids
      staged();
    }
    __syncthreads();
    if (bad_s) {  // the same for every thread of the cluster; nothing follows
      bad = true;
      break;
    }
    // 1. partial scores over this CTA's slices: warp w's keys w + 8 j
    float part[G][KPW];
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int j = 0; j < KPW; ++j) part[gi][j] = 0.f;
    const unsigned char* kr[KPW];
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      const long long r = key_row[warp + kWideWarps * j];
      kr[j] = p.k + (r < 0 ? 0 : r) * row_bytes;
    }
    for (int s = rank; s < n_slices; s += n_cl) {
      if (!resident) {
        __syncthreads();  // q_s is read
        stage_q(s, 0);
        staged();
        __syncthreads();
      }
      const int cs = s * kWideCols, nc = min(kWideCols, d - cs);
      if (vecm & 1) {  // (d - cs) * elt is a multiple of 16 bytes
        for (int u = lane; u < nc * elt / 16; u += 32) {
          float kv[KPW][VEC];
#pragma unroll
          for (int j = 0; j < KPW; ++j)
            Vec<T>::load(kr[j] + (size_t)cs * elt + u * 16, kv[j]);
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            if (gi < rows) {
              float qv[VEC];
              Vec<T>::load(reinterpret_cast<const unsigned char*>(
                               q_s4 + gi * (kWideCols / VEC) + u),
                           qv);
#pragma unroll
              for (int j = 0; j < KPW; ++j)
#pragma unroll
                for (int e = 0; e < VEC; ++e) part[gi][j] += qv[e] * kv[j][e];
            }
          }
        }
      } else {
        for (int e = lane; e < nc; e += 32) {
          float kv[KPW];
#pragma unroll
          for (int j = 0; j < KPW; ++j)
            kv[j] = ld2<T>(kr[j] + (size_t)(cs + e) * elt);
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            if (gi < rows) {
              const float qv = to_f32(q_s[gi * kWideCols + e]);
#pragma unroll
              for (int j = 0; j < KPW; ++j) part[gi][j] += qv * kv[j];
            }
          }
        }
      }
    }
    // this chunk's partials to part_s[parity]; a peer read the other one
    // last (before the barrier this CTA passed then)
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        float v = part[gi][j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) part_s[parity][gi][warp + kWideWarps * j] = v;
      }
    cluster_arrive();
    cluster_wait();  // every CTA's partials of this chunk are written
    // 2. the scores (the partials summed in rank order: the same bits in
    // every CTA), softmax: warp gi, one key a lane
    if (warp < G) {
      const uint32_t src = static_cast<uint32_t>(
          __cvta_generic_to_shared(&part_s[parity][warp][lane]));
      float xv = ld_cluster(src, 0);
      for (int r = 1; r < n_cl; ++r) xv += ld_cluster(src, (uint32_t)r);
      xv *= p.scale;
      if (p.cap_in != 0.f) xv = tanhf(xv * p.cap_in) / p.cap_in;
      if (lane >= nk) xv = -INFINITY;
      float mx = xv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[warp], m_new = fmaxf(m_old, mx);
      const float pr = exp2f(xv - m_new);  // 0 past the live keys
      float sum = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      sc[warp][lane] = pr;
      __syncwarp();
      if (lane == 0) {
        const float c = exp2f(m_old - m_new);  // 0 at the first chunk
        corr_s[warp] = c;
        m_s[warp] = m_new;
        l_s[warp] = l_s[warp] * c + sum;
      }
    }
    parity ^= 1;
    __syncthreads();
    // 3. p.V over this thread's slice columns
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float c = corr_s[gi];
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[gi][i] *= c;
    }
    for (int t = 0; t < nk; ++t) {
      const unsigned char* vr = p.v + key_row[t] * row_bytes;
      float vv[ACC];
      if (vecm & 1) {
#pragma unroll
        for (int i = 0; i < ACC; i += VEC) {
          if (col(i) < d)
            Vec<T>::load(vr + col(i) * elt, vv + i);
          else
#pragma unroll
            for (int e = 0; e < VEC; ++e) vv[i + e] = 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < ACC; ++i)
          vv[i] = col(i) < d ? ld2<T>(vr + col(i) * elt) : 0.f;
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        const float pr = sc[gi][t];
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[gi][i] += pr * vv[i];
      }
    }
  }
  // every read of a peer's partials is done: arrive here, wait at the end
  // (no CTA leaves while a peer may still read its shared memory)
  cluster_arrive();
  __syncthreads();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {  // unrolled: acc stays in registers
    if (gi >= rows) break;
    const float L = l_s[gi], M = m_s[gi];
    if (p.n_split == 1) {
#pragma unroll
      for (int i = 0; i < ACC; ++i)
        if (col(i) < d)
          out[(row0 + gi) * d + col(i)] =
              from_f32<T>(bad ? NAN : acc[gi][i] / fmaxf(L, 1e-30f));
    } else {
      float* w = p.ws + ((row0 + gi) * p.n_split + split) * (size_t)(d + 2);
#pragma unroll
      for (int i = 0; i < ACC; ++i)
        if (col(i) < d) w[col(i)] = acc[gi][i];
      if (slice == 0 && tid == 0) {
        w[d] = bad ? NAN : M;
        w[d + 1] = bad ? NAN : L;
      }
    }
  }
  cluster_wait();
}

template <typename T, int G, int NVL>
int launch_main(const Params& p, dim3 grid, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_sm90_kernel<T, G, NVL>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_attention_sm90_kernel<T, G, NVL><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

#define PA_CASE(G, NVL)                                         \
  case G * 100 + NVL:                                           \
    err = launch_main<T, G, NVL>(p, grid, pl.smem, stream);     \
    break;

template <typename T, int D, int MW>
int launch_mma(const Params& p, dim3 grid, int smem, int tile_rows,
               cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_sm90_mma_kernel<T, D, MW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  paged_attention_sm90_mma_kernel<T, D, MW>
      <<<grid, kThreads, smem, stream>>>(p, tile_rows);
  return (int)cudaGetLastError();
}

#define MMA_CASE(D, MW)                                           \
  case D * 10 + MW:                                               \
    err = launch_mma<T, D, MW>(p, grid, pl.smem, G, stream);      \
    break;

// The wide route's launch in clusters of (n_cl, 1, 1) over `grid` blocks;
// with max_active, no launch: the most such clusters the card holds at
// once (cudaOccupancyMaxActiveClusters).
template <typename T, int G>
int launch_wide(const Params& p, unsigned grid, int n_slices, int vec,
                cudaStream_t stream, int* max_active = nullptr) {
  void (*kernel)(Params, int, int, int) =
      paged_attention_sm90_wide_kernel<T, G>;
  constexpr int smem = G * kWideCols * (int)sizeof(T);  // q's slice
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int n_sl, n_cl, n_slp;
  wide_plan(p.d, &n_sl, &n_cl, &n_slp);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)n_cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kWideThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (max_active)
    return (int)cudaOccupancyMaxActiveClusters(max_active, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, p, n_slices, n_cl, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The block count of a launch: tiles x slices (on the wide route with the
// last group's padding) x splits x kv heads x sequences, or 0 where it
// passes the x dimension's 2^31 - 1.
unsigned grid_blocks(const Params& p, int n_slices, int B) {
  const long long n =
      (long long)p.n_tiles * n_slices * p.n_split * p.Hkv * B;
  return n > 0x7fffffffLL ? 0u : (unsigned)n;
}

template <typename T>
int launch_t(const Params& p, int G, int B, int Hq, cudaStream_t stream,
             const Plan& pl, int n_slices, int n_slp, int vec) {
  const unsigned grid = grid_blocks(p, n_slices > 0 ? n_slp : 1, B);
  int err = (int)cudaErrorInvalidValue;
  if (pl.mw > 0) {  // the mma route: the (head dims, m16 tiles) instances
    switch (pl.dinst * 10 + pl.mw) {  // that mma_shape gives
      MMA_CASE(64, 1) MMA_CASE(64, 2)
      MMA_CASE(128, 1) MMA_CASE(128, 2)
      MMA_CASE(256, 1)
    }
  } else if (n_slices > 0) {  // the wide route
    switch (G) {
      case 1: err = launch_wide<T, 1>(p, grid, n_slices, vec, stream); break;
      case 2: err = launch_wide<T, 2>(p, grid, n_slices, vec, stream); break;
      case 4: err = launch_wide<T, 4>(p, grid, n_slices, vec, stream); break;
      case 8: err = launch_wide<T, 8>(p, grid, n_slices, vec, stream); break;
    }
  } else if constexpr (sizeof(T) == 4) {
    switch (G * 100 + pl.nvl) {  // the (G, NVL) pairs make_plan gives, f32
      PA_CASE(1, 4) PA_CASE(1, 8) PA_CASE(1, 16)
      PA_CASE(2, 4) PA_CASE(2, 8)
      PA_CASE(4, 2) PA_CASE(4, 4)
      PA_CASE(8, 1) PA_CASE(8, 2)
    }
  } else {
    switch (G * 100 + pl.nvl) {  // and bf16, f16
      PA_CASE(1, 4) PA_CASE(1, 8)
      PA_CASE(2, 2) PA_CASE(2, 4)
      PA_CASE(4, 1) PA_CASE(4, 2)
      PA_CASE(8, 1)
    }
  }
  if (err || p.n_split == 1) return err;
  // the wide route's rows over the grid's y, a block for every
  // kWideCombineCols columns (at most 65,535 blocks; the kernel strides)
  const long long chunks =
      n_slices > 0 ? ((long long)p.d + kWideCombineCols - 1) / kWideCombineCols
                   : 1;
  const dim3 cgrid((unsigned)(B * Hq),
                   (unsigned)(chunks < 65535 ? chunks : 65535));
  paged_attention_sm90_combine<T><<<cgrid, 128, 0, stream>>>(
      p.ws, p.lengths, static_cast<T*>(p.out), Hq, p.d, p.page, p.n_slots,
      p.pps, p.n_split);
  return (int)cudaGetLastError();
}

#undef PA_CASE
#undef MMA_CASE

}  // namespace

// C entry for ctypes. dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, pools
// and out).
// tile_rows: the route and its query rows per tile (ops.group_tile_rows):
// up to kMaxRows (8), G of the register route's group tiles (ops.tile_rows)
// or of the wide route's past d = 2048; above it, the mma route's row tile,
// which must be mma_tile_rows(g) at d <= kMmaMaxD (ops.mma_route picks the
// route; a measurement may ask for it at g <= 8). pages_per_split
// >= 1; with n_split = ceil(n_slots / pages_per_split) > 1, ws is float32
// scratch of B * Hq * n_split * (d + 2). bulk (ops._bulk_copies): 1 fills
// the stages by bulk copies, which needs both pools' bases and d * elt to
// be multiples of 16 bytes; 0 by the producer warp's 2-byte loads, which
// needs the bases 2-byte aligned (on the wide route, d > 2048: 16-byte
// loads of K and V where bulk is 1, else 2-byte loads). Any B, Hkv, d and
// page up to 2^31 - 1 blocks (B Hkv x group tiles x splits, x slices of
// 2048 columns on the wide route, with the last cluster's padding) and B
// Hq combine blocks. Launches on `stream` of `device` and returns
// cudaGetLastError() (0 when the launches were accepted); shapes it does
// not take (paged_attention_sm90_plan) return cudaErrorInvalidValue
// without launching.
extern "C" int paged_attention_sm90_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* lengths, void* out, float* ws, int B,
    int Hq, int Hkv, int d, int page, int n_slots, int P, int pages_per_split,
    int tile_rows, int bulk, float scale, float softcap, int dtype,
    int device, void* stream) {
  Plan pl = {};
  const int elt = dtype == 0 ? 4 : 2;
  const uintptr_t kb = reinterpret_cast<uintptr_t>(k_pages);
  const uintptr_t vb = reinterpret_cast<uintptr_t>(v_pages);
  const long long row = (long long)d * elt;
  const bool mma = tile_rows > kMaxRows;
  const bool wide = !mma && d > 0 && wide_route(d, elt);
  if (B <= 0 || Hkv <= 0 || Hq <= 0 || Hq % Hkv != 0 || d <= 0 ||
      page <= 0 || n_slots <= 0 || P <= 0 || pages_per_split <= 0 ||
      dtype < 0 || dtype > 2 || kb % 2 || vb % 2 ||
      (long long)B * Hq > 0x7fffffffLL ||
      (bulk && (kb % 16 || vb % 16 || row % 16)) ||
      (mma    ? !make_mma_plan(tile_rows, Hq / Hkv, d, page, elt, &pl)
       : wide ? tile_rows < 1 || tile_rows > kMaxRows ||
                    (tile_rows & (tile_rows - 1))
              : !make_plan(tile_rows, d, page, elt, &pl)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = static_cast<const unsigned char*>(k_pages);
  p.v = static_cast<const unsigned char*>(v_pages);
  p.page_table = page_table;
  p.lengths = lengths;
  p.out = out;
  p.ws = ws;
  p.Hkv = Hkv;
  p.g = Hq / Hkv;
  p.d = d;
  p.page = page;
  p.n_slots = n_slots;
  p.P = P;
  p.pps = pages_per_split;
  p.n_split = (n_slots + pages_per_split - 1) / pages_per_split;
  p.n_tiles = (p.g + tile_rows - 1) / tile_rows;
  p.rows_per_stage = wide ? 0 : pl.rows_per_stage;
  p.bulk = bulk != 0;
  p.stages = wide ? 0 : pl.stages;
  p.tile_stride = wide ? 0 : pl.tile_stride;
  p.stage_bytes = wide ? 0 : pl.stage_bytes;
  p.scale = scale * 1.4426950408889634f;  // log2(e)
  p.cap_in = softcap != 0.f ? 0.6931471805599453f / softcap : 0.f;
  int n_slices = 0, n_cl = 1, n_slp = 1;
  if (wide) wide_plan(d, &n_slices, &n_cl, &n_slp);
  // the wide route's loads: bit 0 16-byte loads of K and V (bulk), bit 1
  // 16-byte copies of q (its base and rows 16-byte aligned)
  const int vec = (bulk != 0) |
                  (reinterpret_cast<uintptr_t>(q) % 16 == 0 && row % 16 == 0)
                      << 1;
  if (p.n_split > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  if (grid_blocks(p, n_slp, B) == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_t<float>(p, tile_rows, B, Hq, s, pl, n_slices, n_slp, vec);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(p, tile_rows, B, Hq, s, pl, n_slices,
                                   n_slp, vec);
  return launch_t<__half>(p, tile_rows, B, Hq, s, pl, n_slices, n_slp, vec);
}

// The launch plan for tile_rows query rows per tile of g rows per kv head,
// head_dim d, `page` keys per page and dtype (0 float32, 1 bfloat16, 2
// float16): 16-byte vectors of a row per lane, keys per ring stage, ring
// stages, dynamic shared memory bytes and m16 tiles a warp. Returns 1 on the
// register route; 2 on the wide route (0 vectors a lane, kWideKeys keys per
// chunk, no stages, q's slice of the tile's rows in dynamic shared memory);
// 3 on the mma route
// (tile_rows > kMaxRows: mma_tile_rows(g); 0 vectors a lane); 0 where the
// kernel does not take the shape. Where a route is not the mma route, its
// m16 tiles a warp are 0.
extern "C" int paged_attention_sm90_plan(int tile_rows, int g, int d,
                                         int page, int dtype,
                                         int* vectors_per_lane,
                                         int* keys_per_stage, int* stages,
                                         int* smem_bytes, int* warp_m16) {
  Plan pl = {};
  const int elt = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || d < 1 || page < 1) return 0;
  *warp_m16 = 0;
  if (tile_rows > kMaxRows) {
    if (!make_mma_plan(tile_rows, g, d, page, elt, &pl)) return 0;
    *vectors_per_lane = 0;
    *keys_per_stage = pl.rows_per_stage;
    *stages = pl.stages;
    *smem_bytes = pl.smem;
    *warp_m16 = pl.mw;
    return 3;
  }
  if (wide_route(d, elt)) {
    if (tile_rows < 1 || tile_rows > kMaxRows || (tile_rows & (tile_rows - 1)))
      return 0;
    *vectors_per_lane = 0;
    *keys_per_stage = kWideKeys;
    *stages = 0;
    *smem_bytes = tile_rows * kWideCols * 4;
    return 2;
  }
  if (!make_plan(tile_rows, d, page, elt, &pl)) return 0;
  *vectors_per_lane = pl.nvl;
  *keys_per_stage = pl.rows_per_stage;
  *stages = pl.stages;
  *smem_bytes = pl.smem;
  return 1;
}

// The source's route rule for g query rows per kv head at head dim d and
// dtype (0 float32, 1 bfloat16, 2 float16): 1 where the mma route takes the
// shape (mma_route), else 0. ops.sm90_plan reports it beside the plan, so a
// run on the card holds the wrapper's ops.mma_route to it.
extern "C" int paged_attention_sm90_mma_route(int g, int d, int dtype) {
  return mma_route(g, d, dtype == 0 ? 4 : 2) ? 1 : 0;
}

// The wide route (d > 2048) for tile_rows query rows per tile at head dim d
// and dtype (0 float32, 1 bfloat16, 2 float16) on `device`: CTAs a cluster
// and the most such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters). Returns the CUDA error
// (cudaErrorInvalidValue where the shape is not the wide route's).
extern "C" int paged_attention_sm90_wide_clusters(int tile_rows, int d,
                                                  int dtype, int device,
                                                  int* cluster,
                                                  int* max_active) {
  const int elt = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || d < 1 || !wide_route(d, elt))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int n_sl, n_slp;
  wide_plan(d, &n_sl, cluster, &n_slp);
  Params p = {};
  p.d = d;
  const unsigned grid = (unsigned)*cluster;
  int (*fn)(const Params&, unsigned, int, int, cudaStream_t, int*) = nullptr;
#define WIDE_FN(T)                                      \
  switch (tile_rows) {                                  \
    case 1: fn = launch_wide<T, 1>; break;              \
    case 2: fn = launch_wide<T, 2>; break;              \
    case 4: fn = launch_wide<T, 4>; break;              \
    case 8: fn = launch_wide<T, 8>; break;              \
  }
  if (dtype == 0) {
    WIDE_FN(float)
  } else if (dtype == 1) {
    WIDE_FN(__nv_bfloat16)
  } else {
    WIDE_FN(__half)
  }
#undef WIDE_FN
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(p, grid, n_sl, 1, 0, max_active);
}
