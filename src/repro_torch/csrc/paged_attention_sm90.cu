// Paged decode attention for Hopper (sm_90a), float32 or bfloat16 pools:
// pages split across blocks (flash-decoding), the query rows of a kv head
// split into group tiles, pages fed to a shared-memory ring by bulk TMA
// copies (or by the producer warp's own loads where a bulk copy cannot read
// the pool).
//
// Replaces src/repro/kernels/paged_attention/kernel.py::paged_attention (the
// Pallas TPU kernel, body `_kernel`) for every shape the wrapper accepts:
// any g = Hq / Hkv, any head dim d up to 2048, any page size, any row width
// in bytes and any pool base address. Same function and conventions as that
// kernel and as ref.py:
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
// per key against 2 d elt bytes. For g <= 8 that is far below the memory
// line, so tensor cores buy nothing and what counts is bytes in flight on
// every SM. At large g in float32 (about 20 flops per byte, g ~ 40) the
// CUDA cores' rate becomes the bound; the group tiles below keep the bytes
// at about one read from device memory whatever g is.
//
// * Group tiles. A block holds G query rows of one kv head in registers
//   (G = ops.tile_rows: the power of two >= g up to 8, halved while a
//   lane's floats of q, G * NVL * VEC, would pass 64), and the g rows are
//   ceil(g / G) tiles, the last one partial where G does not divide g (g =
//   71: eight tiles of 8 and one of 7). The tile is the fastest-varying
//   block index, so the tiles of one (b, kv head, split) are resident
//   together and read the same pages, the first from device memory and the
//   others from L2.
// * Split (flash-decoding). Grid (tile + n_tiles * split, kv head, b); a
//   block walks the run of `pps` slots [split * pps, (split + 1) * pps) up
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
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

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

// G query rows per tile (a power of two up to 8 whose q fits a lane's 64
// floats; ops.tile_rows chooses it), head dim d, elt bytes per element.
bool make_plan(int G, int d, int page, int elt, Plan* pl) {
  if (G < 1 || G > kMaxRows || (G & (G - 1)) || d < 1 || page < 1 ||
      (elt != 2 && elt != 4))
    return false;
  const int vec = 16 / elt, row = d * elt, nv = (row + 15) / 16;
  if (G * pow2_at_least((nv + 31) / 32) * vec > kMaxLaneFloats) return false;
  pl->nvl = pick_nvl(G, vec, nv);
  pl->row_stride = round_up(row, 16);
  pl->rows_per_stage = kMaxTile / pl->row_stride;  // >= 4: rows <= 8 KiB
  if (pl->rows_per_stage > page) pl->rows_per_stage = page;
  if (pl->rows_per_stage < 1) pl->rows_per_stage = 1;
  pl->tile_stride = round_up(pl->rows_per_stage * pl->row_stride, 128);
  pl->stage_bytes = 2 * pl->tile_stride;
  pl->stages = kRingBytes / pl->stage_bytes;
  if (pl->stages > kMaxStages) pl->stages = kMaxStages;
  if (pl->stages < 2) pl->stages = 2;
  const int ring = pl->stages * pl->stage_bytes;
  const int red = kConsumerWarps * G * nv * vec * 4;  // the warps' sums
  pl->smem = kRingOff + (ring > red ? ring : red);
  return pl->smem <= kSmemBudget;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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
// aligned, as every float32 or bfloat16 pool is) into shared memory rows of
// row_stride bytes, the padding zeroed; the producer warp's 32 lanes, 2
// bytes at a time.
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
  // (no division on the block's first loads where the group is one tile)
  const int tile = p.n_tiles == 1 ? 0 : blockIdx.x % p.n_tiles;
  const int split = p.n_tiles == 1 ? blockIdx.x : blockIdx.x / p.n_tiles;
  const int h = blockIdx.y, b = blockIdx.z;
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
    // producer: page ids of the live slots, then the live rows of each
    // page, R at a time, one stage each. Lane 0 waits for the stage, issues
    // its bulk copies and arrives; where the lanes fill it with their own
    // loads, all of them wait first and lane 0 arrives after them.
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
// split gives 0.
template <typename T>
__global__ void __launch_bounds__(128)
paged_attention_sm90_combine(const float* __restrict__ ws,
                             const int* __restrict__ lengths,
                             T* __restrict__ out, int Hq, int d, int page,
                             int n_slots, int pps, int n_split) {
  const int hq = blockIdx.x, b = blockIdx.y;
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
  for (int e = threadIdx.x; e < d; e += blockDim.x) {
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

template <typename T>
int launch_t(const Params& p, int G, int B, int Hq, cudaStream_t stream,
             const Plan& pl) {
  const dim3 grid(p.n_tiles * p.n_split, p.Hkv, B);
  int err = (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    switch (G * 100 + pl.nvl) {  // the (G, NVL) pairs make_plan gives, f32
      PA_CASE(1, 4) PA_CASE(1, 8) PA_CASE(1, 16)
      PA_CASE(2, 4) PA_CASE(2, 8)
      PA_CASE(4, 2) PA_CASE(4, 4)
      PA_CASE(8, 1) PA_CASE(8, 2)
    }
  } else {
    switch (G * 100 + pl.nvl) {  // and bf16
      PA_CASE(1, 4) PA_CASE(1, 8)
      PA_CASE(2, 2) PA_CASE(2, 4)
      PA_CASE(4, 1) PA_CASE(4, 2)
      PA_CASE(8, 1)
    }
  }
  if (err || p.n_split == 1) return err;
  paged_attention_sm90_combine<T><<<dim3(Hq, B), 128, 0, stream>>>(
      p.ws, p.lengths, static_cast<T*>(p.out), Hq, p.d, p.page, p.n_slots,
      p.pps, p.n_split);
  return (int)cudaGetLastError();
}

#undef PA_CASE

}  // namespace

// C entry for ctypes. dtype: 0 = float32, 1 = bfloat16 (q, pools and out).
// tile_rows: G, query rows per group tile (ops.tile_rows). pages_per_split
// >= 1; with n_split = ceil(n_slots / pages_per_split) > 1, ws is float32
// scratch of B * Hq * n_split * (d + 2). bulk (ops._bulk_copies): 1 fills
// the stages by bulk copies, which needs both pools' bases and d * elt to
// be multiples of 16 bytes; 0 by the producer warp's 2-byte loads, which
// needs the bases 2-byte aligned. Launches on `stream`
// of `device` and returns cudaGetLastError() (0 when the launches were
// accepted); shapes it does not take (paged_attention_sm90_plan) return
// cudaErrorInvalidValue without launching.
extern "C" int paged_attention_sm90_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* lengths, void* out, float* ws, int B,
    int Hq, int Hkv, int d, int page, int n_slots, int P, int pages_per_split,
    int tile_rows, int bulk, float scale, float softcap, int dtype,
    int device, void* stream) {
  Plan pl;
  const int elt = dtype == 0 ? 4 : 2;
  const uintptr_t kb = reinterpret_cast<uintptr_t>(k_pages);
  const uintptr_t vb = reinterpret_cast<uintptr_t>(v_pages);
  const int row = d * elt;
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || Hq % Hkv != 0 ||
      n_slots <= 0 || P <= 0 || pages_per_split <= 0 ||
      (dtype != 0 && dtype != 1) || kb % 2 || vb % 2 ||
      (bulk && (kb % 16 || vb % 16 || row % 16)) ||
      !make_plan(tile_rows, d, page, elt, &pl))
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
  p.rows_per_stage = pl.rows_per_stage;
  p.bulk = bulk != 0;
  p.stages = pl.stages;
  p.tile_stride = pl.tile_stride;
  p.stage_bytes = pl.stage_bytes;
  p.scale = scale * 1.4426950408889634f;  // log2(e)
  p.cap_in = softcap != 0.f ? 0.6931471805599453f / softcap : 0.f;
  if (p.n_split > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  if ((long long)p.n_tiles * p.n_split > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_t<float>(p, tile_rows, B, Hq, s, pl)
                    : launch_t<__nv_bfloat16>(p, tile_rows, B, Hq, s, pl);
}

// The launch plan for tile_rows query rows per group tile, head_dim d,
// `page` keys per page and dtype (0 float32, 1 bfloat16): 16-byte vectors
// of a row per lane, keys per ring stage, ring stages and dynamic shared
// memory bytes. Returns 0 where the kernel does not take the shape.
extern "C" int paged_attention_sm90_plan(int tile_rows, int d, int page,
                                         int dtype, int* vectors_per_lane,
                                         int* keys_per_stage, int* stages,
                                         int* smem_bytes) {
  Plan pl;
  if ((dtype != 0 && dtype != 1) ||
      !make_plan(tile_rows, d, page, dtype == 0 ? 4 : 2, &pl))
    return 0;
  *vectors_per_lane = pl.nvl;
  *keys_per_stage = pl.rows_per_stage;
  *stages = pl.stages;
  *smem_bytes = pl.smem;
  return 1;
}
