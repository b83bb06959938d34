// Paged decode attention for Hopper (sm_90a), float32 or bfloat16 pools:
// pages split across blocks (flash-decoding), whole pages fed to a shared
// memory ring by bulk TMA copies.
//
// Replaces src/repro/kernels/paged_attention/kernel.py::paged_attention (the
// Pallas TPU kernel, body `_kernel`) for every shape that passes
// ops._sm90_ok; csrc/paged_attention.cu keeps the rest. Same function and
// conventions as that kernel and as ref.py:
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
// Bound: the K and V bytes of the live pages. The arithmetic is 4 g d flops
// per key against 2 d elt bytes, far below the memory line for g <= 8, so
// tensor cores buy nothing; what counts is bytes in flight on every SM.
//
// * Split (flash-decoding). Grid (split, kv head, b); a block walks the
//   run of `pps` slots [split * pps, (split + 1) * pps) up to the length.
//   ops._pages_per_split picks pps on the host from B, Hkv, n_slots and the
//   SM count, never from lengths. A block whose run starts at or past the
//   length exits at once and writes nothing. With one split the block
//   writes the output; with more, each block writes its float32 partial
//   (acc[d], m, l) per query row to a workspace (B, Hq, n_split, d + 2),
//   and a second kernel merges the live splits (those whose run starts
//   below the length, which it recomputes from `lengths`) by the
//   log-sum-exp rule. No live split: 0. A split that met a bad id writes
//   m = NaN, and the merge gives NaN.
// * Bulk copies. For one (page id, kv head) a page of K is one contiguous
//   run of page * d * elt bytes, and so is a page of V. A producer warp
//   reads the page ids of the live slots only (32 at a time, one per lane)
//   and its lane 0 issues one cp.async.bulk per page per tensor into a ring
//   of 2 to 4 stages (each stage one page of K and one of V), with a full
//   mbarrier (completed by the copies' bytes) and an empty mbarrier (one
//   arrival per consumer warp) per stage. A bad id is passed down the ring
//   as a flag instead of a copy, and the producer stops there. The ring
//   holds about 32 KiB (2 stages at the serving page of 16 keys, d = 128,
//   float32): what keeps bytes in flight is the number of blocks resident
//   on an SM, and a deeper ring costs blocks (at the serving shape 3 and 4
//   stages ran slower than 2 on the H100).
// * One tile per page, no block barrier in the page loop. Each of four
//   consumer warps takes every fourth step of a page, a step being kpw
//   consecutive keys, one per group of lpk lanes; a lane holds NVL 16-byte
//   vectors of the pre-scaled q rows in registers, reads the same vectors
//   of its key's K row from shared memory, and the group's shuffles reduce
//   the score. Per chunk of up to 4 steps (the warp's whole share of a
//   serving page; 2 at g > 4, for registers) and query row:
//   one max across the warp, one rescale of the accumulator, one exp per
//   key; then p . V from the same lanes, each
//   lane owning its vectors of d. A warp keeps its own running max; at the
//   end the lane groups' sums add by shuffles and the warps merge through
//   the (now free) ring. float32 throughout; only the order of the sums
//   differs from ref.py.
// * No block barrier in the page loop: the consumers' time per page is a
//   chain of latencies (shared loads, shuffles, exp), so warps that wait on
//   each other at every page would set the pace instead of the copies.
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
constexpr int kMaxPage = 256;              // keys per page
constexpr int kMaxPageBytes = 32768;       // one page of K for one kv head
constexpr int kSmemBudget = 232448;        // a block's shared memory on H100
constexpr int kRingOff = 384;              // barriers, flags, warps' m and l

struct Params {
  const void* q;
  const unsigned char* k;
  const unsigned char* v;
  const int* page_table;
  const int* lengths;
  void* out;
  float* ws;
  int Hkv, g, d, page, n_slots, P, pps, n_split;
  int stages, tile_bytes, tile_stride, stage_bytes;
  float scale, softcap;
};

// Shared memory of one launch, or false where the shape is not taken.
struct Plan {
  int stages, tile_stride, stage_bytes, smem;
};

inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

bool make_plan(int g, int d, int page, int elt, Plan* pl) {
  const int row = d * elt;
  if (g < 1 || g > 8 || d < 1 || d > 256 || row % 16 || page < 1 ||
      page > kMaxPage || page * row > kMaxPageBytes)
    return false;
  const int red = kConsumerWarps * g * d * 4;  // the warps' sums
  pl->tile_stride = round_up(page * row, 128);
  pl->stage_bytes = 2 * pl->tile_stride;
  pl->stages = kRingBytes / pl->stage_bytes;
  if (pl->stages > kMaxStages) pl->stages = kMaxStages;
  if (pl->stages < 2) pl->stages = 2;
  const int ring = pl->stages * pl->stage_bytes;
  pl->smem = kRingOff + (ring > red ? ring : red);
  return pl->smem <= kSmemBudget;
}

// Vectors per lane for G rows and nv 16-byte vectors per row: as many as
// keep q's and the accumulator's registers at 32 floats each, and enough
// for 32 lanes to cover a row.
int pick_nvl(int G, int vec, int nv) {
  int nvl = 4;
  while (nvl > 1 && G * nvl * vec > 32) nvl /= 2;
  while (nvl * 32 < nv) nvl *= 2;
  return nvl;
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

// The four consumer warps only (the producer warp has left).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// G: query rows held (g <= G). NVL: 16-byte vectors of a row per lane; a
// group of lpk = pow2 >= ceil(nv / NVL) lanes holds one key's row, so a
// warp covers kpw = 32 / lpk keys per step.
template <typename T, int G, int NVL>
__global__ void __launch_bounds__(kThreads)
paged_attention_sm90_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int VEC = Vec<T>::N;
  // steps per max and rescale: 4 (a warp's whole share of a serving page),
  // fewer where G query rows of scores would crowd the registers
  constexpr int kChunk = G <= 4 ? 4 : 2;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = p.g, d = p.d, page = p.page;
  const int n_keys = min(max(p.lengths[b], 0), p.n_slots * page);
  const int slot0 = split * p.pps;
  const int n_pages = min(p.pps, (n_keys + page - 1) / page - slot0);
  const size_t row0 = ((size_t)b * p.Hkv + h) * g;  // first q row
  T* out = static_cast<T*>(p.out);
  if (n_pages <= 0) {  // the run starts at or past the length
    if (p.n_split == 1)
      for (int i = tid; i < g * d; i += kThreads)
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
    // producer: page ids of the live slots, one bulk copy per page per
    // tensor; lane 0 issues, the warp reads 32 ids at a time
    const int* pt = p.page_table + (size_t)b * p.n_slots + slot0;
    for (int i0 = 0; i0 < n_pages; i0 += 32) {
      const int mine = i0 + lane < n_pages ? pt[i0 + lane] : 0;
      const int n = min(32, n_pages - i0);
      for (int j = 0; j < n; ++j) {
        const int pid = __shfl_sync(0xffffffffu, mine, j);
        const bool bad = pid < 0 || pid >= p.P;
        if (lane == 0) {
          const int i = i0 + j, s = i % p.stages, use = i / p.stages;
          if (use > 0) mbar_wait(smem_u32(&empty[s]), (use - 1) & 1);
          const uint32_t fb = smem_u32(&full[s]);
          stage_bad[s] = bad;
          if (bad) {
            mbar_arrive(fb);
          } else {
            mbar_expect_tx(fb, 2 * p.tile_bytes);
            const size_t off = ((size_t)pid * p.Hkv + h) * p.tile_bytes;
            const uint32_t dst = smem_u32(ring + s * p.stage_bytes);
            bulk_load(dst, p.k + off, p.tile_bytes, fb);
            bulk_load(dst + p.tile_stride, p.v + off, p.tile_bytes, fb);
          }
        }
        if (bad) return;  // the same for every lane
      }
    }
    return;
  }

  // Consumers. Warp w takes the steps w, w + 4, ... of every page, a step
  // being kpw consecutive keys, one per lane group; it keeps its own
  // running max (the same in all its lanes), and each lane its partial sum
  // and its slice of the accumulator for the keys of its group.
  const int row_bytes = d * (int)sizeof(T);
  const int nv = row_bytes / 16;  // 16-byte vectors per row
  int lpk = 1;
  while (lpk * NVL < nv && lpk < 32) lpk <<= 1;
  const int kpw = 32 / lpk, lig = lane % lpk, kig = lane / lpk;

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
      for (int c = 0; c < VEC; ++c) {
        qr[gi][i][c] = gi < g && j < nv
                           ? to_f32(q[(row0 + gi) * d + j * VEC + c]) * p.scale
                           : 0.f;
        acc[gi][i][c] = 0.f;
      }
    }
  }

  bool bad = false;
  for (int i = 0; i < n_pages; ++i) {
    const int s = i % p.stages;
    mbar_wait(smem_u32(&full[s]), (i / p.stages) & 1);
    if (stage_bad[s]) {  // the same for every consumer; nothing follows
      bad = true;
      break;
    }
    const unsigned char* kt = ring + s * p.stage_bytes;
    const unsigned char* vt = kt + p.tile_stride;
    const int t_end = min(page, n_keys - (slot0 + i) * page);
    const int n_steps = (t_end + kpw - 1) / kpw;
    // chunks of kChunk steps: one max and one rescale per chunk per row
    // (one per page where the warp has at most kChunk steps of it)
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
          if (t < t_end) {
#pragma unroll
            for (int i2 = 0; i2 < NVL; ++i2) {
              const int j = lig + lpk * i2;
              if (j < nv) {
                float kv[VEC];
                Vec<T>::load(kt + t * row_bytes + j * 16, kv);
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
          if (t < t_end) {
#pragma unroll
            for (int gi = 0; gi < G; ++gi) {
              float x = part[gi];
              if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
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
        const float corr = expf(m[gi] - m_new);  // 0 at the first chunk
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
        if (c0 + kConsumerWarps * c < n_steps && t < t_end) {
          float pr[G];
#pragma unroll
          for (int gi = 0; gi < G; ++gi) {
            pr[gi] = expf(sc[c][gi] - m[gi]);
            l[gi] += pr[gi];
          }
#pragma unroll
          for (int i2 = 0; i2 < NVL; ++i2) {
            const int j = lig + lpk * i2;
            if (j < nv) {
              float vv[VEC];
              Vec<T>::load(vt + t * row_bytes + j * 16, vv);
#pragma unroll
              for (int gi = 0; gi < G; ++gi)
#pragma unroll
                for (int e = 0; e < VEC; ++e) acc[gi][i2][e] += pr[gi] * vv[e];
            }
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
  }

  // Merge: the lane groups of a warp share its max, so their sums add;
  // then the warps merge through shared memory (the ring is free: every
  // copy has landed and been read).
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
  float* red = reinterpret_cast<float*>(ring);  // [warp][g][d]
  if (!bad) {
    if (lane == 0)
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
        if (gi < g) {
          m_sm[warp * 8 + gi] = m[gi];
          l_sm[warp * 8 + gi] = l[gi];
        }
    if (kig == 0)
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int i2 = 0; i2 < NVL; ++i2) {
          const int j = lig + lpk * i2;
          if (gi < g && j < nv) {
            float4* dst = reinterpret_cast<float4*>(
                red + ((size_t)warp * g + gi) * d + j * VEC);
#pragma unroll
            for (int e = 0; e < VEC; e += 4)
              dst[e / 4] = make_float4(acc[gi][i2][e], acc[gi][i2][e + 1],
                                       acc[gi][i2][e + 2], acc[gi][i2][e + 3]);
          }
        }
  }
  consumer_sync();
  for (int idx = tid; idx < g * d; idx += kConsumers) {
    const int gi = idx / d, e = idx % d;
    float M = -INFINITY, L = 0.f, A = 0.f;
    if (!bad) {
      for (int w = 0; w < kConsumerWarps; ++w) M = fmaxf(M, m_sm[w * 8 + gi]);
      for (int w = 0; w < kConsumerWarps; ++w) {
        const float mw = m_sm[w * 8 + gi];
        if (mw == -INFINITY) continue;  // this warp saw no key
        const float c = expf(mw - M);
        L += l_sm[w * 8 + gi] * c;
        A += red[((size_t)w * g + gi) * d + e] * c;
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
// rule: out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30),
// M = max_s m_s. A NaN m (a bad id) gives NaN; no live split gives 0.
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
        const float c = expf(ws_s[d] - M);
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

template <typename T>
int launch_t(const Params& p, int B, int Hq, cudaStream_t stream,
             const Plan& pl) {
  const dim3 grid(p.n_split, p.Hkv, B);
  const int G = p.g <= 1 ? 1 : p.g <= 2 ? 2 : p.g <= 4 ? 4 : 8;
  const int nvl = pick_nvl(G, Vec<T>::N, p.d * (int)sizeof(T) / 16);
  int err = (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4) {
    switch (G * 10 + nvl) {  // the (G, NVL) pairs pick_nvl gives for f32
      case 14: err = launch_main<T, 1, 4>(p, grid, pl.smem, stream); break;
      case 24: err = launch_main<T, 2, 4>(p, grid, pl.smem, stream); break;
      case 42: err = launch_main<T, 4, 2>(p, grid, pl.smem, stream); break;
      case 81: err = launch_main<T, 8, 1>(p, grid, pl.smem, stream); break;
      case 82: err = launch_main<T, 8, 2>(p, grid, pl.smem, stream); break;
    }
  } else {
    switch (G * 10 + nvl) {  // and for bf16
      case 14: err = launch_main<T, 1, 4>(p, grid, pl.smem, stream); break;
      case 22: err = launch_main<T, 2, 2>(p, grid, pl.smem, stream); break;
      case 41: err = launch_main<T, 4, 1>(p, grid, pl.smem, stream); break;
      case 81: err = launch_main<T, 8, 1>(p, grid, pl.smem, stream); break;
    }
  }
  if (err || p.n_split == 1) return err;
  paged_attention_sm90_combine<T><<<dim3(Hq, B), 128, 0, stream>>>(
      p.ws, p.lengths, static_cast<T*>(p.out), Hq, p.d, p.page, p.n_slots,
      p.pps, p.n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry for ctypes. dtype: 0 = float32, 1 = bfloat16 (q, pools and out).
// pages_per_split >= 1; with n_split = ceil(n_slots / pages_per_split) > 1,
// ws is float32 scratch of B * Hq * n_split * (d + 2). k_pages and v_pages
// 16-byte aligned; d * elt a multiple of 16; page <= 256 keys and page * d *
// elt <= 32 KiB (paged_attention_sm90_plan). Launches on `stream` of
// `device` and returns cudaGetLastError() (0 when the launches were
// accepted); shapes it does not take return cudaErrorInvalidValue without
// launching.
extern "C" int paged_attention_sm90_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const int* page_table, const int* lengths, void* out, float* ws, int B,
    int Hq, int Hkv, int d, int page, int n_slots, int P, int pages_per_split,
    float scale, float softcap, int dtype, int device, void* stream) {
  Plan pl;
  const int elt = dtype == 0 ? 4 : 2;
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || Hq % Hkv != 0 ||
      n_slots <= 0 || P <= 0 || pages_per_split <= 0 ||
      (dtype != 0 && dtype != 1) ||
      reinterpret_cast<uintptr_t>(k_pages) % 16 ||
      reinterpret_cast<uintptr_t>(v_pages) % 16 ||
      !make_plan(Hq / Hkv, d, page, elt, &pl))
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
  p.stages = pl.stages;
  p.tile_bytes = page * d * elt;
  p.tile_stride = pl.tile_stride;
  p.stage_bytes = pl.stage_bytes;
  p.scale = scale;
  p.softcap = softcap;
  if (p.n_split > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_t<float>(p, B, Hq, s, pl)
                    : launch_t<__nv_bfloat16>(p, B, Hq, s, pl);
}

// The launch plan for g query rows per kv head, head_dim d, `page` keys per
// page and dtype (0 float32, 1 bfloat16): ring stages and dynamic shared
// memory bytes. Returns 0 where the kernel does not take the shape.
extern "C" int paged_attention_sm90_plan(int g, int d, int page, int dtype,
                                         int* stages, int* smem_bytes) {
  Plan pl;
  if ((dtype != 0 && dtype != 1) ||
      !make_plan(g, d, page, dtype == 0 ? 4 : 2, &pl))
    return 0;
  *stages = pl.stages;
  *smem_bytes = pl.smem;
  return 1;
}
