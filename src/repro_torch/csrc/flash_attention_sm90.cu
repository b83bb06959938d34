// Blocked (flash) attention forward for Hopper (sm_90a), bfloat16 and
// float16: 2-byte tensor-core products (wgmma), warp-specialised, fed by TMA
// or, where TMA cannot read a tensor, by the producer warpgroup's own loads.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention (the
// Pallas TPU kernel, body `_kernel`) for bfloat16 and float16 inputs; float32
// inputs go to flash_attention_f32_sm90.cu. Same function and conventions as
// that kernel, which computes in float32 whatever its input type:
//
//   q    (B, Hq, Sq, d)     k/v (B, Hkv, Sk, d)     out (B, Hq, Sq, d)
//
// given by (batch, head, seq) strides with a contiguous last dimension (the
// caller's (B, S, H, d) transposes stay views), any d, any base address,
// q-head h reading kv-head h / g. The score is (q.k) / sqrt(d), then the
// optional tanh softcap, then the causal (q_pos >= k_pos, both from 0) and
// window (q_pos - k_pos < window) masks write -1e30; keys past Sk score
// -inf. The online softmax is float32 from -1e30; out = acc / max(l, 1e-30)
// in the input's type. Key tiles wholly outside the band of a 128-row q tile
// are skipped, so a row that sees no key gets the mean of v over the keys of
// the tiles its q tile visited, or 0.
//
// Bound: at the model's shape (S = 4096, d = 128, causal) the work is 4 d
// operations per visible (q, k) pair, far above the bytes of q, k, v and out,
// so the 2-byte tensor-core rate bounds it. The design feeds the tensor cores:
//
// * One block per (b*Hq + h, 128-row q tile), heaviest causal tiles first:
//   x = b*Hq + h, and the grid's y and z (65,535 each) hold one index,
//   y + ny * z: t + n_qt * slice, or slice + n_sl * t on the cluster route
//   (t counts q tiles from the last); blocks past the end exit at once. Any
//   Sq (grid_of, ops.flash_grid, ops.flash_block).
//   384 threads: a producer warpgroup (its registers cut to 24 by setmaxnreg;
//   40 or 56 where it loads on its own) and two consumer warpgroups (240
//   registers; 232 or 224), each owning 64 q rows.
// * TMA. Host-built 4-D tensor maps over (d, S, H, B) read the strided views
//   as they are, in 64-column boxes with the 128-byte swizzle; rows and keys
//   out of bounds arrive as zeros. q is loaded once; K and V tiles (128 keys
//   at d <= 128, 64 at d = 256) go through a 2-stage ring, each with its own
//   full and empty mbarriers: Q.K^T starts before V lands, and a K buffer is
//   refilled as soon as its product is done. One thread issues every copy.
// * Own loads. TMA needs a 16-byte aligned base and strides that are
//   multiples of 16 bytes. Where a tensor breaks that (a view off alignment,
//   a row of d = 37 or 100 elements), the producer warpgroup's 128 threads
//   fill the same boxes in the same swizzled layout, zeros past d and past
//   the sequence, by the widest unit (8, 4 or 2 bytes) that every base,
//   stride and row allows (`unit`, ops._sm90_unit). The stage's full
//   barrier takes one arrive from each of them (128, not one expect_tx).
//   Every unit takes the same loader:
//   - Where a row's live bytes fit 10 aligned 16-byte words (d <= 73), a
//     thread takes a whole row: those words (only those) at once, realigned
//     in registers by funnel shifts into 16-byte stores to the swizzled
//     slots, one round trip a row (own_rows_whole).
//   - Else a thread takes half a row (64 bytes of a box row) the same way:
//     the aligned 16-byte words that hold its live bytes (at most 5; only
//     those, so each holds a byte of the tensor) by read-only vector loads,
//     all in flight at once, then the stores. At d <= 128 a thread keeps
//     two half rows in flight (its producers then hold 56 registers, its
//     consumers 224).
//   Then a proxy fence (wgmma reads shared memory through the async proxy)
//   and the arrive. Every fill writes its zeros (skipping the columns past
//   d on later fills of a stage ran slower). The old loader stored one
//   2-byte word at a time behind a "memory" clobber, so a thread had one
//   load in flight; cp.async of 4 and of 8 bytes lost to the realigned
//   loads (benchmarks_torch/wide_variants.py; PERF.md).
// * S = Q.K^T: wgmma m64n{BK}k16, both operands from shared memory (K is
//   K-major as stored), f32 accumulators in registers. The softmax runs on
//   the accumulator fragment in log2 units (ex2): row max and sum across the
//   four threads of a quad by shuffles; masks only on tiles that cross the
//   diagonal, the window edge or Sk.
// * O += P.V: wgmma with P in registers (the S fragment is the A fragment,
//   converted in place) and V from shared memory as an MN-major operand (the
//   descriptor's transpose bit). bfloat16: P goes in two parts, P_hi =
//   bf16(p) and P_lo = bf16(p - P_hi), two products into one f32
//   accumulator: with a single rounding of P, gemma2's widths (d = 256,
//   softcap 50) reached 1.1x the bf16 tolerance (atol 2e-3, rtol 2e-2)
//   against the float32 plain version; the split stays under a third of it
//   and costs 1.5x the function's operations. float16: one product of P =
//   f16(p). Its 11 significant bits keep a single rounding within 0.39 of
//   the float16 bar (atol 1e-3, rtol 2e-3) of the Pallas kernel on the test
//   sweep and gemma2's widths, where the split reaches 0.36
//   (tests/test_torch_flash_attention.py), so the split would buy nothing.
//   l is summed from the f32 p.
// * Schedule. A warpgroup issues P.V of one tile and S of the next back to
//   back and waits for both once; the two warpgroups take turns at that (two
//   named barriers), so one's softmax runs while the other's products do.
// * Epilogue: O / max(l, 1e-30) to the input's type, plain stores into q's
//   layout (pairs where out's base, strides and d allow 4-byte stores); rows
//   past Sq and columns past d are not written.
// * d > 256. The O accumulator takes D/2 f32 registers a thread, and q with
//   its K/V ring fills shared memory already at d = 256, so d is cut into
//   slices of 256 columns (kSlice).
//   - 256 < d <= 4096 (`kCluster`): a thread-block cluster of one CTA a
//     slice (n = ceil(d / 256) CTAs, at most kMaxCluster = 16; past 8 the
//     non-portable sizes) takes one (b*Hq + h, q tile), CTA r slice r. Each
//     CTA is the d = 256 CTA on its own columns of q (resident), K and V:
//     the same tiles, rings, producers and warpgroup turns. Its products
//     give a partial S over its columns, which each consumer warpgroup
//     writes to shared memory (64 rows x 64 keys, f32) and sums with the
//     other CTAs' over distributed shared memory (mapa,
//     ld.shared::cluster), in rank order 0, 1, ..., n - 1, so every CTA
//     holds the same bits of S and so the same m, l and P (`exchange`: at
//     n <= 2 each thread reads every CTA's units of its fragment; past that
//     each CTA sums the units it owns and then reads the others' sums, two
//     rounds of remote loads instead of n). mbarriers per warpgroup, which
//     each CTA's elected thread arrives on remotely, order the writes and
//     reads (full, summed, and empty before the next tile's partial). S is
//     computed once per q tile; each CTA applies P to its own 256 columns
//     of V. The cluster is the fast part of the grid's (slice, q tile)
//     index over y and z, y's extent a multiple of n (grid_of). The
//     producers take no part in the exchange and run ahead as at d = 256.
//   - d > 4096 (`kStream`; one cluster would need more than 16 CTAs): the
//     grid's slice index cuts the output, and a block streams q and K in
//     64-column chunks through a 4-stage ring (a 128 x 64 q chunk beside a
//     64 x 64 K chunk per stage), sums S over the chunks, then applies P to
//     its own 256 columns of V (a 2-stage ring of 64 x 256 tiles): S is
//     recomputed once per slice. The warpgroups do not take turns.
//
// Two things ptxas punishes here: an S accumulator carried across loop
// iterations makes it serialize every wgmma (warning C7515), so S is fresh
// in each iteration (the streaming kernel's chunk loop carries it, and waits
// for each chunk anyway); and branches on kernel parameters inside the
// unrolled score loop (softcap, masks) cost more than the arithmetic, so
// each is a loop of its own over the fragment.
//
// Not here yet: overlapping a warpgroup's softmax with its own next Q.K^T
// (FA3's intra-warpgroup pipelining), a persistent grid, fp8.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBQ = 128;          // q rows per block
constexpr int kRows = 64;         // q rows per consumer warpgroup
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kProducers = 128;   // the producer warpgroup's threads
constexpr int kChunk = 64;        // d columns per TMA box (128 bytes)
constexpr int kChunkBytes = kChunk * 2;
constexpr int kSlice = 256;       // output columns per block where d > 256
constexpr int kMaxCluster = 16;   // CTAs a cluster (past 8 non-portable)
constexpr float kMasked = -1e30f;

// The three routes: d <= 256, 256 < d <= kSlice * kMaxCluster, past that.
enum Route { kPlain, kCluster, kStream };
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
constexpr bool kHalf = std::is_same<T, __half>::value;

struct Args {
  const void* src[3];   // q, k, v, for the own loads
  long long st[3][3];   // their (batch, head, seq) strides, in elements
  void* o;
  long long so[3];      // out's (batch, head, seq) strides, in elements
  int Hq, g, Sq, Sk, d, causal, window, n_qt;
  int unit;             // 16: TMA; 8, 4 or 2: own loads of that many bytes
  int pairs;            // out takes 4-byte stores of two values
  int n_sl;             // d > 256: slices of kSlice columns
  float scale, softcap;
};

// D: d rounded up to a multiple of 64 (the columns past d are 0), or the
// slice (256) where d > 256. Byte offsets into shared memory.
template <int D, int R>
struct Cfg {
  static constexpr bool kStr = R == kStream;
  static constexpr int BK = D <= 128 ? 128 : 64;  // keys per tile
  static constexpr int NC = D / kChunk;           // 64-column chunks of O
  static constexpr int kKStages = kStr ? 4 : 2;   // K (stream: q and K) ring
  static constexpr int kVStages = 2;              // V ring
  static constexpr int kQBytes = kStr ? 0 : kBQ * D * 2;
  // one K tile, or (stream) a 64-column chunk of q's tile and of K's
  static constexpr int kKTileBytes = BK * (kStr ? kChunk : D) * 2;
  static constexpr int kKStageBytes =
      (kStr ? kBQ * kChunkBytes : 0) + kKTileBytes;
  static constexpr int kVTileBytes = BK * D * 2;
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kKStages * kKStageBytes;
  // kCluster: each consumer warpgroup's partial S (64 rows x BK keys, f32;
  // thread t's 16-byte unit u at u * 2048 + t * 16)
  static constexpr int kPartBytes = R == kCluster ? kRows * BK * 4 : 0;
  static constexpr int kPartOff = kVOff + kVStages * kVTileBytes;
  static constexpr int kBarOff = kPartOff + 2 * kPartBytes;
  // kCluster: a full, a summed and an empty barrier for each warpgroup's
  // partial
  static constexpr int kBars =
      1 + 2 * kKStages + 2 * kVStages + (R == kCluster ? 6 : 0);
  // + 1024 to align the base to the swizzle atom
  static constexpr int kSmem = kBarOff + 8 * kBars + 1024;
  static_assert(kSmem <= 232448, "shared memory a block may hold");
  // the own loads' registers: producers 56 and consumers 224 where two half
  // rows stay in flight a producer thread (d <= 128), else 40 and 232;
  // either way 128 x P + 256 x C = 384 x 168, what the block holds
  static constexpr bool kPair = R == kPlain && D <= 128;
  static constexpr int kProdRegs = kPair ? 56 : 40;
  static constexpr int kConsRegs = kPair ? 224 : 232;
  static_assert(128 * kProdRegs + 256 * kConsRegs == 384 * 168, "registers");
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

// Spins on try_wait. (No trap after a count of tries, as K1 has: the
// counter's register made ptxas serialize the wgmmas at d = 64-256.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The own loads fill a box of `rows` rows x 64 columns laid out as TMA's
// 128-byte swizzle lays it out: byte b of row r at
// r * 128 + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15)). src is the box's
// first element, rs the row stride in bytes, n the rows that exist, lim the
// bytes of a row before d (a multiple of the unit; <= 0 or >= 128 where the
// box is past d or inside it); zeros elsewhere, on every fill.

__device__ __forceinline__ void st_shared4(uint32_t a, uint32_t x, uint32_t y,
                                           uint32_t z, uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(x),
               "r"(y), "r"(z), "r"(w));
}

// Half h of box row r (box bytes 64h .. 64h + 63, `live` of them live,
// even) from L, the 5 aligned 16-byte words that hold them, the first at
// byte `off` (even) of L: lane off / 4 is moved to the front in place (L[i]
// reads lanes >= i), then out lane m (bytes 4m .. 4m + 3) is lanes m, m + 1
// shifted by the rest of the offset, zeros at and past the live bytes;
// its four 16-byte units go to their swizzled slots of the box at `box`.
__device__ __forceinline__ void store_half(uint32_t (&L)[20], int off,
                                           int live, int h, uint32_t box,
                                           int r) {
  const int q = off >> 2;
#pragma unroll
  for (int i = 0; i < 17; ++i)
    L[i] = q == 0 ? L[i] : q == 1 ? L[i + 1] : q == 2 ? L[i + 2] : L[i + 3];
  const int sh = (off & 3) * 8;
  const uint32_t row = box + r * kChunkBytes;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int u = 4 * h + j;
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = 4 * j + e;
      const uint32_t x = __funnelshift_r(L[m], L[m + 1], sh);
      o[e] = 4 * m >= live ? 0u : 4 * m + 2 == live ? x & 0xffffu : x;
    }
    st_shared4(row + ((u ^ (r & 7)) << 4), o[0], o[1], o[2], o[3]);
  }
}

// Half h of row r of a box: its live bytes and the offset of their first,
// and the aligned 16-byte words that hold them (at most 5, only those) read
// into L.
__device__ __forceinline__ void load_half(uint32_t (&L)[20], int& off,
                                          int& live, const uint8_t* src,
                                          long long rs, int r, int h, int n,
                                          int lim) {
  live = r < n ? max(0, min(lim - 64 * h, 64)) : 0;
  const uint8_t* p = src + r * rs + 64 * h;
  off = (int)(reinterpret_cast<uintptr_t>(p) & 15);
  const uint4* w = reinterpret_cast<const uint4*>(p - off);
  const int nw = live > 0 ? (off + live + 15) >> 4 : 0;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (j < nw) x = __ldg(w + j);
    L[4 * j] = x.x;
    L[4 * j + 1] = x.y;
    L[4 * j + 2] = x.z;
    L[4 * j + 3] = x.w;
  }
}

// nb boxes of `rows` rows (box b: columns 64b .. 64b + 63 of src's rows,
// at dst + b * box_bytes) by 16-byte loads realigned in registers (any
// unit): the fill's half rows k = b * 2 rows + h * rows + r are
// taken by thread pt as k = pt, pt + 128, ..., each read by load_half and
// realigned by store_half; kPair: two of them (k, k + 128) in flight at
// once.
template <bool kPair>
__device__ __forceinline__ void own_fill_realign(uint32_t dst,
                                                 uint32_t box_bytes, int nb,
                                                 const uint8_t* src,
                                                 long long rs, int rows,
                                                 int n, int lim, int pt) {
  constexpr int kStep = (kPair ? 2 : 1) * kProducers;
  const int all = nb * rows * 2;
  auto at = [&](int k, int& b, int& r, int& h) {
    b = k / (2 * rows);
    const int i = k - b * 2 * rows;
    h = i >= rows;
    r = i - h * rows;
  };
  for (int k = pt; k < all; k += kStep) {
    uint32_t L[20];
    int off, live, b, r, h;
    at(k, b, r, h);
    load_half(L, off, live, src + b * kChunkBytes, rs, r, h, n,
              lim - b * kChunkBytes);
    if (kPair && k + kProducers < all) {
      uint32_t M[20];
      int off2, live2, b2, r2, h2;
      at(k + kProducers, b2, r2, h2);
      load_half(M, off2, live2, src + b2 * kChunkBytes, rs, r2, h2, n,
                lim - b2 * kChunkBytes);
      store_half(L, off, live, h, dst + b * box_bytes, r);
      store_half(M, off2, live2, h2, dst + b2 * box_bytes, r2);
    } else {
      store_half(L, off, live, h, dst + b * box_bytes, r);
    }
  }
}

// Lane i of the lanes L holds, moved q (runtime, 0..3) lanes down; lanes past
// the N held read as 0.
template <int N>
__device__ __forceinline__ uint32_t lane_q(const uint32_t (&L)[N], int i,
                                           int q) {
  auto at = [&](int k) { return k < N ? L[k] : 0u; };
  return q == 0 ? at(i) : q == 1 ? at(i + 1) : q == 2 ? at(i + 2) : at(i + 3);
}

// Whole rows (nb <= 2 boxes of `rows` rows, as own_fill_realign takes them)
// where a row's live bytes and their offset fit 10 aligned 16-byte words
// (at most 146 live bytes): thread pt takes rows pt, pt + 128, ..., reads
// the words that hold a row's live bytes (only those) at once and emits
// its 2 nb half rows from them, one round trip a row.
template <int NB>
__device__ __forceinline__ void own_rows_whole(uint32_t dst,
                                               uint32_t box_bytes,
                                               const uint8_t* src,
                                               long long rs, int rows, int n,
                                               int lim, int pt) {
  for (int r = pt; r < rows; r += kProducers) {
    const uint8_t* p = src + r * rs;
    const int off = (int)(reinterpret_cast<uintptr_t>(p) & 15);
    const int all = r < n ? max(0, min(lim, 128 * NB)) : 0;
    const uint4* w = reinterpret_cast<const uint4*>(p - off);
    const int nw = all > 0 ? (off + all + 15) >> 4 : 0;  // at most 10
    uint32_t L[40];
#pragma unroll
    for (int j = 0; j < 10; ++j) {
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (j < nw) x = __ldg(w + j);
      L[4 * j] = x.x;
      L[4 * j + 1] = x.y;
      L[4 * j + 2] = x.z;
      L[4 * j + 3] = x.w;
    }
    const int q = off >> 2, sh = (off & 3) * 8;
#pragma unroll
    for (int hb = 0; hb < 2 * NB; ++hb) {
      const int live = max(0, min(all - 64 * hb, 64));
      const uint32_t row = dst + (hb >> 1) * box_bytes + r * kChunkBytes;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = 4 * j + e, i = 16 * hb + m;
          const uint32_t x =
              __funnelshift_r(lane_q(L, i, q), lane_q(L, i + 1, q), sh);
          o[e] = 4 * m >= live ? 0u : 4 * m + 2 == live ? x & 0xffffu : x;
        }
        const int u = 4 * (hb & 1) + j;
        st_shared4(row + ((u ^ (r & 7)) << 4), o[0], o[1], o[2], o[3]);
      }
    }
  }
}

// Thread-block clusters (kCluster). barrier.cluster: every non-exited
// thread of the cluster arrives (release), then waits (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// The address of the same shared-memory byte in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}
// An arrive on a barrier of any CTA of the cluster (`addr` from mapa),
// with mbarrier.arrive's own CTA-scope release; the waits acquire at CTA
// scope too. What the exchange orders by it lies in shared memory, read and
// written only in place: a warpgroup's stores to its own buffer are
// performed before its named barrier returns, and its elected thread
// arrives after that, so a peer that sees the phase reads them over
// distributed shared memory; a peer's reads have returned before its arrive
// on empty. This relies on the hardware: the PTX memory model orders
// threads of different CTAs only at cluster scope. Its forms cost too much
// here (NVIDIA H100 80GB HBM3, 700.00 W; benchmarks_torch/wide_variants.py;
// PERF.md §6): a release at cluster scope on each remote arrive
// took the route 1.4x as long at d = 512 and 3.3x at d = 4096 (16 CTAs),
// and 1.12-1.17x with the n arrives spread over n threads, slower at d =
// 512 than the streaming route it replaced (acquiring at cluster scope
// costs nothing).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_shared4f(uint32_t a, float x, float y,
                                            float z, float w) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "f"(x),
               "f"(y), "f"(z), "f"(w)
               : "memory");
}
// The 128 threads of consumer warpgroup cw (named barrier 3 + cw).
__device__ __forceinline__ void wg_sync(int cw) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(3 + cw) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle; offsets in bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// The two consumer warpgroups take turns to issue their products (named
// barriers 1 and 2), so that one's softmax runs under the other's products.
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of in-flight accumulators
// across the wgmma issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Two values of T from two floats (round to nearest), as one register, and
// back.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  if constexpr (kHalf<T>) {
    const __half2 v = __floats2half2_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t r) {
  if constexpr (kHalf<T>)
    return __half22float2(*reinterpret_cast<const __half2*>(&r));
  else
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

#define FA_ACC32 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31" \
  "}"
#define FA_OUT32(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define FA_ACC64 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63" \
  "}"
#define FA_OUT64(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define FA_ACC128 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, " \
  "%8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, " \
  "%88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, " \
  "%120, %121, %122, %123, %124, %125, %126, %127" \
  "}"
#define FA_OUT128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), \
  "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), \
  "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
  "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), \
  "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
  "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
  "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), \
  "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
  "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
  "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
  "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), \
  "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
  "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), \
  "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
  "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
  "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), \
  "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), \
  "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), \
  "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), \
  "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
  "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), \
  "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), \
  "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), \
  "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), \
  "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
  "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), \
  "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
  "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
  "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), \
  "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
  "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), \
  "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

// D (64 x N, f32) (+)= A (64 x 16, smem) * B (16 x N, smem), both K-major;
// N = 64 or 128, the two types' forms.
#define FA_SS(ACC, OUT, P, TY)                                              \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\n"               \
               "wgmma.mma_async.sync.aligned.m64n" FA_N "k16.f32." TY "." TY  \
               " " ACC ", %" FA_A ", %" FA_B ", p, 1, 1, 0, 0;\n}\n"        \
               : OUT(d)                                                    \
               : "l"(a), "l"(b), "r"(scale_d))
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
#define FA_N "64"
#define FA_A "32"
#define FA_B "33"
  if constexpr (kHalf<T>)
    FA_SS(FA_ACC32, FA_OUT32, "34", "f16");
  else
    FA_SS(FA_ACC32, FA_OUT32, "34", "bf16");
#undef FA_N
#undef FA_A
#undef FA_B
}
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
#define FA_N "128"
#define FA_A "64"
#define FA_B "65"
  if constexpr (kHalf<T>)
    FA_SS(FA_ACC64, FA_OUT64, "66", "f16");
  else
    FA_SS(FA_ACC64, FA_OUT64, "66", "bf16");
#undef FA_N
#undef FA_A
#undef FA_B
}
#undef FA_SS

// D (64 x N, f32) += A (64 x 16, registers) * B (16 x N, smem, MN-major);
// N = 64, 128 or 256.
#define FA_RS(N, ACC, OUT, A0, A1, A2, A3, B, TY)                           \
  asm volatile("wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY    \
               " " ACC ", {%" A0 ", %" A1 ", %" A2 ", %" A3 "}, %" B         \
               ", 1, 1, 1, 1;\n"                                            \
               : OUT(d)                                                    \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b))
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kHalf<T>)
    FA_RS("64", FA_ACC32, FA_OUT32, "32", "33", "34", "35", "36", "f16");
  else
    FA_RS("64", FA_ACC32, FA_OUT32, "32", "33", "34", "35", "36", "bf16");
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kHalf<T>)
    FA_RS("128", FA_ACC64, FA_OUT64, "64", "65", "66", "67", "68", "f16");
  else
    FA_RS("128", FA_ACC64, FA_OUT64, "64", "65", "66", "67", "68", "bf16");
}
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b) {
  if constexpr (kHalf<T>)
    FA_RS("256", FA_ACC128, FA_OUT128, "128", "129", "130", "131", "132",
          "f16");
  else
    FA_RS("256", FA_ACC128, FA_OUT128, "128", "129", "130", "131", "132",
          "bf16");
}
#undef FA_RS

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int N>
__device__ __forceinline__ void fence_frags(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// S (64 x BK) = Q (64 x D) . K^T over d in steps of 16: 32 bytes inside a
// swizzled 64-column chunk, the next chunk one chunk tile further.
template <typename T, int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Cfg<D, false>::BK / 2],
                                         uint32_t q_smem, uint32_t k_smem) {
  constexpr int BK = Cfg<D, false>::BK;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in = (kk % 4) * 32;
    wgmma_ss<T>(sc,
                desc_sw128(q_smem + (kk / 4) * kRows * kChunkBytes + in, 16,
                           1024),
                desc_sw128(k_smem + (kk / 4) * BK * kChunkBytes + in, 16,
                           1024),
                kk > 0);
  }
}

// O (64 x D) += P (64 x BK, registers) . V (BK x D). V is MN-major: 8-key
// groups 1024 bytes apart (SBO), 64-column chunks one chunk tile apart (LBO).
template <typename T, int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&p)[Cfg<D, false>::BK / 16]
                                                      [4],
                                         uint32_t v_smem) {
  constexpr int BK = Cfg<D, false>::BK;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<T>(o, p[kk],
                desc_sw128(v_smem + kk * 16 * kChunkBytes, BK * kChunkBytes,
                           1024));
}

// kCluster: the exchange of one key tile's partial S between the n CTAs of
// the cluster, in each consumer warpgroup (cw; t its thread). The
// warpgroup's partial (sc, 64 rows x BK keys) goes to its buffer `part`
// (this thread's first 16-byte unit; unit u at u * 2048), and sc comes back
// as the sum of the n CTAs' partials in rank order, 0, 1, ..., n - 1: the
// same bits in every CTA. bar: this warpgroup's three barriers, each n
// arrivals a phase (one from each CTA's elected thread): full (every CTA's
// partial is written), summed (every CTA's own units are summed) and empty
// (every CTA has read this one's buffer, which tile it + 1 may then
// overwrite).
// - n <= 2: each thread reads its units from every CTA and sums them.
// - n > 2: CTA me owns the units u with u % n == me; it sums each of them
//   over the n CTAs (its loads of one unit in flight together) and writes
//   the sum in place, then reads every other unit's sum from its owner:
//   about 2 rounds of remote loads a tile instead of n (4 ranks' or 4
//   units' loads in flight at once, which keeps the warpgroup's registers
//   unspilled).
template <int BK>
__device__ __forceinline__ void exchange(float (&sc)[BK / 2], uint32_t part,
                                         uint32_t bar, int it, int n, int me,
                                         int cw, int t) {
  constexpr int kU = BK / 8;                    // a thread's 16-byte units
  constexpr uint32_t kStep = kProducers * 16;   // bytes from unit to unit
  constexpr int kBatch = 4;                     // ranks' loads in flight
  const uint32_t full = bar, summed = bar + 8, empty = bar + 16;
  auto signal = [&](uint32_t b) {  // this warpgroup's writes or reads done
    wg_sync(cw);
    if (t == 0)
      for (int r = 0; r < n; ++r) mbar_arrive_cluster(mapa(b, (uint32_t)r));
  };
  if (it > 0) mbar_wait(empty, (it - 1) & 1);
#pragma unroll
  for (int u = 0; u < kU; ++u)
    st_shared4f(part + u * kStep, sc[4 * u], sc[4 * u + 1], sc[4 * u + 2],
                sc[4 * u + 3]);
  signal(full);
  mbar_wait(full, it & 1);
  if (n <= 2) {
    for (int r = 0; r < n; ++r) {
      const uint32_t src = mapa(part, (uint32_t)r);
      float4 v[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) v[u] = ld_cluster4(src + u * kStep);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float x[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sc[4 * u + c] = r == 0 ? x[c] : sc[4 * u + c] + x[c];
      }
    }
  } else {
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      if (u % n != me) continue;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int r0 = 0; r0 < n; r0 += kBatch) {
        float4 v[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j)
          if (r0 + j < n)
            v[j] = ld_cluster4(mapa(part + u * kStep, (uint32_t)(r0 + j)));
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (r0 + j >= n) break;
          const float x[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[c] = r0 + j == 0 ? x[c] : acc[c] + x[c];
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[4 * u + c] = acc[c];
      st_shared4f(part + u * kStep, acc[0], acc[1], acc[2], acc[3]);
    }
    signal(summed);
    mbar_wait(summed, it & 1);
#pragma unroll
    for (int u0 = 0; u0 < kU; u0 += kU / 2) {  // half the units at a time
      float4 v[kU / 2];
#pragma unroll
      for (int u = u0; u < u0 + kU / 2; ++u)
        if (u % n != me)
          v[u - u0] = ld_cluster4(mapa(part + u * kStep, (uint32_t)(u % n)));
#pragma unroll
      for (int u = u0; u < u0 + kU / 2; ++u)
        if (u % n != me) {
          sc[4 * u] = v[u - u0].x;
          sc[4 * u + 1] = v[u - u0].y;
          sc[4 * u + 2] = v[u - u0].z;
          sc[4 * u + 3] = v[u - u0].w;
        }
    }
  }
  signal(empty);
}

// Fills the rings: q once (not kStream), then per key tile K (kStream: q's
// and K's 64-column chunks) and V, by TMA (one thread) or by the producer
// warpgroup's own loads (all 128; `pt` the thread). A stage's full barrier
// takes one expect_tx arrive (TMA) or an arrive from every producer thread
// after its stores. q, K and V from column col0 (kCluster: the CTA's
// slice; kStream: q and K from 0).
template <typename T, int D, int R, bool kTma>
__device__ __forceinline__ void produce(const Args& a, uint32_t base,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int b, int h,
                                        int hk, int q0, int k_first,
                                        int n_tiles, int col0, int pt) {
  using C = Cfg<D, R>;
  constexpr int BK = C::BK;
  constexpr bool kStr = R == kStream;
  const uint32_t q_full = base + C::kBarOff;
  const uint32_t k_full = q_full + 8;
  const uint32_t v_full = k_full + 8 * C::kKStages;
  const uint32_t k_empty = v_full + 8 * C::kVStages;
  const uint32_t v_empty = k_empty + 8 * C::kKStages;
  // the own loads: whole rows where a row's live bytes fit 10 words (d <=
  // 128 only, every fill from column 0), whatever the unit
  const bool whole =
      C::kPair && a.unit != 16 && min(2 * a.d, C::NC * kChunkBytes) <= 146;
  // `rows` rows from row r of q (0), k (1) or v (2), nb boxes of 64 columns
  // from column c, box i at dst + i * rows * 128
  auto fill = [&](int t, uint32_t dst, uint32_t bar, int nb, int c, int r,
                  int rows) {
    const int hh = t == 0 ? h : hk;
    const uint32_t box_bytes = rows * kChunkBytes;
    if constexpr (kTma) {
      for (int i = 0; i < nb; ++i)
        tma_load(dst + i * box_bytes, t == 0 ? tq : t == 1 ? tk : tv, bar,
                 c + i * kChunk, r, hh, b);
    } else {
      const long long* st = a.st[t];
      const uint8_t* src = static_cast<const uint8_t*>(a.src[t]) +
                           2 * (b * st[0] + hh * st[1] + r * st[2] + c);
      const int n = (t == 0 ? a.Sq : a.Sk) - r, lim = 2 * (a.d - c);
      const long long rs = 2 * st[2];
      if constexpr (C::kPair) {
        if (whole) {
          own_rows_whole<C::NC>(dst, box_bytes, src, rs, rows, n, lim, pt);
          return;
        }
      }
      own_fill_realign<C::kPair>(dst, box_bytes, nb, src, rs, rows, n, lim,
                                 pt);
    }
  };
  auto begin = [&](uint32_t bar, uint32_t bytes) {
    if constexpr (kTma) mbar_expect_tx(bar, bytes);
  };
  auto end = [&](uint32_t bar) {
    if constexpr (!kTma) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(bar);
    }
  };
  if constexpr (!kStr) {
    begin(q_full, C::kQBytes);
    for (int c = 0; c < kBQ / kRows; ++c)
      fill(0, base + c * C::NC * kRows * kChunkBytes, q_full, C::NC, col0,
           q0 + c * kRows, kRows);
    end(q_full);
  }
  const int nc = kStr ? (a.d + kChunk - 1) / kChunk : 1;
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_first + it * BK;
    for (int c = 0; c < nc; ++c) {
      const int n = it * nc + c, s = n % C::kKStages;
      const uint32_t stage = base + C::kKOff + s * C::kKStageBytes;
      mbar_wait(k_empty + 8 * s, ((n / C::kKStages) & 1) ^ 1);
      begin(k_full + 8 * s, C::kKStageBytes);
      if constexpr (kStr) {
        for (int r = 0; r < kBQ / kRows; ++r)
          fill(0, stage + r * kRows * kChunkBytes, k_full + 8 * s, 1,
               c * kChunk, q0 + r * kRows, kRows);
        fill(1, stage + kBQ * kChunkBytes, k_full + 8 * s, 1, c * kChunk, k0,
             BK);
      } else {
        fill(1, stage, k_full + 8 * s, C::NC, col0, k0, BK);
      }
      end(k_full + 8 * s);
    }
    const int s = it % C::kVStages;
    const uint32_t stage = base + C::kVOff + s * C::kVTileBytes;
    mbar_wait(v_empty + 8 * s, ((it / C::kVStages) & 1) ^ 1);
    begin(v_full + 8 * s, C::kVTileBytes);
    fill(2, stage, v_full + 8 * s, C::NC, col0, k0, BK);
    end(v_full + 8 * s);
  }
}

// kTma: the producers fill the rings by TMA (one thread), else by their own
// loads (all 128), an instance of its own so that the TMA instance carries
// none of that code: the own loads need more than 24 registers, so that
// instance gives its producers 40 and its consumers 232 (56 and 224 where
// two half rows stay in flight, Cfg::kPair). Either way the block keeps the
// 384 x 168 registers it was launched with: consumers can only grow by what
// the producers gave up (128 x 24 + 256 x 240 = 64,512), or setmaxnreg.inc
// waits for ever.
template <typename T, int D, int R, bool kTma>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                            __grid_constant__ const CUtensorMap tk,
                            __grid_constant__ const CUtensorMap tv,
                            const Args a) {
  using C = Cfg<D, R>;
  constexpr int BK = C::BK;
  constexpr bool kStr = R == kStream;
  constexpr bool kClu = R == kCluster;
  // float16 takes P as one product, bfloat16 as two (P_hi, P_lo)
  constexpr int kParts = kHalf<T> ? 1 : 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + C::kBarOff;
  const uint32_t k_full = q_full + 8;                  // + 8 s
  const uint32_t v_full = k_full + 8 * C::kKStages;    // + 8 s
  const uint32_t k_empty = v_full + 8 * C::kVStages;   // + 8 s
  const uint32_t v_empty = k_empty + 8 * C::kKStages;  // + 8 s
  // kCluster: each consumer warpgroup's exchange barriers, + 24 cw
  const uint32_t x_bars = v_empty + 8 * C::kVStages;

  // the block's q tile and output slice from (y, z): kStream t + n_qt *
  // slice; kCluster slice + n_sl * t (a cluster: the slices of one tile)
  const unsigned lin = blockIdx.y + gridDim.y * blockIdx.z;
  const unsigned n_qt = (unsigned)a.n_qt;
  const unsigned n_sl = R == kPlain ? 1u : (unsigned)a.n_sl;
  if (lin >= n_qt * n_sl) return;  // past the last tile: the grid's rounding
  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.g;
  const int qt = kStr ? (int)(lin % n_qt)
                 : kClu ? (int)(lin / n_sl)
                        : (int)lin;
  const int q0 = (a.n_qt - 1 - qt) * kBQ;  // heaviest tiles first
  const int col0 = kStr ? (int)(lin / n_qt) * kSlice
                   : kClu ? (int)(lin % n_sl) * kSlice
                          : 0;
  // the key tiles any row of this q tile can see
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_first =
      a.window > 0 ? (max(0, q0 - a.window + 1) / BK) * BK : 0;
  const int n_tiles = k_end > k_first ? (k_end - k_first + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    constexpr uint32_t fills = kTma ? 1 : kProducers;
    mbar_init(q_full, fills);
    for (int s = 0; s < C::kKStages; ++s) {
      mbar_init(k_full + 8 * s, fills);
      mbar_init(k_empty + 8 * s, 2 * 128);  // every consumer thread
    }
    for (int s = 0; s < C::kVStages; ++s) {
      mbar_init(v_full + 8 * s, fills);
      mbar_init(v_empty + 8 * s, 2 * 128);
    }
    if constexpr (kClu)  // one elected arrive from every CTA
      for (int i = 0; i < 6; ++i) mbar_init(x_bars + 8 * i, n_sl);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every CTA's barriers are initialised before any remote arrive
  if constexpr (kClu) {
    cluster_arrive();
    cluster_wait();
  }

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
                     kTma ? 24 : C::kProdRegs)
                 : "memory");
    if (!kTma || threadIdx.x == 0)
      produce<T, D, R, kTma>(a, base, &tq, &tk, &tv, b, h, hk, q0, k_first,
                             n_tiles, col0, threadIdx.x);
    if constexpr (kClu) {  // every thread takes the cluster's last barrier
      __syncwarp();
      cluster_arrive();
      cluster_wait();
    }
    return;
  }

  // consumer warpgroup cw owns q rows qc0 .. qc0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
                   kTma ? 240 : C::kConsRegs)
               : "memory");
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int qc0 = q0 + cw * kRows;
  // this thread's rows (fragment halves i = 0, 1) and column pair offset
  const int row0 = qc0 + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  const uint32_t q_smem = base + cw * C::NC * kRows * kChunkBytes;
  const int nc = kStr ? (a.d + kChunk - 1) / kChunk : 1;
  // scores are kept in log2 units: y = log2(e) * score. The parameters the
  // score loops use are read into registers once.
  const int Sk = a.Sk, window = a.window;
  const bool causal = a.causal;
  const float softcap = a.softcap, scale_log2 = a.scale * kLog2e;
  const float cap_scale = a.scale / a.softcap;
  const float softcap_log2 = a.softcap * kLog2e;

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  // Each iteration issues S = Q.K^T for its tile behind the previous tile's
  // P.V in the tensor pipe and waits for both; S is a fresh accumulator every
  // time (a loop-carried one makes ptxas serialize every wgmma). A turn
  // spans P.V(it - 1) and S(it): warpgroup 0 takes the first, and each
  // warpgroup passes the turn once per turn it took.
  if constexpr (!kStr) {
    mbar_wait(q_full, 0);
    if (cw == 1 && n_tiles > 0) turn_pass(cw);
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int sv = it % C::kVStages;
    const uint32_t phase_v = (it / C::kVStages) & 1;
    const int k0 = k_first + it * BK;
    float sc[BK / 2];
    if constexpr (kStr) {
      // S over d, a chunk of q and K per stage
      for (int c = 0; c < nc; ++c) {
        const int n = it * nc + c, s = n % C::kKStages;
        const uint32_t stage = base + C::kKOff + s * C::kKStageBytes;
        mbar_wait(k_full + 8 * s, (n / C::kKStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk)
          wgmma_ss<T>(sc,
                      desc_sw128(stage + cw * kRows * kChunkBytes + kk * 32,
                                 16, 1024),
                      desc_sw128(stage + kBQ * kChunkBytes + kk * 32, 16,
                                 1024),
                      c > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        mbar_arrive(k_empty + 8 * s);
      }
      fence_regs(o);
    } else {
      const int s = it % C::kKStages;
      if (it == 0) turn_wait(cw);
      mbar_wait(k_full + 8 * s, (it / C::kKStages) & 1);
      issue_qk<T, D>(sc, q_smem, base + C::kKOff + s * C::kKStageBytes);
      wgmma_commit();
      turn_pass(cw);
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(o);
      mbar_arrive(k_empty + 8 * s);
      // the partial S over this CTA's columns to the sum over d
      if constexpr (kClu)
        exchange<BK>(sc, base + C::kPartOff + cw * C::kPartBytes + t * 16,
                     x_bars + 24 * cw, it, (int)n_sl, col0 / kSlice, cw, t);
    }
    if (it > 0) mbar_arrive(v_empty + 8 * ((it - 1) % C::kVStages));

    // scores to log2 units, softcap, masks, each a loop of its own so the
    // common tile runs one multiply per score; sc[4j + 2i + c] is row
    // row0 + 8i, key k0 + 8j + col + c
    if (softcap != 0.f) {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e)
        sc[e] = softcap_log2 * tanhf(sc[e] * cap_scale);
    } else {
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) sc[e] *= scale_log2;
    }
    if (k0 + BK > Sk || (causal && k0 + BK - 1 > qc0) ||
        (window > 0 && qc0 + kRows - 1 - k0 >= window)) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int kp = k0 + 8 * j + col + c, qp = row0 + 8 * i;
            float& y = sc[4 * j + 2 * i + c];
            if (kp >= Sk)
              y = -INFINITY;
            else if ((causal && qp < kp) || (window > 0 && qp - kp >= window))
              y = kMasked;
          }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = ex2(m[i] - mx[i]);
      m[i] = mx[i];
    }

    // P in kParts parts of T, laid out as the A fragment of m64nDk16: for
    // keys 16kk.., register r holds sc[8kk + 2r], sc[8kk + 2r + 1] (row half
    // r & 1)
    uint32_t p[kParts][BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r & 1, e = 8 * kk + 2 * r;
        const float p0 = ex2(sc[e] - m[i]), p1 = ex2(sc[e + 1] - m[i]);
        rs[i] += p0 + p1;
        p[0][kk][r] = pack2<T>(p0, p1);
        if constexpr (kParts == 2) {
          const float2 back = unpack2<T>(p[0][kk][r]);
          p[1][kk][r] = pack2<T>(p0 - back.x, p1 - back.y);
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        o[4 * j + 2 * i] *= corr[i];
        o[4 * j + 2 * i + 1] *= corr[i];
      }

    // O += P.V (P_hi.V + P_lo.V for bfloat16), waited for with the next
    // tile's S
    fence_regs(o);
#pragma unroll
    for (int q = 0; q < kParts; ++q) fence_frags(p[q]);
    mbar_wait(v_full + 8 * sv, phase_v);
    if constexpr (!kStr) turn_wait(cw);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kParts; ++q)
      issue_pv<T, D>(o, p[q], base + C::kVOff + sv * C::kVTileBytes);
    wgmma_commit();
  }
  // the last turn: warpgroup 1 has none left to take
  if (!kStr && cw == 0 && n_tiles > 0) turn_pass(cw);
  wgmma_wait_all();
  fence_regs(o);
  // no peer reads this CTA's shared memory once this wait returns (the
  // producers take it when they are done)
  if constexpr (kClu) {
    cluster_arrive();
    cluster_wait();
  }

  // epilogue: rows past Sq and columns past d are not written
  T* out = static_cast<T*>(a.o) + b * a.so[0] + h * a.so[1] + col0;
  const int dl = a.d - col0;  // this block's columns before d
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    const int qp = row0 + 8 * i;
    if (qp >= a.Sq) continue;
    T* orow = out + (long long)qp * a.so[2];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int e = 8 * j + col;
      const float x = o[4 * j + 2 * i] / lt, y = o[4 * j + 2 * i + 1] / lt;
      if (a.pairs) {  // d even: e < d takes e + 1 too
        if (e < dl)
          *reinterpret_cast<uint32_t*>(orow + e) = pack2<T>(x, y);
      } else {
        const uint32_t xy = pack2<T>(x, y);
        if (e < dl) reinterpret_cast<uint16_t*>(orow)[e] = xy & 0xffffu;
        if (e + 1 < dl) reinterpret_cast<uint16_t*>(orow)[e + 1] = xy >> 16;
      }
    }
  }
}

// The grid for n_bh = B*Hq blocks in x and n_lin = n_qt * slices (q tile,
// slice) indices over y and z (see the kernel's head comment): y + ny * z,
// ny = n_lin up to 65535, else 65535 rounded down to a multiple of `step`
// (the cluster's y extent).
dim3 grid_of(long long n_bh, long long n_lin, int step) {
  const long long ny = n_lin < 65535 ? n_lin : 65535 - 65535 % step;
  return dim3((unsigned)n_bh, (unsigned)ny, (unsigned)((n_lin + ny - 1) / ny));
}

// The route at head dim d (ops.sm90_route).
Route route_of(int d) {
  return d <= kSlice ? kPlain : d <= kSlice * kMaxCluster ? kCluster : kStream;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver call; take it through the runtime so the
// library needs no -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (d, S, H, B) of a 2-byte tensor with (batch, head, seq)
// strides `st` (elements), boxes of 64 columns x `rows`, 128-byte swizzle.
CUresult encode(EncodeTiled fn, CUtensorMap* map, CUtensorMapDataType type,
                const void* ptr, int d, int S, int H, int B,
                const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  // a dimension of extent 1 is never stepped: give it any valid stride
  const cuuint64_t strides[3] = {
      S > 1 ? (cuuint64_t)st[2] * 2 : 16, H > 1 ? (cuuint64_t)st[1] * 2 : 16,
      B > 1 ? (cuuint64_t)st[0] * 2 : 16};
  const cuuint32_t box[4] = {kChunk, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, type, 4, const_cast<void*>(ptr), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// A launch of instance <T, D, R, kTma>; kCluster in clusters of (1, n_sl,
// 1) by cudaLaunchKernelEx. With max_active, no launch: the most such
// clusters the card holds at once (cudaOccupancyMaxActiveClusters).
template <typename T, int D, int R, bool kTma>
int launch_k(const CUtensorMap& tq, const CUtensorMap& tk,
             const CUtensorMap& tv, int B, const Args& a,
             cudaStream_t stream, int* max_active = nullptr) {
  constexpr int bytes = Cfg<D, R>::kSmem;
  auto* kernel = &flash_attention_sm90_kernel<T, D, R, kTma>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int step = R == kCluster ? a.n_sl : 1;
  const dim3 grid = grid_of(
      B * a.Hq, (long long)a.n_qt * (R == kPlain ? 1 : a.n_sl), step);
  if (R != kCluster) {
    kernel<<<grid, kThreads, bytes, stream>>>(tq, tk, tv, a);
    return (int)cudaGetLastError();
  }
  if (step > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = (unsigned)step;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (max_active)
    return (int)cudaOccupancyMaxActiveClusters(max_active, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, tq, tk, tv, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int D, int R>
int launch(const long long* st, int B, int Hkv, const Args& a,
           cudaStream_t stream) {
  // the maps are unused (left zero) where the producers load on their own
  CUtensorMap tq = {}, tk = {}, tv = {};
  if (a.unit == 16) {
    EncodeTiled fn = encoder();
    if (!fn) return (int)cudaErrorNotSupported;
    const CUtensorMapDataType type = kHalf<T>
                                         ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    constexpr int BK = Cfg<D, R>::BK;
    const int Sk = a.Sk > 0 ? a.Sk : 1;
    CUresult r = encode(fn, &tq, type, a.src[0], a.d, a.Sq, a.Hq, B, st,
                        kRows);
    if (r == CUDA_SUCCESS)
      r = encode(fn, &tk, type, a.src[1], a.d, Sk, Hkv, B, st + 3, BK);
    if (r == CUDA_SUCCESS)
      r = encode(fn, &tv, type, a.src[2], a.d, Sk, Hkv, B, st + 6, BK);
    if (r != CUDA_SUCCESS) return -(int)r;
    return launch_k<T, D, R, true>(tq, tk, tv, B, a, stream);
  }
  return launch_k<T, D, R, false>(tq, tk, tv, B, a, stream);
}

template <typename T>
int launch_t(const long long* st, int B, int Hkv, const Args& a,
             cudaStream_t s) {
  const Route r = route_of(a.d);
  if (r == kStream) return launch<T, 256, kStream>(st, B, Hkv, a, s);
  if (r == kCluster) return launch<T, 256, kCluster>(st, B, Hkv, a, s);
  if (a.d <= 64) return launch<T, 64, kPlain>(st, B, Hkv, a, s);
  if (a.d <= 128) return launch<T, 128, kPlain>(st, B, Hkv, a, s);
  return launch<T, 256, kPlain>(st, B, Hkv, a, s);
}

}  // namespace

// C entry for ctypes. q, k, v and out of one type, dtype 1 = bfloat16, 2 =
// float16. strides: 12 int64, the (batch, head, seq) strides in elements of
// q, k, v and out, in that order (the last dimension of each is
// contiguous). unit (ops._sm90_unit): 16 reads q, k and v by TMA, which
// needs each base 16-byte aligned and every stride of a dimension longer
// than 1 a multiple of 8 elements; 8, 4 or 2 by the producers' own loads of
// that many bytes, which needs the bases, those strides and d * 2 bytes to
// be multiples of it. Any d >= 1 and Sq >= 1: B Hq up to 2^31 - 1 (the
// grid's x) and q tiles of 128 rows times slices of 256 columns past d =
// 256 up to 65,535^2 (its y and z; 256 < d <= 4096 y a whole number of
// clusters). Launches on `stream` of `device` and returns 0 when the
// launch was accepted, a CUDA error, or -CUresult when a tensor
// map could not be encoded; arguments it does not take return
// cudaErrorInvalidValue without launching.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out,
                                           const long long* strides, int B,
                                           int Hq, int Hkv, int Sq, int Sk,
                                           int d, int causal, int window,
                                           float scale, float softcap,
                                           int dtype, int unit, int device,
                                           void* stream) {
  const long long n_qt = ((long long)Sq + kBQ - 1) / kBQ;
  const long long n_sl = d > kSlice ? ((long long)d + kSlice - 1) / kSlice : 1;
  const int step = d > 0 && route_of(d) == kCluster ? (int)n_sl : 1;
  bool ok = B > 0 && Hq > 0 && Hkv > 0 && Hq % Hkv == 0 && Sq > 0 && Sk >= 0 &&
            d > 0 && window >= 0 && (long long)B * Hq <= 0x7fffffffLL &&
            n_qt * n_sl <= (65535LL - 65535 % step) * 65535 &&
            (dtype == 1 || dtype == 2) &&
            (unit == 16 || unit == 8 || unit == 4 || unit == 2) &&
            (unit == 16 || (2 * d) % unit == 0);
  const void* ptrs[3] = {q, k, v};
  const int extent[3][3] = {{B, Hq, Sq}, {B, Hkv, Sk}, {B, Hkv, Sk}};
  for (int t = 0; t < 3; ++t) {
    ok = ok && reinterpret_cast<uintptr_t>(ptrs[t]) % unit == 0;
    for (int i = 0; i < 3; ++i)
      ok = ok && (extent[t][i] <= 1 || (2 * strides[3 * t + i]) % unit == 0);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  for (int t = 0; t < 3; ++t) {
    a.src[t] = ptrs[t];
    for (int i = 0; i < 3; ++i) a.st[t][i] = strides[3 * t + i];
  }
  a.o = out;
  bool pairs = reinterpret_cast<uintptr_t>(out) % 4 == 0 && d % 2 == 0;
  for (int i = 0; i < 3; ++i) {
    a.so[i] = strides[9 + i];
    pairs = pairs && strides[9 + i] % 2 == 0;
  }
  a.pairs = pairs;
  a.unit = unit;
  a.Hq = Hq;
  a.g = Hq / Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.d = d;
  a.causal = causal != 0;
  a.window = window;
  a.n_qt = (int)n_qt;
  a.n_sl = (int)n_sl;
  a.scale = scale;
  a.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_t<__nv_bfloat16>(strides, B, Hkv, a, s)
                    : launch_t<__half>(strides, B, Hkv, a, s);
}

// The launch configuration for head_dim d >= 1, either type: q rows per
// block, keys per tile and dynamic shared memory bytes, for the callers'
// checks and reports (d > 256: of a CTA of one 256-column slice).
extern "C" void flash_attention_sm90_config(int d, int* block_q, int* block_k,
                                            int* smem_bytes) {
  const Route r = route_of(d);
  *block_q = kBQ;
  *block_k = d <= 128 ? Cfg<128, kPlain>::BK : Cfg<256, kPlain>::BK;
  *smem_bytes = r == kCluster  ? Cfg<256, kCluster>::kSmem
                : r == kStream ? Cfg<256, kStream>::kSmem
                : d <= 64      ? Cfg<64, kPlain>::kSmem
                : d <= 128     ? Cfg<128, kPlain>::kSmem
                               : Cfg<256, kPlain>::kSmem;
}

// The route at head dim d >= 1 (0 d <= 256, 1 the cluster route, 2 the
// streaming route) and its CTAs a cluster (1 but on the cluster route); on
// the cluster route, with `device` >= 0, the most such clusters the card
// holds at once (cudaOccupancyMaxActiveClusters, TMA's instance, bfloat16),
// else 0. Returns the CUDA error.
extern "C" int flash_attention_sm90_clusters(int d, int device, int* route,
                                             int* cluster, int* max_active) {
  if (d <= 0) return (int)cudaErrorInvalidValue;
  *route = (int)route_of(d);
  *cluster = *route == kCluster ? (d + kSlice - 1) / kSlice : 1;
  *max_active = 0;
  if (*route != kCluster || device < 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = {};
  a.Hq = 1;
  a.n_qt = 1;
  a.n_sl = *cluster;
  const CUtensorMap none = {};
  return launch_k<__nv_bfloat16, 256, kCluster, true>(none, none, none, 1, a,
                                                       0, max_active);
}
