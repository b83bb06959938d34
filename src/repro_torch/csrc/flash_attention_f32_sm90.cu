// Blocked (flash) attention forward for Hopper (sm_90a), float32: every
// product on the tensor cores as 3xTF32 (wgmma), float32 accumulation and a
// float32 online softmax.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention (the
// Pallas TPU kernel, body `_kernel`) for float32 inputs; bfloat16 and
// float16 inputs go to flash_attention_sm90.cu. Causal, sliding-window and softcapped
// attention with grouped kv heads:
//
//   q    (B, Hq, Sq, d)     k/v (B, Hkv, Sk, d)     out (B, Hq, Sq, d)
//
// each given by (batch, head, seq) strides in elements with a contiguous
// last dimension, so the caller's (B, S, H, d) -> (B, H, S, d) transposes
// stay views; q-head h reads kv-head h / g (g = Hq / Hkv), never expanded.
// Any d, any Sq, Sk (Sq != Sk) and any strides are taken.
//
// Semantics follow the TPU kernel: the score is (q.k) / sqrt(d), then the
// optional tanh softcap, then the mask (causal q_pos >= k_pos with both
// positions counted from 0, window q_pos - k_pos < window) sets it to -1e30;
// keys past Sk score -inf (they do not exist, so they weigh 0 even for a row
// that has seen only masked keys). The softmax is an online softmax in
// float32 with the running max starting at -1e30, kept in log2 units (the
// score times log2(e); a masked score is -1e30 there too, so a row that has
// seen only masked keys weighs them equally, as the TPU kernel does); the
// output is acc / max(l, 1e-30). Key tiles that lie wholly outside the
// causal or window band of the q tile are skipped, so a row that sees no key
// gets the mean of v over the keys of the tiles its q tile visited, or 0.
//
// Bound: at the model's shape (B=2, H=20, S=4096, d=128, causal) the work is
// 4 d operations per visible (q, k) pair, 171.8 GFLOP, far above the bytes
// of q, k, v and out (168 MB): 2.565 ms at the float32 CUDA-core rate. The
// float32 tolerance (atol 2e-5, rtol 2e-4) rules out single TF32 products
// (a 10-bit mantissa: 25x the bar at S=1024, d=128), so each product is
// taken as three: x = hi + lo with hi = tf32(x) (round to nearest, ties
// away, as cvt.rna.tf32.f32) and lo = x - hi, a.b = lo_a.hi_b + hi_a.lo_b +
// hi_a.hi_b. At the TF32 rate that bounds the kernel at 3 x 171.8 GFLOP /
// 495 TFLOP/s = 1.041 ms.
//
// Design. One block per (b*Hq + h, q tile), heaviest causal tiles first, the
// key tiles in order inside it (x = b*Hq + h; the grid's y and z hold the
// q tile index t, so any Sq: grid_of, ops.flash_block); one warpgroup per
// 64 q rows (two at d <= 128, one at d = 256).
//
// * Split once. Every operand is split when it is staged, never per
//   product: q once per block, each K and V tile once per block, each into
//   a hi and a lo copy in shared memory laid out as wgmma reads them
//   (K-major, 128-byte swizzle; V transposed to (d, key), 64-byte swizzle at
//   16 keys). At d <= 128 q's hi part stays in registers instead, as each
//   thread's A fragments of Q.K^T. P is split in registers.
// * Traffic. Raw K and V tiles arrive by cp.async (16-byte copies where the
//   strides allow, 4-byte copies otherwise) in buffers of their own, so the
//   next tile loads while the block computes this one: raw and hi/lo make a
//   two-deep ring. One split pass between two barriers turns raw into hi/lo
//   (then a proxy fence: wgmma reads shared memory through the async proxy).
// * S = Q.K^T: wgmma m64n{BK}k8, three products per k-step into one
//   accumulator, small terms first: lo_q.hi_k from shared memory, then
//   hi_q.lo_k and hi_q.hi_k with q's hi from registers. The score is
//   scaled, capped and masked on the accumulator fragment; the mask only on
//   tiles that cross the diagonal, the window's edge or Sk; a warpgroup
//   skips tiles wholly above its own rows' diagonal (exact: each of its rows
//   has seen a key by then).
// * O += P.V: wgmma m64n{d}k8 with P from registers. The S fragment is the A
//   fragment once the keys inside each k-step of 8 are taken in the order
//   (0, 2, 4, 6, 1, 3, 5, 7), the order in which the split pass writes V^T.
//   O is rescaled only when a row's max moved.
//
// Tiles (q rows x keys): 128 x 32 at d <= 128, 64 x 16 above; d is padded
// with zeros to 32, 64, 128 or 256. Shared memory at d = 128: q's lo 64 KiB,
// K and V^T hi/lo 64 KiB, raw K and V 32 KiB; at d = 256 q's hi and lo 128
// KiB, the rest the same. One block per SM.
//
// Past d = 256 (the wide route, flash_attention_f32_cluster_kernel) d is
// cut into slices of 128 columns, or of 256 where that lets one cluster
// cover d and 128 does not (1024 < d <= 2048; wide_cols), and a
// thread-block cluster of n =
// min(slices, 8) CTAs takes one (b*Hq + h, q tile): CTA r owns slice r.
// Each CTA has the tiles and staging of the kernel at d = its width
// (Cfg<128>: 128 x 32 tiles, two warpgroups, q's hi in registers; Cfg<256>:
// 64 x 16, one warpgroup) on its own columns of q, K and V: q split once
// and kept, its columns of each K and V tile staged and split once.
//
// * Exchange. Its products give a partial S over its columns, written to
//   shared memory. After a cluster barrier every CTA reads all n partials
//   through distributed shared memory (mapa, ld.shared::cluster) and sums
//   them in rank order 0, 1, ..., n - 1, so every CTA holds the same bits
//   of S and so the same m and l. Slices of 128 keep the partials in two
//   buffers of their own by tile parity (Wide::kTwoParts): a CTA writes
//   tile t + 1's partial only once it has passed tile t's barrier, which
//   each peer reaches only after reading tile t - 1's, so one barrier a
//   tile suffices. Slices of 256 have no room for them (225 KiB of the 227
//   a block may hold): the partial goes to K's hi tile, free once the
//   products are waited for, and a second barrier, waited for before that
//   tile is written again, keeps the peers' reads ahead of the next write.
//   A last barrier keeps every CTA until no peer reads its shared memory.
// * Pipeline. Tile t's P.V (the CTA's own columns of V) is issued once
//   tile t + 1's partial is out and before the barrier it waits at, so the
//   exchange overlaps the tensor cores' work; K and V arrive as cp.async
//   groups of their own, V's tile split after the exchange.
// * Grid. The slice is the fast part of the grid's (slice, q tile) index
//   over y and z, and y's extent is a multiple of n, so the cluster dims
//   (1, n, 1) divide the grid (grid_of, ops.flash_grid, ops.flash_block).
// * Past 8 slices the slices go in groups of 8 (one cluster each, the last
//   padded with CTAs that own no column): CTA r of every group takes the S
//   columns of slices r, r + 8, ..., staging q and K for each per key tile
//   (q cannot stay), and each group recomputes S.
//
// What bounds the wide route (benchmarks_torch/wide_variants.py on an H100
// at 700 W, d = 512, B = 1, H = 8, S = 2048, causal, clusters of 4): the
// exchange. Two partial buffers and one barrier a tile: 1.01 ms, against
// 1.09 with one buffer and two barriers; without the reads of the peers'
// partials 0.78, without the barriers too 0.69, without S's products 0.82.
// Each CTA reads 3 x 16 KiB of its peers' shared memory per 32-key tile.
// The slice width (wide_variants.py, in turns): 128 columns ran 1.41x
// faster than 256 at d = 512 and 1.89x at d = 2304 (both in groups of 8);
// 256 ran 2.89x faster at d = 1280, where 128 takes two groups that stage
// q and K for every key tile. Clusters of up to 16 CTAs of 128 columns
// (past the portable 8) lost: 1.52x slower at d = 1280 (10 CTAs; each
// reads 9 peers' partials a tile) and 1.48x at d = 2304 (groups of 16),
// at most 7 such clusters active at once.
//
// What bounds it (ablations on the H100 at the forward shape): shared
// memory traffic, not the tensor cores. Per 32-key tile the block moves
// about 384 KiB through shared memory (operand reads of the 60 wgmmas per
// warpgroup, the split's raw reads and hi/lo writes, the cp.async fills):
// 3,000 cycles at 128 bytes a cycle, as long as the 3,072 the products take
// at the TF32 peak. Keeping the three products but sharing one smem
// operand read among them is what moved it: q's hi in registers and a
// split pass the compiler can pipeline. Overlapping the split with the next
// tile's products (a second hi/lo stage, or a producer warpgroup) moved
// nothing: they share the same shared-memory bandwidth.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;           // q rows per warpgroup
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  long long sq[3], sk[3], sv[3], so[3];  // (batch, head, seq) strides
  int Hq, g, Sq, Sk, d, causal, window;
  int vec;          // k and v rows may be copied 16 bytes at a time
  float scale, softcap;
  // the wide route: slices of d, CTAs a cluster, slices with the last
  // group's padding (a multiple of ncl)
  int n_sl, ncl, nslp;
};

// The grid for n_bh = B*Hq blocks in x and n_lin (q tile counted from the
// last; on the wide route slice + nslp * tile) indices over y and z: y + ny
// * z, ny = n_lin up to 65535, else 65535 rounded down to a multiple of
// `step` (the cluster's y extent); blocks past n_lin exit at once.
dim3 grid_of(long long n_bh, long long n_lin, int step) {
  const long long ny = n_lin < 65535 ? n_lin : 65535 - 65535 % step;
  return dim3((unsigned)n_bh, (unsigned)ny, (unsigned)((n_lin + ny - 1) / ny));
}

// This block's index over the grid's y and z.
__device__ __forceinline__ unsigned block_lin() {
  return blockIdx.y + gridDim.y * blockIdx.z;
}

// D: d rounded up (32, 64, 128 or 256). Byte offsets into shared memory.
template <int D>
struct Cfg {
  static constexpr int WG = D <= 128 ? 2 : 1;   // warpgroups
  static constexpr int kThreads = 128 * WG;
  static constexpr int BQ = kRows * WG;         // q rows per block
  static constexpr int BK = D <= 128 ? 32 : 16; // keys per tile
  // q's hi part in registers (the A fragments of Q.K^T) where it fits
  // beside O, else in shared memory beside its lo part
  static constexpr bool kQRegs = D <= 128;
  static constexpr int kQBytes = BQ * D * 4;    // q lo (or hi)
  static constexpr int kKBytes = BK * D * 4;    // a K, V^T or raw tile
  static constexpr int kKOff = (kQRegs ? 1 : 2) * kQBytes;  // K hi, lo
  static constexpr int kVOff = kKOff + 2 * kKBytes;         // V^T hi, lo
  static constexpr int kRawOff = kVOff + 2 * kKBytes;       // raw K, V
  // + 1024 to align the base to the swizzle atom
  static constexpr int kSmem = kRawOff + 2 * kKBytes + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory; zeros where !ok
__device__ __forceinline__ void cp16(uint32_t dst, const float* src,
                                     bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(uint32_t dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// all but the newest cp.async group have landed
__device__ __forceinline__ void cp_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Elements [e, e + 4) of a row into shared memory, zeros at and past `lim`
// (lim = 0 for a row outside the input: `row` is then any valid address and
// nothing is read).
__device__ __forceinline__ void load4(uint32_t dst, const float* row, int e,
                                      int lim, bool vec) {
  if (vec && e + 4 <= lim) {
    cp16(dst, row + e, true);
  } else if (vec && e >= lim) {
    cp16(dst, row, false);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool ok = e + i < lim;
      cp4(dst + 4 * i, ok ? row + e + i : row, ok);
    }
  }
}

__device__ __forceinline__ void st_shared(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}
// Byte offset of 16-byte unit u of row r in a K-major tile with the 128-byte
// (rows of 32 floats) or the 64-byte (rows of 16 floats) swizzle.
__device__ __forceinline__ uint32_t sw128(int r, int u) {
  return r * 128 + ((u ^ (r & 7)) << 4);
}
__device__ __forceinline__ uint32_t sw64(int r, int u) {
  return r * 64 + ((u ^ ((r >> 1) & 3)) << 4);
}

// wgmma shared-memory descriptor, K-major, 128-byte (or 64-byte) swizzle;
// sbo: bytes between 8-row groups.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t sbo,
                                         bool sw64_mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(sw64_mode ? 2 : 1) << 62;
}

// x = hi + lo: hi is x rounded to TF32 (ties away from zero, as
// cvt.rna.tf32.f32) by integer operations, lo = x - hi exactly; the tensor
// core reads lo's top 11 significant bits.
__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
  lo = x - hi;
}
__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  split(x.x, hi.x, lo.x);
  split(x.y, hi.y, lo.y);
  split(x.z, hi.z, lo.z);
  split(x.w, hi.w, lo.w);
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
// The same for A fragments in registers, which an in-flight wgmma reads.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 16, f32) (+)= A (64 x 8, smem) . B (8 x 16, smem), both K-major TF32.
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 32, f32) (+)= A (64 x 8, smem) . B (8 x 32, smem), both K-major TF32.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 32, f32) += A (64 x 8, registers) . B (8 x 32, smem, K-major), TF32.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// D (64 x 64, f32) += A (64 x 8, registers) . B (8 x 64, smem, K-major), TF32.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// D (64 x 128, f32) += A (64 x 8, registers) . B (8 x 128, smem, K-major), TF32.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// D (64 x 256, f32) += A (64 x 8, registers) . B (8 x 256, smem, K-major), TF32.
__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}


// Thread-block clusters (the wide route). Every thread of the cluster
// arrives, then waits: the arrival releases this thread's shared-memory
// writes to the cluster, the wait acquires the others'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The address of the same shared-memory byte in CTA `rank` of the cluster,
// and 16 bytes read there.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The score side of one key tile, shared by both routes. Per warpgroup of
// 64 q rows: qc0 its first row, row0 this thread's (and row0 + 8), col its
// first key of each 8.
struct Score {
  int Sk, window, qc0, row0, col;
  bool causal;
  float softcap, scale_log2, cap_scale, softcap_log2;
};

__device__ __forceinline__ Score score_params(const Args& a, int qc0, int row0,
                                              int col) {
  return {a.Sk, a.window, qc0, row0, col, a.causal != 0, a.softcap,
          a.scale * kLog2e, a.scale / a.softcap, a.softcap * kLog2e};
}

// S (sc: 64 rows x BK keys from k0) to P: scores to log2 units, softcap,
// masks; the online max and sum (m, l); O rescaled where a row's max moved
// (O must not be in flight); P split into hi and lo as the A fragments of
// P.V (ph, pl).
template <int D, int BK>
__device__ __forceinline__ void softmax_p(const Score& sp, int k0,
                                          float (&sc)[BK / 2],
                                          float (&o)[D / 2], float (&m)[2],
                                          float (&l)[2],
                                          uint32_t (&ph)[BK / 8][4],
                                          uint32_t (&pl)[BK / 8][4]) {
  const int Sk = sp.Sk, window = sp.window, qc0 = sp.qc0, row0 = sp.row0;
  const int col = sp.col;
  const bool causal = sp.causal;
  const float softcap = sp.softcap, scale_log2 = sp.scale_log2;
  const float cap_scale = sp.cap_scale, softcap_log2 = sp.softcap_log2;
  // scores to log2 units, softcap, masks; sc[4j + 2i + c] is row row0 +
  // 8i, key k0 + 8j + col + c
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
    for (int e = 0; e < 4; ++e) mx[e / 2] = fmaxf(mx[e / 2], sc[4 * j + e]);
  float corr[2];
  bool moved = false;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    corr[i] = exp2f(m[i] - mx[i]);
    moved |= mx[i] != m[i];
    m[i] = mx[i];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int e = 0; e < BK / 2; ++e) {
    sc[e] = exp2f(sc[e] - m[(e >> 1) & 1]);
    rs[(e >> 1) & 1] += sc[e];
  }
  l[0] = l[0] * corr[0] + rs[0];
  l[1] = l[1] * corr[1] + rs[1];
  if (__any_sync(kFull, moved)) {
#pragma unroll
    for (int e = 0; e < D / 2; ++e) o[e] *= corr[(e >> 1) & 1];
  }

  // P as the A fragment of k-step kk: (row g, k t4) = key 2t4, (g + 8,
  // t4), (g, t4 + 4) = key 2t4 + 1, (g + 8, t4 + 4); hi and lo
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const float p[4] = {sc[4 * kk], sc[4 * kk + 2], sc[4 * kk + 1],
                        sc[4 * kk + 3]};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float hi, lo;
      split(p[r], hi, lo);
      ph[kk][r] = __float_as_uint(hi);
      pl[kk][r] = __float_as_uint(lo);
    }
  }
}

// O += P.V as 3xTF32 products with V^T's hi and lo tiles at v_hi and v_lo,
// committed and not waited for.
template <int D, int BK>
__device__ __forceinline__ void pv_issue(float (&o)[D / 2],
                                         const uint32_t (&ph)[BK / 8][4],
                                         const uint32_t (&pl)[BK / 8][4],
                                         uint32_t v_hi, uint32_t v_lo) {
  constexpr bool kSw64 = BK == 16;              // V^T rows of 64 bytes
  uint64_t dv_hi = desc(v_hi, kSw64 ? 512 : 1024, kSw64);
  uint64_t dv_lo = desc(v_lo, kSw64 ? 512 : 1024, kSw64);
  asm volatile("" : "+l"(dv_hi), "+l"(dv_lo));
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    wgmma_rs(o, pl[kk], dv_hi + 2 * kk);    // + 32 bytes per k-step
    wgmma_rs(o, ph[kk], dv_lo + 2 * kk);
    wgmma_rs(o, ph[kk], dv_hi + 2 * kk);
  }
  wgmma_commit();
}

// softmax_p, then P.V waited for.
template <int D, int BK>
__device__ __forceinline__ void softmax_pv(const Score& sp, int k0,
                                           float (&sc)[BK / 2],
                                           float (&o)[D / 2], float (&m)[2],
                                           float (&l)[2], uint32_t v_hi,
                                           uint32_t v_lo) {
  uint32_t ph[BK / 8][4], pl[BK / 8][4];
  softmax_p<D, BK>(sp, k0, sc, o, m, l, ph, pl);
  pv_issue<D, BK>(o, ph, pl, v_hi, v_lo);
  wgmma_wait_all();
  fence_regs(o);
}

// out = O / max(l, 1e-30) for this thread's rows, O's columns from col0;
// rows past Sq and columns past d are not written.
template <int D>
__device__ __forceinline__ void store_out(const Args& a, int b, int h,
                                          const Score& sp, int col0,
                                          float (&o)[D / 2], float (&l)[2]) {
  const int dl = a.d - col0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(kFull, lt, 1);
    lt += __shfl_xor_sync(kFull, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    const int qp = sp.row0 + 8 * i;
    if (qp >= a.Sq) continue;
    float* orow = a.o + b * a.so[0] + h * a.so[1] + (long long)qp * a.so[2] +
                  col0;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int e = 8 * j + sp.col;
      if (e < dl) orow[e] = o[4 * j + 2 * i] / lt;
      if (e + 1 < dl) orow[e + 1] = o[4 * j + 2 * i + 1] / lt;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_attention_f32_kernel(const Args a) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::kThreads;
  constexpr bool kSw64 = BK == 16;              // V^T rows of 64 bytes
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_lo = base, q_hi = base + C::kQBytes;  // q_hi: !kQRegs
  const uint32_t k_hi = base + C::kKOff, k_lo = k_hi + C::kKBytes;
  const uint32_t v_hi = base + C::kVOff, v_lo = v_hi + C::kKBytes;
  const uint32_t k_raw = base + C::kRawOff, v_raw = k_raw + C::kKBytes;
  // the same, as generic pointers
  uint8_t* sm = smem_raw + (base - smem_u32(smem_raw));
  const float* kr = reinterpret_cast<const float*>(sm + (k_raw - base));
  const float* vr = reinterpret_cast<const float*>(sm + (v_raw - base));

  const int tid = threadIdx.x;
  const int n_qt = (int)(((long long)a.Sq + BQ - 1) / BQ);
  const unsigned lin = block_lin();
  if (lin >= (unsigned)n_qt) return;  // past the last tile: the rounding
  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.g;
  const int q0 = (n_qt - 1 - (int)lin) * BQ;  // heaviest tiles first
  const float* qg = a.q + b * a.sq[0] + h * a.sq[1];
  const float* kg = a.k + b * a.sk[0] + hk * a.sk[1];
  const float* vg = a.v + b * a.sv[0] + hk * a.sv[1];
  const int dd = a.d, Sk = a.Sk;
  const bool vec = a.vec;

  // the keys any row of this tile can see, in whole tiles
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_end = a.causal ? min(Sk, q_last + 1) : Sk;
  const int k_first = (a.window > 0 ? max(0, q0 - a.window + 1) : 0) / BK * BK;
  const int n_tiles = k_end > k_first ? (k_end - k_first + BK - 1) / BK : 0;

  auto load_raw = [&](int k0) {
    for (int i = tid; i < BK * (D / 4); i += NT) {
      const int j = i / (D / 4), e = 4 * (i % (D / 4));
      const bool ok = k0 + j < Sk;
      const long long r = ok ? (long long)(k0 + j) : 0;
      const uint32_t off = 4 * (j * D + e);
      load4(k_raw + off, kg + r * a.sk[2], e, ok ? dd : 0, vec);
      load4(v_raw + off, vg + r * a.sv[2], e, ok ? dd : 0, vec);
    }
    cp_commit();
  };
  if (n_tiles > 0) load_raw(k_first);

  // q, split: warpgroup w's 64 rows as D / 32 chunk tiles of 64 x 128 bytes
  // (the hi part only where it does not stay in registers)
  for (int i = tid; i < BQ * (D / 4); i += NT) {
    const int r = i / (D / 4), u = i % (D / 4), e = 4 * u;
    const int qp = q0 + r;
    const float* row = qg + (long long)qp * a.sq[2];
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qp < a.Sq) {
      if (e < dd) x.x = row[e];
      if (e + 1 < dd) x.y = row[e + 1];
      if (e + 2 < dd) x.z = row[e + 2];
      if (e + 3 < dd) x.w = row[e + 3];
    }
    float4 hi, lo;
    split4(x, hi, lo);
    const uint32_t off = ((r / kRows) * (D / 32) + u / 8) * (kRows * 128) +
                         sw128(r % kRows, u % 8);
    st_shared(q_lo + off, lo);
    if (!C::kQRegs) st_shared(q_hi + off, hi);
  }

  // this thread's rows (fragment halves i = 0, 1) and column pair offset
  const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
  // d <= 128: q's hi part as this thread's A fragments of Q.K^T, (row g,
  // k t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4) of each k-step
  constexpr bool kQRegs = C::kQRegs;
  uint32_t qf[kQRegs ? D / 8 : 1][4];
  if constexpr (kQRegs) {
    const int r0 = q0 + wg * kRows + 16 * warp + lane / 4;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qp = r0 + 8 * (r & 1), e = 8 * ks + lane % 4 + 4 * (r >> 1);
        float x = qp < a.Sq && e < dd ? qg[(long long)qp * a.sq[2] + e] : 0.f;
        float hi, lo;
        split(x, hi, lo);
        qf[ks][r] = __float_as_uint(hi);
      }
  }
  const int qc0 = q0 + wg * kRows;
  const int row0 = qc0 + 16 * warp + lane / 4;
  const uint32_t q_hi_w = q_hi + wg * (D / 32) * kRows * 128;
  const uint32_t q_lo_w = q_lo + wg * (D / 32) * kRows * 128;
  const bool causal = a.causal;
  const Score sp = score_params(a, qc0, row0, 2 * (lane % 4));

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_first + it * BK;
    cp_wait_all();
    __syncthreads();  // raw tile `it` has landed; the products of it - 1 are
                      // done with the hi/lo tiles
    // K: row j (key), 16-byte unit u of d; V^T: row e (d), unit w of 4 keys
    // in the order 8kk + (0, 2, 4, 6) (w = 2kk) or 8kk + (1, 3, 5, 7)
#pragma unroll
    for (int n = 0; n < BK * (D / 4) / NT; ++n) {
      const int i = tid + NT * n, j = i / (D / 4), u = i % (D / 4);
      float4 hi, lo;
      split4(reinterpret_cast<const float4*>(kr)[j * (D / 4) + u], hi, lo);
      const uint32_t off = (u / 8) * (BK * 128) + sw128(j, u % 8);
      *reinterpret_cast<float4*>(sm + (k_hi - base) + off) = hi;
      *reinterpret_cast<float4*>(sm + (k_lo - base) + off) = lo;
    }
#pragma unroll
    for (int n = 0; n < D * (BK / 4) / NT; ++n) {
      const int i = tid + NT * n, e = i % D, w = i / D;
      const int key = 8 * (w >> 1) + (w & 1);
      float4 x, hi, lo;
      x.x = vr[key * D + e];
      x.y = vr[(key + 2) * D + e];
      x.z = vr[(key + 4) * D + e];
      x.w = vr[(key + 6) * D + e];
      split4(x, hi, lo);
      const uint32_t off = kSw64 ? sw64(e, w) : sw128(e, w);
      *reinterpret_cast<float4*>(sm + (v_hi - base) + off) = hi;
      *reinterpret_cast<float4*>(sm + (v_lo - base) + off) = lo;
    }
    // wgmma reads shared memory through the async proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the hi/lo tiles are ready; the raw buffer is free
    if (it + 1 < n_tiles) load_raw(k0 + BK);
    if (causal && k0 > qc0 + kRows - 1) continue;  // above all our rows

    // S = Q.K^T over d in k-steps of 8 (32 bytes inside a 128-byte row; the
    // next chunk tile every four k-steps)
    uint64_t dq_hi = desc(q_hi_w, 1024, false), dq_lo = desc(q_lo_w, 1024, false);
    uint64_t dk_hi = desc(k_hi, 1024, false), dk_lo = desc(k_lo, 1024, false);
    asm volatile("" : "+l"(dq_hi), "+l"(dq_lo), "+l"(dk_hi), "+l"(dk_lo));
    float sc[BK / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) {
      const uint32_t qa = ((ks / 4) * kRows * 128 + (ks % 4) * 32) >> 4;
      const uint32_t kb = ((ks / 4) * BK * 128 + (ks % 4) * 32) >> 4;
      wgmma_ss(sc, dq_lo + qa, dk_hi + kb, ks > 0);
      if constexpr (kQRegs) {
        wgmma_rs(sc, qf[ks], dk_lo + kb);
        wgmma_rs(sc, qf[ks], dk_hi + kb);
      } else {
        wgmma_ss(sc, dq_hi + qa, dk_lo + kb, 1);
        wgmma_ss(sc, dq_hi + qa, dk_hi + kb, 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    softmax_pv<D, BK>(sp, k0, sc, o, m, l, v_hi, v_lo);
  }

  store_out<D>(a, b, h, sp, 0, o, l);
}

// S = Q.K^T of one key tile for a warpgroup's 64 q rows over D columns,
// in k-steps of 8 (32 bytes inside a 128-byte row; the next chunk tile
// every four k-steps), three products a k-step into sc, small terms first:
// lo_q.hi_k from shared memory, then hi_q.lo_k and hi_q.hi_k with q's hi
// from registers (qf) where kQRegs, else from shared memory. `acc` adds to
// sc instead of starting from 0. Waited for.
template <int D, int BK, bool kQRegs>
__device__ __forceinline__ void qk_products(
    float (&sc)[BK / 2], const uint32_t (&qf)[kQRegs ? D / 8 : 1][4],
    uint32_t q_hi_w, uint32_t q_lo_w, uint32_t k_hi, uint32_t k_lo,
    bool acc) {
  uint64_t dq_hi = desc(q_hi_w, 1024, false), dq_lo = desc(q_lo_w, 1024, false);
  uint64_t dk_hi = desc(k_hi, 1024, false), dk_lo = desc(k_lo, 1024, false);
  asm volatile("" : "+l"(dq_hi), "+l"(dq_lo), "+l"(dk_hi), "+l"(dk_lo));
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 8; ++ks) {
    const uint32_t qa = ((ks / 4) * kRows * 128 + (ks % 4) * 32) >> 4;
    const uint32_t kb = ((ks / 4) * BK * 128 + (ks % 4) * 32) >> 4;
    wgmma_ss(sc, dq_lo + qa, dk_hi + kb, acc || ks > 0);
    if constexpr (kQRegs) {
      wgmma_rs(sc, qf[ks], dk_lo + kb);
      wgmma_rs(sc, qf[ks], dk_hi + kb);
    } else {
      wgmma_ss(sc, dq_hi + qa, dk_lo + kb, 1);
      wgmma_ss(sc, dq_hi + qa, dk_hi + kb, 1);
    }
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(sc);
}

// The wide route's CTA at slice width D: its partial S (BK / 2 floats a
// thread), in two buffers of their own past the other tiles where they fit
// in the 227 KiB a block may hold (slices of 128), else in K's hi tile
// (slices of 256); its dynamic shared memory.
template <int D>
struct Wide {
  using C = Cfg<D>;
  static constexpr int kPart = C::kThreads * (C::BK / 2) * 4;
  static constexpr bool kTwoParts = C::kSmem + 2 * kPart <= 227 * 1024;
  static constexpr int kPartOff = C::kRawOff + 2 * C::kKBytes;
  static constexpr int kSmem = C::kSmem + (kTwoParts ? 2 * kPart : 0);
  static_assert(kPart <= C::kKBytes, "partial S");
};

// A CTA of the wide route (d > 256; D its slice width, 128 or 256), see the
// head of the file.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
    flash_attention_f32_cluster_kernel(const Args a) {
  using C = Cfg<D>;
  using W = Wide<D>;
  constexpr int BQ = C::BQ, BK = C::BK, NT = C::kThreads;
  constexpr bool kSw64 = BK == 16;              // V^T rows of 64 bytes
  constexpr bool kTwoParts = W::kTwoParts;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_lo = base, q_hi = base + C::kQBytes;  // q_hi: !kQRegs
  const uint32_t k_hi = base + C::kKOff, k_lo = k_hi + C::kKBytes;
  const uint32_t v_hi = base + C::kVOff, v_lo = v_hi + C::kKBytes;
  const uint32_t k_raw = base + C::kRawOff, v_raw = k_raw + C::kKBytes;
  // the same, as generic pointers
  uint8_t* sm = smem_raw + (base - smem_u32(smem_raw));
  const float* kr = reinterpret_cast<const float*>(sm + (k_raw - base));
  const float* vr = reinterpret_cast<const float*>(sm + (v_raw - base));

  const int tid = threadIdx.x;
  const int n_qt = (int)(((long long)a.Sq + BQ - 1) / BQ);
  const unsigned lin = block_lin();
  // lin = slice + nslp * t, so a cluster is consecutive slices of one q
  // tile
  if (lin >= (unsigned)n_qt * (unsigned)a.nslp) return;  // the rounding
  const int slice = (int)(lin % (unsigned)a.nslp);
  const int tq = (int)(lin / (unsigned)a.nslp);
  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.g;
  const int q0 = (n_qt - 1 - tq) * BQ;  // heaviest tiles first
  const float* qg = a.q + b * a.sq[0] + h * a.sq[1];
  const float* kg = a.k + b * a.sk[0] + hk * a.sk[1];
  const float* vg = a.v + b * a.sv[0] + hk * a.sv[1];
  const int dd = a.d, Sk = a.Sk;
  const bool vec = a.vec;
  // this CTA's columns [col0, col0 + D) of d, dl of them live from col0
  // (none in a group's padding); q and K stay resident where one cluster
  // covers d, else they are staged per key tile for each slice of S
  const int col0 = slice * D, dl = dd - col0;
  const bool resident = a.nslp == a.ncl;

  // the keys any row of this tile can see, in whole tiles
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_end = a.causal ? min(Sk, q_last + 1) : Sk;
  const int k_first = (a.window > 0 ? max(0, q0 - a.window + 1) : 0) / BK * BK;
  const int n_tiles = k_end > k_first ? (k_end - k_first + BK - 1) / BK : 0;

  // raw K (parts & 1, where q and K stay) or V (parts & 2) of key tile k0,
  // one cp.async group
  auto load_raw = [&](int k0, int parts) {
    for (int i = tid; i < BK * (D / 4); i += NT) {
      const int j = i / (D / 4), e = 4 * (i % (D / 4));
      const bool ok = k0 + j < Sk;
      const long long r = ok ? (long long)(k0 + j) : 0;
      const int lim = ok ? dl : 0, c = lim > 0 ? col0 : 0;
      const uint32_t off = 4 * (j * D + e);
      if ((parts & 1) && resident)
        load4(k_raw + off, kg + r * a.sk[2] + c, e, lim, vec);
      if (parts & 2) load4(v_raw + off, vg + r * a.sv[2] + c, e, lim, vec);
    }
    cp_commit();
  };
  if (n_tiles > 0) {  // K and V as groups of their own
    load_raw(k_first, 1);
    load_raw(k_first, 2);
  }

  // q's columns [c0, c0 + D), split: warpgroup w's 64 rows as D / 32 chunk
  // tiles of 64 x 128 bytes (the hi part only where it does not stay in
  // registers)
  auto stage_q = [&](int c0) {
    const int ql = dd - c0;
    for (int i = tid; i < BQ * (D / 4); i += NT) {
      const int r = i / (D / 4), u = i % (D / 4), e = 4 * u;
      const int qp = q0 + r;
      const float* row = qg + (long long)qp * a.sq[2] + c0;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qp < a.Sq) {
        if (e < ql) x.x = row[e];
        if (e + 1 < ql) x.y = row[e + 1];
        if (e + 2 < ql) x.z = row[e + 2];
        if (e + 3 < ql) x.w = row[e + 3];
      }
      float4 hi, lo;
      split4(x, hi, lo);
      const uint32_t off = ((r / kRows) * (D / 32) + u / 8) * (kRows * 128) +
                           sw128(r % kRows, u % 8);
      st_shared(q_lo + off, lo);
      if (!C::kQRegs) st_shared(q_hi + off, hi);
    }
  };
  if (resident) stage_q(col0);

  // this thread's rows (fragment halves i = 0, 1) and column pair offset
  const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
  // slices of 128: q's hi part as this thread's A fragments of Q.K^T, (row
  // g, k t4), (g + 8, t4), (g, t4 + 4), (g + 8, t4 + 4) of each k-step
  constexpr bool kQRegs = C::kQRegs;
  uint32_t qf[kQRegs ? D / 8 : 1][4];
  auto load_qf = [&](int c0) {
    const int ql = dd - c0;
    const int r0 = q0 + wg * kRows + 16 * warp + lane / 4;
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qp = r0 + 8 * (r & 1), e = 8 * ks + lane % 4 + 4 * (r >> 1);
        float x = qp < a.Sq && e < ql ? qg[(long long)qp * a.sq[2] + c0 + e]
                                      : 0.f;
        float hi, lo;
        split(x, hi, lo);
        qf[ks][r] = __float_as_uint(hi);
      }
  };
  if constexpr (kQRegs) {
    if (resident) load_qf(col0);
  }
  // K's columns [c0, c0 + D) of key tile k0, split, by plain loads (past
  // one cluster, where q and K do not stay)
  auto stage_k = [&](int k0, int c0) {
    const int kl = dd - c0;
    for (int i = tid; i < BK * (D / 4); i += NT) {
      const int j = i / (D / 4), u = i % (D / 4), e = 4 * u;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), hi, lo;
      if (k0 + j < Sk) {
        const float* row = kg + (long long)(k0 + j) * a.sk[2] + c0;
        if (e < kl) x.x = row[e];
        if (e + 1 < kl) x.y = row[e + 1];
        if (e + 2 < kl) x.z = row[e + 2];
        if (e + 3 < kl) x.w = row[e + 3];
      }
      split4(x, hi, lo);
      const uint32_t off = (u / 8) * (BK * 128) + sw128(j, u % 8);
      *reinterpret_cast<float4*>(sm + (k_hi - base) + off) = hi;
      *reinterpret_cast<float4*>(sm + (k_lo - base) + off) = lo;
    }
  };
  const int qc0 = q0 + wg * kRows;
  const int row0 = qc0 + 16 * warp + lane / 4;
  const uint32_t q_hi_w = q_hi + wg * (D / 32) * kRows * 128;
  const uint32_t q_lo_w = q_lo + wg * (D / 32) * kRows * 128;
  const Score sp = score_params(a, qc0, row0, 2 * (lane % 4));

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  // K: row j (key), 16-byte unit u of d; V^T: row e (d), unit w of 4 keys
  // in the order 8kk + (0, 2, 4, 6) (w = 2kk) or 8kk + (1, 3, 5, 7)
  auto split_k = [&] {
#pragma unroll
    for (int n = 0; n < BK * (D / 4) / NT; ++n) {
      const int i = tid + NT * n, j = i / (D / 4), u = i % (D / 4);
      float4 hi, lo;
      split4(reinterpret_cast<const float4*>(kr)[j * (D / 4) + u], hi, lo);
      const uint32_t off = (u / 8) * (BK * 128) + sw128(j, u % 8);
      *reinterpret_cast<float4*>(sm + (k_hi - base) + off) = hi;
      *reinterpret_cast<float4*>(sm + (k_lo - base) + off) = lo;
    }
  };
  auto split_v = [&] {
#pragma unroll
    for (int n = 0; n < D * (BK / 4) / NT; ++n) {
      const int i = tid + NT * n, e = i % D, w = i / D;
      const int key = 8 * (w >> 1) + (w & 1);
      float4 x, hi, lo;
      x.x = vr[key * D + e];
      x.y = vr[(key + 2) * D + e];
      x.z = vr[(key + 4) * D + e];
      x.w = vr[(key + 6) * D + e];
      split4(x, hi, lo);
      const uint32_t off = kSw64 ? sw64(e, w) : sw128(e, w);
      *reinterpret_cast<float4*>(sm + (v_hi - base) + off) = hi;
      *reinterpret_cast<float4*>(sm + (v_lo - base) + off) = lo;
    }
  };

  // Pipelined: the P.V of tile it - 1 is issued after this CTA's partial
  // S of tile it is out and before the cluster barrier it waits at, so
  // the exchange overlaps the products. V's tile is split after the
  // exchange, once that P.V has been waited for, so K and V arrive as
  // cp.async groups of their own (K's empty past one cluster). Every
  // warpgroup takes every tile: one wholly above a warpgroup's rows (all
  // masked; each of its rows has seen a key by then) adds exactly 0, and
  // no wgmma sits on a path that depends on the warpgroup (ptxas would
  // serialize them all, C7518).
  const int rank = (int)cluster_rank();
  // this thread's 16-byte units of tile it's partial S: unit u at + u * NT
  // * 16
  auto part_of = [&](int it) -> uint32_t {
    return (kTwoParts ? base + W::kPartOff + (it & 1) * W::kPart : k_hi) +
           tid * 16;
  };
  // P of the tile before; before tile 0, P = 0 and V's tiles 0, so that
  // the P.V is issued and waited for on every path (ptxas serializes the
  // wgmmas where a path may issue without the wait, C7515)
  uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) ph[kk][r] = pl[kk][r] = 0u;
  for (int i = tid; i < 2 * C::kKBytes / 16; i += NT)
    st_shared(v_hi + 16 * i, make_float4(0.f, 0.f, 0.f, 0.f));
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_first + it * BK;
    cp_wait_1();      // raw K of tile it has landed (V's may not have)
    __syncthreads();  // ... for every thread; S of it - 1 is done with K
    // one partial buffer: the peers have read this CTA's partial S of tile
    // it - 1 (in K's hi tile)
    if (!kTwoParts && it > 0) cluster_wait();
    if (resident) split_k();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // K's hi/lo tiles are ready; raw K is free
    if (it + 1 < n_tiles) load_raw(k0 + BK, 1);
    float sc[BK / 2];
    // this CTA's slices of S: its own (resident), or past one cluster
    // slices rank, rank + ncl, ..., each staged here
    for (int j = rank; j < a.n_sl; j += a.ncl) {
      if (!resident) {
        __syncthreads();  // the products before are done with q and K
        stage_q(j * D);
        if constexpr (kQRegs) load_qf(j * D);
        stage_k(k0, j * D);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
      }
      qk_products<D, BK, kQRegs>(sc, qf, q_hi_w, q_lo_w, k_hi, k_lo,
                                 j != rank);
    }
    // the partial S to its buffer (K's hi tile: once every warpgroup's
    // products are done with it)
    if (!kTwoParts) __syncthreads();
    const uint32_t part = part_of(it);
#pragma unroll
    for (int u = 0; u < BK / 8; ++u)
      st_shared(part + u * NT * 16,
                make_float4(sc[4 * u], sc[4 * u + 1], sc[4 * u + 2],
                            sc[4 * u + 3]));
    cluster_arrive();
    pv_issue<D, BK>(o, ph, pl, v_hi, v_lo);  // tile it - 1's
    cluster_wait();  // every CTA's partial of this tile is written
    // the scores, summed in rank order: the same bits in every CTA; two
    // ranks' loads in flight at a time. Not into sc: no instruction but
    // a wgmma may define a wgmma's accumulator while the P.V is in flight
    // (ptxas would serialize them, C7515)
    float ss[BK / 2];
    {
      for (int r = 0; r < a.ncl; r += 2) {
        const bool two = r + 1 < a.ncl;
        const uint32_t src0 = mapa(part, (uint32_t)r);
        const uint32_t src1 = mapa(part, (uint32_t)(two ? r + 1 : r));
        float4 v0[BK / 8], v1[BK / 8];
#pragma unroll
        for (int u = 0; u < BK / 8; ++u)
          v0[u] = ld_cluster4(src0 + u * NT * 16);
#pragma unroll
        for (int u = 0; u < BK / 8; ++u)
          v1[u] = ld_cluster4(src1 + u * NT * 16);
#pragma unroll
        for (int u = 0; u < BK / 8; ++u) {
          const float x[4] = {v0[u].x, v0[u].y, v0[u].z, v0[u].w};
          const float y[4] = {v1[u].x, v1[u].y, v1[u].z, v1[u].w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            float& t = ss[4 * u + c];
            t = r == 0 ? x[c] : t + x[c];
            if (two) t += y[c];
          }
        }
      }
    }
    // one partial buffer: this CTA has read its peers' partials
    if (!kTwoParts) cluster_arrive();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    if (it + 1 < n_tiles)
      cp_wait_1();  // raw V of tile it has landed (K's of it + 1 may not)
    else
      cp_wait_all();
    __syncthreads();  // ... for every thread; P.V is done with V's tiles
    split_v();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // V's hi/lo tiles are ready; raw V is free
    if (it + 1 < n_tiles) load_raw(k0 + BK, 2);
    softmax_p<D, BK>(sp, k0, ss, o, m, l, ph, pl);
  }
  if (n_tiles > 0) {  // the last tile's P.V
    pv_issue<D, BK>(o, ph, pl, v_hi, v_lo);
    wgmma_wait_all();
    fence_regs(o);
  }
  // no peer reads this CTA's shared memory once this wait returns
  if (n_tiles > 0) {
    if (kTwoParts) cluster_arrive();
    cluster_wait();
  }

  store_out<D>(a, b, h, sp, col0, o, l);
}

template <int D>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t stream) {
  constexpr int bytes = Cfg<D>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_attention_f32_kernel<D><<<grid, Cfg<D>::kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
void config(int* block_q, int* block_k, int* smem_bytes, bool wide) {
  *block_q = Cfg<D>::BQ;
  *block_k = Cfg<D>::BK;
  if constexpr (D >= 128)
    *smem_bytes = wide ? Wide<D>::kSmem : Cfg<D>::kSmem;
  else
    *smem_bytes = Cfg<D>::kSmem;
}

// The wide route: slices of kWideCols columns, or of twice that where then
// one cluster of at most kMaxCluster CTAs (the portable limit) covers d and
// otherwise would not (wide_cols).
constexpr int kWideCols = 128;
constexpr int kMaxCluster = 8;

int wide_cols(int d) {
  const int reach = kWideCols * kMaxCluster;
  return d > reach && d <= 2 * reach ? 2 * kWideCols : kWideCols;
}

// Slices of d at `cols` columns, CTAs a cluster and the slices with the
// last group's padding (ops.f32_wide_plan).
void wide_plan(int d, int cols, int* n_sl, int* ncl, int* nslp) {
  *n_sl = (d + cols - 1) / cols;
  *ncl = *n_sl < kMaxCluster ? *n_sl : kMaxCluster;
  *nslp = (*n_sl + *ncl - 1) / *ncl * *ncl;
}

// A launch of the wide route's CTA of D columns in clusters of (1, ncl, 1)
// over grid; with max_active, no launch: the most such clusters the card
// holds at once (cudaOccupancyMaxActiveClusters).
template <int D>
cudaError_t launch_wide(const Args& a, dim3 grid, cudaStream_t stream,
                        int* max_active = nullptr) {
  constexpr int bytes = Wide<D>::kSmem;
  void (*kernel)(Args) = flash_attention_f32_cluster_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = (unsigned)a.ncl;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(Cfg<D>::kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (max_active)
    return cudaOccupancyMaxActiveClusters(max_active, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes; float32 q, k, v and out (dtype 0). strides: 12 int64,
// the (batch, head, seq) strides in elements of q, k, v and out, in that
// order (the last dimension of each is contiguous). unit (ops._sm90_unit):
// 16 copies k and v rows 16 bytes at a time, which needs their bases and
// every stride of a dimension longer than 1 to be multiples of 16 bytes; 4
// takes any. Any d >= 1 and Sq >= 1: B Hq up to 2^31 - 1 (the grid's x)
// and q tiles (128 rows at d <= 128, 64 to d = 256, past it the slice
// width's: 128 rows at 128 columns, 64 at 256) up to 65,535^2 (its y and
// z); past d = 256 the tiles times the padded slices, in clusters along y.
// Launches on `stream` of `device` and returns the CUDA error (0 when the
// launch was accepted); arguments it does not take return
// cudaErrorInvalidValue without launching.
extern "C" int flash_attention_f32_sm90_launch(const void* q, const void* k,
                                               const void* v, void* out,
                                               const long long* strides,
                                               int B, int Hq, int Hkv, int Sq,
                                               int Sk, int d, int causal,
                                               int window, float scale,
                                               float softcap, int dtype,
                                               int unit, int device,
                                               void* stream) {
  const bool wide = d > 256;
  const int cols = wide_cols(d);
  const int bq = d <= 128 || (wide && cols == 128) ? Cfg<128>::BQ
                                                  : Cfg<256>::BQ;
  const long long n_qt = ((long long)Sq + bq - 1) / bq;
  int n_sl = 1, ncl = 1, nslp = 1;
  if (wide) wide_plan(d, cols, &n_sl, &ncl, &nslp);
  bool ok = B > 0 && Hq > 0 && Hkv > 0 && Hq % Hkv == 0 && Sq > 0 && Sk >= 0 &&
            d > 0 && window >= 0 && (long long)B * Hq <= 0x7fffffffLL &&
            n_qt * nslp <= (65535LL - 65535 % ncl) * 65535 && dtype == 0 &&
            (unit == 16 || unit == 4);
  const int extent[3] = {B, Hkv, Sk};
  if (unit == 16) {
    ok = ok && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0;
    for (int i = 0; i < 3; ++i)
      ok = ok && (extent[i] <= 1 ||
                  (strides[3 + i] % 4 == 0 && strides[6 + i] % 4 == 0));
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.q = static_cast<const float*>(q);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.o = static_cast<float*>(out);
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  a.vec = unit == 16;
  a.Hq = Hq;
  a.g = Hq / Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.d = d;
  a.causal = causal != 0;
  a.window = window;
  a.n_sl = n_sl;
  a.ncl = ncl;
  a.nslp = nslp;
  a.scale = scale;
  a.softcap = softcap;
  const dim3 grid = grid_of(B * Hq, n_qt * nslp, ncl);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wide)
    return (int)(cols == 128 ? launch_wide<128>(a, grid, s)
                             : launch_wide<256>(a, grid, s));
  if (d <= 32) return (int)launch<32>(a, grid, s);
  if (d <= 64) return (int)launch<64>(a, grid, s);
  if (d <= 128) return (int)launch<128>(a, grid, s);
  return (int)launch<256>(a, grid, s);
}

// The launch configuration for head_dim d >= 1: q rows per block, keys per
// tile, dynamic shared memory bytes (d > 256: of a CTA of the wide route at
// its slice width).
extern "C" void flash_attention_f32_sm90_config(int d, int* block_q,
                                                int* block_k,
                                                int* smem_bytes) {
  const bool wide = d > 256;
  if (d <= 32)
    config<32>(block_q, block_k, smem_bytes, false);
  else if (d <= 64)
    config<64>(block_q, block_k, smem_bytes, false);
  else if (d <= 128 || (wide && wide_cols(d) == 128))
    config<128>(block_q, block_k, smem_bytes, wide);
  else
    config<256>(block_q, block_k, smem_bytes, wide);
}

// The wide route at head dim d > 256 on `device`: its slice width, CTAs a
// cluster, and the most such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters). Returns the CUDA error.
extern "C" int flash_attention_f32_sm90_clusters(int d, int device,
                                                 int* cols, int* cluster,
                                                 int* max_active) {
  if (d <= 256) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a = {};
  int n_sl, nslp;
  *cols = wide_cols(d);
  wide_plan(d, *cols, &n_sl, cluster, &nslp);
  a.ncl = *cluster;
  const dim3 grid(1, (unsigned)*cluster, 1);
  return (int)(*cols == 128 ? launch_wide<128>(a, grid, 0, max_active)
                            : launch_wide<256>(a, grid, 0, max_active));
}
