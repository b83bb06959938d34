// Blocked (flash) attention forward for Hopper (sm_90a), bfloat16: bf16
// tensor-core products (wgmma) fed by TMA, warp-specialised.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention (the
// Pallas TPU kernel, body `_kernel`) for bfloat16 inputs; float32 inputs keep
// the CUDA-core kernel of flash_attention.cu, since its tolerance rules out
// TF32 products. Same function and conventions as that kernel:
//
//   q    (B, Hq, Sq, d)     k/v (B, Hkv, Sk, d)     out (B, Hq, Sq, d)
//
// given by (batch, head, seq) strides with a contiguous last dimension (the
// caller's (B, S, H, d) transposes stay views), q-head h reading kv-head
// h / g. The score is (q.k) / sqrt(d), then the optional tanh softcap, then
// the causal (q_pos >= k_pos, both from 0) and window (q_pos - k_pos <
// window) masks write -1e30; keys past Sk score -inf. The online softmax is
// float32 from -1e30; out = acc / max(l, 1e-30) in bf16. Key tiles wholly
// outside the band of a 128-row q tile are skipped, so a row that sees no key
// gets the mean of v over the keys of the tiles its q tile visited, or 0.
//
// Bound: at the model's shape (S = 4096, d = 128, causal) the work is 4 d
// operations per visible (q, k) pair, far above the bytes of q, k, v and out,
// so the bf16 tensor-core rate bounds it. The design feeds the tensor cores:
//
// * One block per (b*Hq + h, 128-row q tile), heaviest causal tiles first.
//   384 threads: a producer warpgroup (its registers cut to 24 by setmaxnreg)
//   and two consumer warpgroups (240 registers), each owning 64 q rows.
// * TMA. Host-built 4-D tensor maps over (d, S, H, B) read the strided views
//   as they are, in 64-column boxes with the 128-byte swizzle; rows and keys
//   out of bounds arrive as zeros. q is loaded once; K and V tiles (128 keys
//   at d <= 128, 64 at d = 256) go through a 2-stage ring, each with its own
//   full and empty mbarriers: Q.K^T starts before V lands, and a K buffer is
//   refilled as soon as its product is done. One thread issues every copy.
// * S = Q.K^T: wgmma m64n{BK}k16, both operands from shared memory (K is
//   K-major as stored), f32 accumulators in registers. The softmax runs on
//   the accumulator fragment in log2 units (ex2): row max and sum across the
//   four threads of a quad by shuffles; masks only on tiles that cross the
//   diagonal, the window edge or Sk.
// * O += P.V: wgmma with P in registers (the S fragment is the A fragment,
//   converted in place) and V from shared memory as an MN-major operand (the
//   descriptor's transpose bit). P goes in two bf16 parts, P_hi = bf16(p) and
//   P_lo = bf16(p - P_hi), two products into one f32 accumulator: with a
//   single rounding of P, gemma2's widths (d = 256, softcap 50) reached 1.1x
//   the bf16 tolerance (atol 2e-3, rtol 2e-2) against the float32 plain
//   version; the split stays under a third of it. It costs 1.5x the
//   function's operations. l is summed from the f32 p.
// * Schedule. A warpgroup issues P.V of one tile and S of the next back to
//   back and waits for both once; the two warpgroups take turns at that (two
//   named barriers), so one's softmax runs while the other's products do.
// * Epilogue: O / max(l, 1e-30) to bf16, plain stores into q's layout; rows
//   past Sq are not written.
//
// Two things ptxas punishes here: an S accumulator carried across loop
// iterations makes it serialize every wgmma (warning C7515), so S is fresh
// in each iteration; and branches on kernel parameters inside the unrolled
// score loop (softcap, masks) cost more than the arithmetic, so each is a
// loop of its own over the fragment.
//
// Not here yet: overlapping a warpgroup's softmax with its own next Q.K^T
// (FA3's intra-warpgroup pipelining), a persistent grid, clusters, fp8.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 128;          // q rows per block
constexpr int kRows = 64;         // q rows per consumer warpgroup
constexpr int kThreads = 384;     // producer + two consumer warpgroups
constexpr int kStages = 2;        // K/V ring depth
constexpr int kChunk = 64;        // d columns per TMA box (128 bytes)
constexpr int kChunkBytes = kChunk * 2;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Args {
  void* o;
  long long so[3];  // out's (batch, head, seq) strides, in elements
  int Hq, g, Sq, Sk, d, causal, window, n_qt;
  float scale, softcap;
};

// D: d rounded up to a multiple of 64 (TMA fills the columns past d with 0).
template <int D>
struct Cfg {
  static constexpr int BK = D <= 128 ? 128 : 64;  // keys per tile
  static constexpr int NC = D / kChunk;           // 64-column chunks
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = BK * D * 2;   // one K or V tile
  static constexpr int kKOff = kQBytes;
  static constexpr int kVOff = kKOff + kStages * kTileBytes;
  static constexpr int kBarOff = kVOff + kStages * kTileBytes;
  // + 1024 to align the base to the swizzle atom
  static constexpr int kSmem = kBarOff + 8 * (1 + 4 * kStages) + 1024;
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

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x 64, f32) (+)= A (64 x 16, smem) * B (16 x 64, smem), both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 128, f32) (+)= A (64 x 16, smem) * B (16 x 128, smem), both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
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

// D (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
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

// D (64 x 256, f32) += A (64 x 16, registers) * B (16 x 256, smem, MN-major).
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
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
      "{%128, %129, %130, %131}, %132, 1, 1, 1, 1;\n"
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
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[Cfg<D>::BK / 2],
                                         uint32_t q_smem, uint32_t k_smem) {
  constexpr int BK = Cfg<D>::BK;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in = (kk % 4) * 32;
    wgmma_ss(sc,
             desc_sw128(q_smem + (kk / 4) * kRows * kChunkBytes + in, 16, 1024),
             desc_sw128(k_smem + (kk / 4) * BK * kChunkBytes + in, 16, 1024),
             kk > 0);
  }
}

// O (64 x D) += P (64 x BK, registers) . V (BK x D). V is MN-major: 8-key
// groups 1024 bytes apart (SBO), 64-column chunks one chunk tile apart (LBO).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         uint32_t (&p)[Cfg<D>::BK / 16][4],
                                         uint32_t v_smem) {
  constexpr int BK = Cfg<D>::BK;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(o, p[kk],
             desc_sw128(v_smem + kk * 16 * kChunkBytes, BK * kChunkBytes,
                        1024));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_sm90_kernel(__grid_constant__ const CUtensorMap tq,
                            __grid_constant__ const CUtensorMap tk,
                            __grid_constant__ const CUtensorMap tv,
                            const Args a) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_full = base + C::kBarOff;
  const uint32_t k_full = q_full + 8;               // + 8 s
  const uint32_t v_full = k_full + 8 * kStages;     // + 8 s
  const uint32_t k_empty = v_full + 8 * kStages;    // + 8 s
  const uint32_t v_empty = k_empty + 8 * kStages;   // + 8 s

  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.g;
  const int q0 = (a.n_qt - 1 - (int)blockIdx.y) * kBQ;  // heaviest tiles first
  // the key tiles any row of this q tile can see
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_first =
      a.window > 0 ? (max(0, q0 - a.window + 1) / BK) * BK : 0;
  const int n_tiles = k_end > k_first ? (k_end - k_first + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, 2 * 128);  // every consumer thread
      mbar_init(v_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::kQBytes);
      for (int c = 0; c < kBQ / kRows; ++c)
        for (int kb = 0; kb < C::NC; ++kb)
          tma_load(base + (c * C::NC + kb) * kRows * kChunkBytes, &tq, q_full,
                   kb * kChunk, q0 + c * kRows, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t free_phase = ((it / kStages) & 1) ^ 1;
        const int k0 = k_first + it * BK;
        mbar_wait(k_empty + 8 * s, free_phase);
        mbar_expect_tx(k_full + 8 * s, C::kTileBytes);
        for (int kb = 0; kb < C::NC; ++kb)
          tma_load(base + C::kKOff + s * C::kTileBytes + kb * BK * kChunkBytes,
                   &tk, k_full + 8 * s, kb * kChunk, k0, hk, b);
        mbar_wait(v_empty + 8 * s, free_phase);
        mbar_expect_tx(v_full + 8 * s, C::kTileBytes);
        for (int kb = 0; kb < C::NC; ++kb)
          tma_load(base + C::kVOff + s * C::kTileBytes + kb * BK * kChunkBytes,
                   &tv, v_full + 8 * s, kb * kChunk, k0, hk, b);
      }
    }
    return;
  }

  // consumer warpgroup cw owns q rows qc0 .. qc0 + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int cw = wg - 1;
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  const int qc0 = q0 + cw * kRows;
  // this thread's rows (fragment halves i = 0, 1) and column pair offset
  const int row0 = qc0 + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  const uint32_t q_smem = base + cw * C::NC * kRows * kChunkBytes;
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
  mbar_wait(q_full, 0);
  if (cw == 1 && n_tiles > 0) turn_pass(cw);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    const int k0 = k_first + it * BK;
    float sc[BK / 2];
    if (it == 0) turn_wait(cw);
    mbar_wait(k_full + 8 * s, phase);
    issue_qk<D>(sc, q_smem, base + C::kKOff + s * C::kTileBytes);
    wgmma_commit();
    turn_pass(cw);
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(o);
    mbar_arrive(k_empty + 8 * s);
    if (it > 0) mbar_arrive(v_empty + 8 * ((it - 1) % kStages));

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

    // P in two bf16 parts, laid out as the A fragment of m64nDk16: for keys
    // 16kk.., register r holds sc[8kk + 2r], sc[8kk + 2r + 1] (row half r & 1)
    uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r & 1, e = 8 * kk + 2 * r;
        const float p0 = ex2(sc[e] - m[i]), p1 = ex2(sc[e + 1] - m[i]);
        rs[i] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 back = __bfloat1622float2(hi);
        p_hi[kk][r] = pack_bf16(hi);
        p_lo[kk][r] =
            pack_bf16(__floats2bfloat162_rn(p0 - back.x, p1 - back.y));
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

    // O += P_hi.V + P_lo.V, waited for with the next tile's S
    fence_regs(o);
    fence_frags(p_hi);
    fence_frags(p_lo);
    mbar_wait(v_full + 8 * s, phase);
    turn_wait(cw);
    wgmma_fence();
    issue_pv<D>(o, p_hi, base + C::kVOff + s * C::kTileBytes);
    issue_pv<D>(o, p_lo, base + C::kVOff + s * C::kTileBytes);
    wgmma_commit();
  }
  // the last turn: warpgroup 1 has none left to take
  if (cw == 0 && n_tiles > 0) turn_pass(cw);
  wgmma_wait_all();
  fence_regs(o);

  // epilogue: rows past Sq and columns past d are not written
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + b * a.so[0] +
                       h * a.so[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    const int qp = row0 + 8 * i;
    if (qp >= a.Sq) continue;
    __nv_bfloat16* orow = out + (long long)qp * a.so[2];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j + col < a.d)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * i] / lt,
                                  o[4 * j + 2 * i + 1] / lt);
  }
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

// A 4-D map over (d, S, H, B) of a bf16 tensor with (batch, head, seq)
// strides `st` (elements), boxes of 64 columns x `rows`, 128-byte swizzle.
CUresult encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
                int S, int H, int B, const long long* st, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  // a dimension of extent 1 is never stepped: give it any valid stride
  const cuuint64_t strides[3] = {
      S > 1 ? (cuuint64_t)st[2] * 2 : 16, H > 1 ? (cuuint64_t)st[1] * 2 : 16,
      B > 1 ? (cuuint64_t)st[0] * 2 : 16};
  const cuuint32_t box[4] = {kChunk, (cuuint32_t)rows, 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const long long* st,
           int B, int Hkv, const Args& a, cudaStream_t stream) {
  EncodeTiled fn = encoder();
  if (!fn) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  CUresult r = encode(fn, &tq, q, a.d, a.Sq, a.Hq, B, st, kRows);
  if (r == CUDA_SUCCESS)
    r = encode(fn, &tk, k, a.d, a.Sk > 0 ? a.Sk : 1, Hkv, B, st + 3,
               Cfg<D>::BK);
  if (r == CUDA_SUCCESS)
    r = encode(fn, &tv, v, a.d, a.Sk > 0 ? a.Sk : 1, Hkv, B, st + 6,
               Cfg<D>::BK);
  if (r != CUDA_SUCCESS) return -(int)r;
  constexpr int bytes = Cfg<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * a.Hq), (unsigned)a.n_qt);
  flash_attention_sm90_kernel<D><<<grid, kThreads, bytes, stream>>>(tq, tk, tv,
                                                                    a);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry for ctypes; bfloat16 q, k, v and out. strides: 12 int64, the
// (batch, head, seq) strides in elements of q, k, v and out, in that order
// (the last dimension of each is contiguous). d must be a multiple of 16 and
// at most 256; q, k and v 16-byte aligned, with every stride of a dimension
// longer than 1 a multiple of 8 elements (TMA's rule). Launches on `stream`
// of `device` and returns 0 when the launch was accepted, a CUDA error, or
// -CUresult when a tensor map could not be encoded; shapes it does not take
// return cudaErrorInvalidValue without launching.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k,
                                           const void* v, void* out,
                                           const long long* strides, int B,
                                           int Hq, int Hkv, int Sq, int Sk,
                                           int d, int causal, int window,
                                           float scale, float softcap,
                                           int device, void* stream) {
  const long long n_qt = (Sq + kBQ - 1) / kBQ;
  bool ok = B > 0 && Hq > 0 && Hkv > 0 && Hq % Hkv == 0 && Sq > 0 && Sk >= 0 &&
            d > 0 && d <= 256 && d % 16 == 0 && window >= 0 && n_qt <= 65535 &&
            (long long)B * Hq <= 0x7fffffffLL;
  const void* ptrs[3] = {q, k, v};
  const int extent[3][3] = {{B, Hq, Sq}, {B, Hkv, Sk}, {B, Hkv, Sk}};
  for (int t = 0; t < 3; ++t) {
    ok = ok && reinterpret_cast<uintptr_t>(ptrs[t]) % 16 == 0;
    for (int i = 0; i < 3; ++i)
      ok = ok && (extent[t][i] <= 1 || strides[3 * t + i] % 8 == 0);
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.o = out;
  for (int i = 0; i < 3; ++i) a.so[i] = strides[9 + i];
  a.Hq = Hq;
  a.g = Hq / Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.d = d;
  a.causal = causal != 0;
  a.window = window;
  a.n_qt = (int)n_qt;
  a.scale = scale;
  a.softcap = softcap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch<64>(q, k, v, strides, B, Hkv, a, s);
  if (d <= 128) return launch<128>(q, k, v, strides, B, Hkv, a, s);
  return launch<256>(q, k, v, strides, B, Hkv, a, s);
}

// The launch configuration for head_dim d (1 <= d <= 256): q rows per block,
// keys per tile and dynamic shared memory bytes, for the callers' checks and
// reports.
extern "C" void flash_attention_sm90_config(int d, int* block_q, int* block_k,
                                            int* smem_bytes) {
  *block_q = kBQ;
  *block_k = d <= 128 ? Cfg<128>::BK : Cfg<256>::BK;
  *smem_bytes = d <= 64    ? Cfg<64>::kSmem
                : d <= 128 ? Cfg<128>::kSmem
                           : Cfg<256>::kSmem;
}
