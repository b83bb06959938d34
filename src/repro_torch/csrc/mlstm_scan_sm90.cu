// Chunkwise-parallel stabilized mLSTM forward for Hopper (sm_90a) in the
// chunk-state form: three passes, float32, bfloat16 or float16 q/k/v,
// float32 gates, every product on the tensor cores as 3xTF32 with float32
// accumulation.
//
// Replaces src/repro/kernels/mlstm_scan/kernel.py::mlstm_scan (the Pallas TPU
// kernel, body `_kernel`). From a zero state (C = 0, n = 0, m = -40) it
// computes, for every (batch, head) and chunk of length L,
//
//   q, k, v (B, H, S, dh)    lf, li (B, H, S)    out (B, H, S, dh)
//
// with q, k, v, lf and li given by (batch, head, seq) strides in elements,
// the last dimension of q, k and v contiguous; out is contiguous, in q's
// dtype. The arithmetic is the TPU kernel's: q is scaled by dh^-1/2;
// F = cumsum(lf) in the chunk; D_ij = (F_i - F_j) + li_j for j <= i;
// m_i = max(max_j D_ij, F_i + m, -40); the row's output is
//   (sum_j e^(D_ij - m_i) (q_i.k_j) v_j + e^(F_i + m - m_i) q_i C)
//     / max(|sum_j e^(D_ij - m_i) (q_i.k_j) + e^(F_i + m - m_i) q_i.n|, e^-m_i)
// and the chunk folds into the state with m_new = max(F_L + m,
// max_j (F_L - F_j) + li_j, -40), wL_j = e^((F_L - F_j) + li_j - m_new),
// C = e^(F_L + m - m_new) C + sum_j (k_j wL_j) v_j^T, n likewise.
//
// Bound. At xLSTM-125m's layer shape (B=8, H=4, S=2048, dh=384, L=256) the
// function needs 51.6 GFLOP: q.C and the state update, 2 dh^2 each per row,
// are three quarters of it, the causal q.k^T and P.v the rest. Its bytes
// (q, k, v, out) are 50 MB, so operations bound it: 0.77 ms at the float32
// CUDA-core rate. The f32 tolerance rules out single TF32 products, so every
// product is split, x = hi + lo with hi = tf32(x), lo = x - hi, and a.b is
// taken as lo_a.hi_b + hi_a.lo_b + hi_a.hi_b (3xTF32, mma.sync m16n8k8):
// three tensor-core products per float32 product, 0.31 ms at the TF32 rate.
//
// Design. The work is split by what it depends on, so that q.k^T is taken
// once per row tile and every pass has several blocks per SM:
//
// 1. Scalars, in two kernels. One block per (b, h, chunk): F by a warp scan
//    summed in double and rounded once, the row maxima of D (one thread per
//    row), F_L and max_j (F_L - F_j) + li_j. One block per (b, h): the
//    carried m over the chunks in the reference's max order (one thread),
//    then per position m_i, e^(F_i + m - m_i) and wL_j.
// 2. States (one block per (b, h, 64 rows of C, 64, 96 or 128 columns), the
//    chunks in order): C += (K wL)^T V on the tensor cores, the accumulator
//    scaled by the chunk's decay in registers, n on the CUDA cores; after
//    each chunk the state entering the next one goes to device memory. Those
//    states are B H (S/L - 1) dh^2 floats, 132 MB at the layer shape: one
//    write and one read, about 0.08 ms of HBM time at 3.35 TB/s. 96 columns
//    at dh = 384 give 768 blocks, three resident per SM: two whole waves.
// 3. Outputs (one block per (b, h, chunk, 64 query rows), 1024 at the layer
//    shape, chunk 0 first and then the heaviest row tiles): S = q.k^T over
//    the visible keys once, P = e^(D - m_i) S into shared memory with its
//    row sums; then O = q.C_prev, scaled by e^(F_i + m - m_i), then
//    O += P.V, all dh columns in registers (16 warps, 32 rows x dh/8
//    columns each); q.n on the CUDA cores; O / max(|den|, e^-m_i) to out.
//    It is a programmatic dependent launch: it starts once every states
//    block is running, and a block waits for the states pass only before
//    its first read of a state, so chunk 0 and every block's q.k^T overlap
//    the states pass's last wave.
//
// Past chunk 256 or dh 512 nothing is refused; the work is cut further.
// The scalar pass walks a long chunk in segments of 256 rows
// (chunk_long_kernel). The states pass needs nothing new: it streams any
// chunk in slices of 32 keys and tiles any dh, its C workspace B H (S/L -
// 1) dh dhp floats with dhp = dh rounded up to 128 past 512 (at dh = 1024,
// S/L = 4, B H = 2: 25 MB). The outputs pass becomes outputs_cluster_kernel:
// a thread-block cluster of up to 8 CTAs per 64 query rows, which split the
// output columns (512 at most a CTA) and take q.k^T once, each over its own
// columns, summed in rank order over distributed shared memory; the keys
// go in slices of 128 through one P tile, and m_i is known from the scalar
// pass, so the slices' sums add without a rescale (its comment below).
// Shapes inside both limits keep the kernels above as they were.
//
// Passes 2 and 3 stream their operands through shared memory in slices of
// 32 along the contraction with cp.async (3 and 2 stages); 2-byte inputs
// are widened to float32 on the way in, so the tiles are float32 throughout.
// Keys above the diagonal are skipped or get weight 0: the TPU kernel's
// masked weight e^(-1e30 - m_i) is exactly 0 in float32.
//
// Accuracy. mma.sync adds into its float32 accumulator with truncation, so
// three products per k-step into one accumulator over K = dh drift further
// from float64 than the plain float32 scan; q.k^T, where that drift mattered
// most, sums each 32-wide slice in fresh accumulators and adds the slice
// rounded to nearest, and so does the cluster pass's q.C_prev past dh 1280.
//
// What sets the pace is not the tensor cores: a build that kept one product
// in three kept most of the time, and deeper pipelines did not help. It is
// the operand traffic from L2 into shared memory and the latency of the
// fragment loads and splits between barriers, which the outputs pass hides
// with 16 warps (a 256-thread block, free of spills, was slower).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 256;      // one block's rows and keys (scalars, P)
constexpr int kMaxDh = 512;         // one outputs block's columns
constexpr int kKs = 32;             // states: contraction slice per stage
constexpr int kKs3 = 32;            // outputs: contraction slice per stage
constexpr int kSl3 = kKs3 + 4;      // row stride of [row][slice] tiles
constexpr int kRows = 64;           // query rows per output block
constexpr int kDT = 64;             // state rows per state block
constexpr int kThreads1 = 256;      // scalars: one thread per chunk row
constexpr int kThreads2 = 256;      // states: 8 warps, 2 (rows) x 4 (cols)
constexpr int kThreads3 = 512;      // outputs: 16 warps, 2 (rows) x 8 (cols)
constexpr int kWarpsN3 = kThreads3 / 64;   // the outputs pass's column warps
constexpr int kStages2 = 3;
constexpr int kStages3 = 2;
constexpr float kNeg = -1e30f;
constexpr float kMMin = -40.0f;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* lf;
  const float* li;
  void* o;
  long long sq[3], sk[3], sv[3], sf[3], si[3];  // (batch, head, seq) strides
  int BH, H, S, dh, L, NC;
  int dhp;          // the states' row stride: dh rounded up
  int ncl, npr;     // the cluster outputs pass: CTAs a cluster, a row tile
  int vec;          // rows of q, k, v may be read 4 elements at a time
  float scale;
  float* F;         // (BH, S) cumsum of lf within each chunk
  float* Mi;        // (BH, S) row stabilizers m_i
  float* Sf;        // (BH, S) e^(F_i + m - m_i)
  float* wL;        // (BH, S) end-of-chunk weights wL_j
  float* FL;        // (BH, NC + 1) F at each chunk's last row
  float* G;         // (BH, NC + 1) max_j (F_L - F_j) + li_j of each chunk
  float* M;         // (BH, NC + 1) m entering each chunk, and after the last
  float* nst;       // (BH, NC - 1, dhp) n entering chunks 1 .. NC-1
  float* Cst;       // (BH, NC - 1, dh, dhp) C entering chunks 1 .. NC-1
};

// ---- copies into shared memory --------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory; zeros where !ok
__device__ __forceinline__ void cp16(float* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp4(float* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Elements [d, d + 4) of a row into 4 floats of shared memory, zeros at and
// past `lim` (lim = 0 for a row outside the input: `row` is then any valid
// address and nothing is read).
__device__ __forceinline__ void load4(float* dst, const float* row, int d,
                                      int lim, bool vec) {
  if (vec && d + 4 <= lim) {
    cp16(dst, row + d, true);
  } else if (vec && d >= lim) {
    cp16(dst, row, false);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = d + e < lim;
      cp4(dst + e, ok ? row + d + e : row, ok);
    }
  }
}
__device__ __forceinline__ void load4(float* dst, const __nv_bfloat16* row,
                                      int d, int lim, bool vec) {
  float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec && d + 4 <= lim) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(row + d);
    const float2 a = __bfloat1622float2(p[0]), b = __bfloat1622float2(p[1]);
    f = make_float4(a.x, a.y, b.x, b.y);
  } else {
    if (d < lim) f.x = __bfloat162float(row[d]);
    if (d + 1 < lim) f.y = __bfloat162float(row[d + 1]);
    if (d + 2 < lim) f.z = __bfloat162float(row[d + 2]);
    if (d + 3 < lim) f.w = __bfloat162float(row[d + 3]);
  }
  *reinterpret_cast<float4*>(dst) = f;
}
__device__ __forceinline__ void load4(float* dst, const __half* row, int d,
                                      int lim, bool vec) {
  float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec && d + 4 <= lim) {
    const __half2* p = reinterpret_cast<const __half2*>(row + d);
    const float2 a = __half22float2(p[0]), b = __half22float2(p[1]);
    f = make_float4(a.x, a.y, b.x, b.y);
  } else {
    if (d < lim) f.x = __half2float(row[d]);
    if (d + 1 < lim) f.y = __half2float(row[d + 1]);
    if (d + 2 < lim) f.z = __half2float(row[d + 2]);
    if (d + 3 < lim) f.w = __half2float(row[d + 3]);
  }
  *reinterpret_cast<float4*>(dst) = f;
}

template <typename T>
__device__ __forceinline__ void store(T* p, float x);
template <>
__device__ __forceinline__ void store<float>(float* p, float x) { *p = x; }
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p,
                                                     float x) {
  *p = __float2bfloat16(x);
}
template <>
__device__ __forceinline__ void store<__half>(__half* p, float x) {
  *p = __float2half_rn(x);
}

// Programmatic dependent launch: the states pass lets the outputs pass
// start once all its blocks are running; the outputs pass waits for it to
// finish (and its stores to be visible) before it reads a state.
__device__ __forceinline__ void grid_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---- 3xTF32 products --------------------------------------------------------

// x = hi + lo: hi is x rounded to TF32 (ties away from zero, as
// cvt.rna.tf32.f32) by integer operations, lo = x - hi exactly; the tensor
// core reads lo's top 11 significant bits. The conversion instruction runs
// at a quarter of the integer rate and set the pace of every product loop.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

// d += a.b, m16n8k8, TF32 inputs, float32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the two m tiles of a warp against one n tile: small terms first
__device__ __forceinline__ void mma3(float (&d0)[4], float (&d1)[4],
                                     const uint32_t (&ah)[2][4],
                                     const uint32_t (&al)[2][4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma(d0, al[0], bh);
  mma(d1, al[1], bh);
  mma(d0, ah[0], bl);
  mma(d1, ah[1], bl);
  mma(d0, ah[0], bh);
  mma(d1, ah[1], bh);
}

// A fragments of rows r0 + 16 m (+ 8) and columns kk + t (+ 4) of a
// row-major [row][col] tile with row stride ld, times `mul`, split
__device__ __forceinline__ void a_frags(const float* A, int ld, int r0,
                                        int kk, int t, float mul,
                                        uint32_t (&ah)[2][4],
                                        uint32_t (&al)[2][4]) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float* p = A + (r0 + 16 * m) * ld + kk + t;
    split(p[0] * mul, ah[m][0], al[m][0]);
    split(p[8 * ld] * mul, ah[m][1], al[m][1]);
    split(p[4] * mul, ah[m][2], al[m][2]);
    split(p[8 * ld + 4] * mul, ah[m][3], al[m][3]);
  }
}

// ---- pass 1: scalars --------------------------------------------------------

// One block per (b, h, chunk): F, the row maxima of D and the chunk's
// scalars F_L and max_j (F_L - F_j) + li_j, which do not depend on m.
__global__ void __launch_bounds__(kThreads1) chunk_kernel(const Args a) {
  __shared__ float Fs[kMaxChunk], lis[kMaxChunk];
  __shared__ double wsum[kThreads1 / 32];
  __shared__ float wmax[kThreads1 / 32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, L = a.L;
  const int c = blockIdx.x % a.NC, bh = blockIdx.x / a.NC;
  const int b = bh / a.H, h = bh % a.H;
  const bool on = t < L;
  const long long s = (long long)c * L + t;
  const float x = on ? a.lf[b * a.sf[0] + h * a.sf[1] + s * a.sf[2]] : 0.f;
  const float lv = on ? a.li[b * a.si[0] + h * a.si[1] + s * a.si[2]] : 0.f;
  double cs = x;                       // inclusive prefix sum in the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(kFull, cs, off);
    if (lane >= off) cs += y;
  }
  if (lane == 31) wsum[w] = cs;
  __syncthreads();
  for (int i = 0; i < w; ++i) cs += wsum[i];
  const float Ft = static_cast<float>(cs);   // summed in double, rounded once
  if (on) {
    Fs[t] = Ft;
    lis[t] = lv;
  }
  __syncthreads();
  const float FL = Fs[L - 1];
  float lm = kNeg;                     // max over j <= t of D_tj
  if (on)
    for (int j = 0; j <= t; ++j) lm = fmaxf(lm, (Ft - Fs[j]) + lis[j]);
  float gv = on ? (FL - Ft) + lv : -INFINITY;
#pragma unroll
  for (int off = 16; off; off >>= 1)
    gv = fmaxf(gv, __shfl_xor_sync(kFull, gv, off));
  if (lane == 0) wmax[w] = gv;
  __syncthreads();
  const long long p = (long long)bh * a.S + s;
  if (on) {
    a.F[p] = Ft;
    a.Mi[p] = lm;                      // the row maximum until the carry pass
  }
  if (t == 0) {
    float gmax = wmax[0];
    for (int i = 1; i < kThreads1 / 32; ++i) gmax = fmaxf(gmax, wmax[i]);
    const long long q = (long long)bh * (a.NC + 1) + c;
    a.FL[q] = FL;
    a.G[q] = gmax;
  }
}

// The same scalars where a chunk has more rows than the block has threads
// (L > kMaxChunk): the prefix sum runs over segments of 256 rows with the
// running total carried in double, F goes straight to the workspace (the
// block reads it back after a barrier), and each thread takes rows t, t +
// 256, ... of the row maxima, O(L^2 / 2) work a chunk as before. No
// shared array depends on L.
__global__ void __launch_bounds__(kThreads1) chunk_long_kernel(const Args a) {
  __shared__ double wsum[kThreads1 / 32];
  __shared__ float wmax[kThreads1 / 32];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, L = a.L;
  const int c = blockIdx.x % a.NC, bh = blockIdx.x / a.NC;
  const int b = bh / a.H, h = bh % a.H;
  const float* lfg = a.lf + b * a.sf[0] + h * a.sf[1];
  const float* lig = a.li + b * a.si[0] + h * a.si[1];
  const long long s0 = (long long)c * L;
  float* Fg = a.F + (long long)bh * a.S + s0;
  double run = 0.0;                    // the earlier segments' sum
  for (int t0 = 0; t0 < L; t0 += kThreads1) {
    const int r = t0 + t;
    const bool on = r < L;
    double cs = on ? lfg[(s0 + r) * a.sf[2]] : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double y = __shfl_up_sync(kFull, cs, off);
      if (lane >= off) cs += y;
    }
    if (lane == 31) wsum[w] = cs;
    __syncthreads();
    double seg = 0.0;
    for (int i = 0; i < kThreads1 / 32; ++i) {
      if (i < w) cs += wsum[i];
      seg += wsum[i];
    }
    if (on) Fg[r] = static_cast<float>(run + cs);  // rounded once
    run += seg;
    __syncthreads();                   // wsum is rewritten next segment
  }
  const float FL = Fg[L - 1];
  float gv = -INFINITY;
  for (int r = t; r < L; r += kThreads1) {
    const float Ft = Fg[r], lv = lig[(s0 + r) * a.si[2]];
    gv = fmaxf(gv, (FL - Ft) + lv);
    float lm = kNeg;                   // max over j <= r of D_rj
    for (int j = 0; j <= r; ++j)
      lm = fmaxf(lm, (Ft - Fg[j]) + lig[(s0 + j) * a.si[2]]);
    a.Mi[(long long)bh * a.S + s0 + r] = lm;
  }
#pragma unroll
  for (int off = 16; off; off >>= 1)
    gv = fmaxf(gv, __shfl_xor_sync(kFull, gv, off));
  if (lane == 0) wmax[w] = gv;
  __syncthreads();
  if (t == 0) {
    float gmax = wmax[0];
    for (int i = 1; i < kThreads1 / 32; ++i) gmax = fmaxf(gmax, wmax[i]);
    const long long q = (long long)bh * (a.NC + 1) + c;
    a.FL[q] = FL;
    a.G[q] = gmax;
  }
}

// One block per (b, h): the carried m, chunk by chunk in the reference's
// max order, then per position m_i, e^(F_i + m - m_i) and wL_i.
__global__ void __launch_bounds__(kThreads1) carry_kernel(const Args a) {
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, L = a.L;
  const long long q0 = (long long)bh * (a.NC + 1);
  float* mc = a.M + q0;
  if (threadIdx.x == 0) {
    float m = kMMin;
    for (int c = 0; c < a.NC; ++c) {
      mc[c] = m;
      m = fmaxf(fmaxf(a.FL[q0 + c] + m, a.G[q0 + c]), kMMin);
    }
    mc[a.NC] = m;
  }
  __syncthreads();
  const float* lig = a.li + b * a.si[0] + h * a.si[1];
  for (int s = threadIdx.x; s < a.S; s += kThreads1) {
    const int c = s / L;
    const long long p = (long long)bh * a.S + s;
    const float m = mc[c], m_new = mc[c + 1], Ft = a.F[p];
    const float mi = fmaxf(fmaxf(a.Mi[p], Ft + m), kMMin);
    a.Mi[p] = mi;
    a.Sf[p] = expf((Ft + m) - mi);
    a.wL[p] = expf(((a.FL[q0 + c] - Ft) + lig[(long long)s * a.si[2]]) - m_new);
  }
}

// ---- pass 2: the state entering each chunk ---------------------------------

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads2, BN == 128 ? 2 : 3)
    states_kernel(const Args a, int dhp) {
  constexpr int KS = kDT + 8;         // row stride of the K tile [key][d]
  constexpr int VS = BN + 8;          // row stride of the V tile [key][e]
  constexpr int NW = BN / 32;         // n tiles per warp (4 warps across BN)
  constexpr int STAGE = kKs * KS + kKs * VS + kKs;
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wm = w & 1, wn = w >> 1;
  const int n_dt = dhp / kDT, n_et = dhp / BN;
  const int dt = blockIdx.x % n_dt, et = (blockIdx.x / n_dt) % n_et;
  const int bh = blockIdx.x / (n_dt * n_et), b = bh / a.H, h = bh % a.H;
  const int d0 = dt * kDT, e0 = et * BN, L = a.L;
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const float* wLg = a.wL + (long long)bh * a.S;
  const int n_sl = (L + kKs - 1) / kKs;
  const int n_jobs = (a.NC - 1) * n_sl;  // the last chunk's state is not needed
  const bool vec = a.vec;
  grid_launch_dependents();

  auto issue = [&](int job) {
    if (job < n_jobs) {
      float* Ks = sm + (job % kStages2) * STAGE;
      float* Vs = Ks + kKs * KS;
      float* ws = Vs + kKs * VS;
      const int c = job / n_sl, j0 = (job % n_sl) * kKs;
      for (int e = tid; e < kKs * (kDT / 4); e += kThreads2) {
        const int r = e / (kDT / 4), ch = e % (kDT / 4), j = j0 + r;
        const bool ok = j < L;
        load4(Ks + r * KS + 4 * ch,
              ok ? kg + ((long long)c * L + j) * a.sk[2] : kg, d0 + 4 * ch,
              ok ? a.dh : 0, vec);
      }
      for (int e = tid; e < kKs * (BN / 4); e += kThreads2) {
        const int r = e / (BN / 4), ch = e % (BN / 4), j = j0 + r;
        const bool ok = j < L;
        load4(Vs + r * VS + 4 * ch,
              ok ? vg + ((long long)c * L + j) * a.sv[2] : vg, e0 + 4 * ch,
              ok ? a.dh : 0, vec);
      }
      if (tid < kKs) {
        const int j = j0 + tid;
        const bool ok = j < L;
        cp4(ws + tid, ok ? wLg + (long long)c * L + j : wLg, ok);
      }
    }
    cp_commit();
  };

  float acc[2][NW][4] = {};
  float nacc = 0.f;
  const bool do_n = et == 0 && tid < kDT;
  issue(0);
  issue(1);
  for (int job = 0; job < n_jobs; ++job) {
    cp_wait<1>();
    __syncthreads();
    issue(job + 2);
    const int c = job / n_sl, sl = job % n_sl;
    if (sl == 0 && c > 0) {            // C_(c+1) = decay_c C_c + (K wL)^T V
      const long long q = (long long)bh * (a.NC + 1) + c;
      const float dc = expf((a.FL[q] + a.M[q]) - a.M[q + 1]);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NW; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[m][n][r] *= dc;
      nacc *= dc;
    }
    const float* Ks = sm + (job % kStages2) * STAGE;
    const float* Vs = Ks + kKs * KS;
    const float* ws = Vs + kKs * VS;
#pragma unroll
    for (int kk = 0; kk < kKs; kk += 8) {
      // A[d][j] = k_jd wL_j, read from the [key][d] tile
      const float w0 = ws[kk + t4], w1 = ws[kk + t4 + 4];
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* p = Ks + (kk + t4) * KS + 32 * wm + 16 * m + g;
        split(p[0] * w0, ah[m][0], al[m][0]);
        split(p[8] * w0, ah[m][1], al[m][1]);
        split(p[4 * KS] * w1, ah[m][2], al[m][2]);
        split(p[4 * KS + 8] * w1, ah[m][3], al[m][3]);
      }
#pragma unroll
      for (int n = 0; n < NW; ++n) {
        const float* p = Vs + (kk + t4) * VS + wn * (BN / 4) + 8 * n + g;
        uint32_t bh_[2], bl[2];
        split(p[0], bh_[0], bl[0]);
        split(p[4 * VS], bh_[1], bl[1]);
        mma3(acc[0][n], acc[1][n], ah, al, bh_, bl);
      }
    }
    if (do_n)
#pragma unroll 8
      for (int j = 0; j < kKs; ++j) nacc = fmaf(Ks[j * KS + tid], ws[j], nacc);
    if (sl == n_sl - 1) {              // the state entering chunk c + 1
      const long long st = (long long)bh * (a.NC - 1) + c;
      float* Cg = a.Cst + st * a.dh * dhp;
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int d = d0 + 32 * wm + 16 * m + g + 8 * hh;
          if (d >= a.dh) continue;
#pragma unroll
          for (int n = 0; n < NW; ++n) {
            const int e = e0 + wn * (BN / 4) + 8 * n + 2 * t4;
            *reinterpret_cast<float2*>(Cg + (long long)d * dhp + e) =
                make_float2(acc[m][n][2 * hh], acc[m][n][2 * hh + 1]);
          }
        }
      if (do_n) a.nst[st * dhp + d0 + tid] = nacc;
    }
  }
}

// ---- pass 3: the outputs ----------------------------------------------------

template <typename T, int NT>
__global__ void __launch_bounds__(kThreads3, 1) outputs_kernel(const Args a,
                                                               int lp) {
  constexpr int DHP = 64 * NT;        // dh rounded up
  constexpr int NTW = DHP / (8 * kWarpsN3);      // output n tiles per warp
  constexpr int KNT = kMaxChunk / (8 * kWarpsN3);  // key n tiles per warp
  constexpr int TPR = kThreads3 / kRows;          // q.n: threads per row
  constexpr int CS = DHP + 8;         // row stride of C and V slices [row][e]
  extern __shared__ __align__(16) float sm[];
  const int PS = lp + 4;              // row stride of P [row][key]
  const int stage =
      max(kRows * kSl3 + lp * kSl3, kRows * kSl3 + kKs3 * CS + kKs3);
  float* Ps = sm + kStages3 * stage;
  float* Frow = Ps + kRows * PS;      // F_i, m_i, e^(F_i + m - m_i) of the rows
  float* Mrow = Frow + kRows;
  float* Sfrow = Mrow + kRows;
  float* Fk = Sfrow + kRows;          // F_j, li_j of the keys
  float* lik = Fk + lp;
  float* denp = lik + lp;             // row sums of P per column warp
  float* qn_s = denp + kWarpsN3 * kRows;          // q_i.n

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wm = w & 1, wn = w >> 1;
  const int L = a.L, NC = a.NC, dh = a.dh;
  // Chunk 0 (no state) first, so that it runs while the states pass ends;
  // then the other chunks, heaviest row tiles first.
  const int n_rt = (L + kRows - 1) / kRows, n0 = n_rt * a.BH;
  int it, c, bh;
  if ((int)blockIdx.x < n0) {
    c = 0;
    it = n_rt - 1 - blockIdx.x / a.BH;
    bh = blockIdx.x % a.BH;
  } else {
    const int x = blockIdx.x - n0, per = (NC - 1) * a.BH;
    it = n_rt - 1 - x / per;
    c = 1 + (x % per) % (NC - 1);
    bh = (x % per) / (NC - 1);
  }
  const int b = bh / a.H, h = bh % a.H;
  const int i0 = it * kRows, Nv = min(i0 + kRows, L);
  const int nvp = (Nv + 63) / 64 * 64;           // keys, rounded up
  const int nkt = nvp / (8 * kWarpsN3);           // key n tiles per warp
  const T* qg = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const float* lig = a.li + b * a.si[0] + h * a.si[1];
  const long long s0 = (long long)c * L;               // the chunk's first row
  const long long w0 = (long long)bh * a.S + s0;       // ... in the workspace
  const float scale = a.scale;
  const bool vec = a.vec;

  if (tid < kRows) {
    const int i = i0 + tid;
    const bool ok = i < L;
    Frow[tid] = ok ? a.F[w0 + i] : 0.f;
    Mrow[tid] = ok ? a.Mi[w0 + i] : 0.f;
    Sfrow[tid] = ok ? a.Sf[w0 + i] : 0.f;
  }
  for (int j = tid; j < nvp; j += kThreads3) {
    const bool ok = j < Nv;
    Fk[j] = ok ? a.F[w0 + j] : 0.f;
    lik[j] = ok ? lig[(s0 + j) * a.si[2]] : 0.f;
  }

  const int nd = (dh + kKs3 - 1) / kKs3;
  const int nB = nd, nC1 = c > 0 ? nd : 0, nC2 = (Nv + kKs3 - 1) / kKs3;
  const int n_jobs = nB + nC1 + nC2;
  const long long st = (long long)bh * (NC - 1) + c - 1;  // state (c > 0)

  // job j < nB: q and k slices over d; < nB + nC1: q and C (and n) slices
  // over d; else v rows over the keys
  auto issue = [&](int job) {
    if (job < n_jobs) {
      float* Qs = sm + (job % kStages3) * stage;
      float* Xs = Qs + kRows * kSl3;
      if (job == nB && nC1) grid_wait();  // the states pass is done
      if (job < nB + nC1) {
        const int d0 = kKs3 * (job < nB ? job : job - nB);
        for (int e = tid; e < kRows * (kKs3 / 4); e += kThreads3) {
          const int r = e / (kKs3 / 4), ch = e % (kKs3 / 4), i = i0 + r;
          const bool ok = i < L;
          load4(Qs + r * kSl3 + 4 * ch,
                ok ? qg + (s0 + i) * a.sq[2] : qg, d0 + 4 * ch, ok ? dh : 0,
                vec);
        }
        if (job < nB) {
          for (int e = tid; e < nvp * (kKs3 / 4); e += kThreads3) {
            const int r = e / (kKs3 / 4), ch = e % (kKs3 / 4);
            const bool ok = r < Nv;
            load4(Xs + r * kSl3 + 4 * ch,
                  ok ? kg + (s0 + r) * a.sk[2] : kg, d0 + 4 * ch,
                  ok ? dh : 0, vec);
          }
        } else {
          const float* Cg = a.Cst + st * dh * DHP;
          for (int e = tid; e < kKs3 * (DHP / 4); e += kThreads3) {
            const int r = e / (DHP / 4), ch = e % (DHP / 4), d = d0 + r;
            const bool ok = d < dh;
            cp16(Xs + r * CS + 4 * ch,
                 ok ? Cg + (long long)d * DHP + 4 * ch : Cg, ok);
          }
          if (tid < kKs3)
            cp4(Xs + kKs3 * CS + tid, a.nst + st * DHP + d0 + tid, true);
        }
      } else {
        const int j0 = kKs3 * (job - nB - nC1);
        for (int e = tid; e < kKs3 * (DHP / 4); e += kThreads3) {
          const int r = e / (DHP / 4), ch = e % (DHP / 4), j = j0 + r;
          const bool ok = j < Nv;
          load4(Xs + r * CS + 4 * ch, ok ? vg + (s0 + j) * a.sv[2] : vg,
                4 * ch, ok ? dh : 0, vec);
        }
      }
    }
    cp_commit();
  };

  for (int job = 0; job < kStages3 - 1; ++job) issue(job);
  const int r0 = 32 * wm + g;          // this thread's first fragment row

  // ---- S = q.k^T over the visible keys, then P and its row sums ----------
  {
    float s[2][KNT][4] = {};
    const int kb = wn * 8 * nkt;       // this warp's first key
    for (int job = 0; job < nB; ++job) {
      cp_wait<kStages3 - 2>();
      __syncthreads();
      issue(job + kStages3 - 1);
      const float* Qs = sm + (job % kStages3) * stage;
      const float* Ks = Qs + kRows * kSl3;
      float ps[2][KNT][4] = {};        // this slice's sums, added rounded
#pragma unroll
      for (int kk = 0; kk < kKs3; kk += 8) {
        uint32_t ah[2][4], al[2][4];
        a_frags(Qs, kSl3, r0, kk, t4, scale, ah, al);
#pragma unroll
        for (int n = 0; n < KNT; ++n) {
          if (n < nkt) {
            const float* p = Ks + (kb + 8 * n + g) * kSl3 + kk + t4;
            uint32_t bh_[2], bl[2];
            split(p[0], bh_[0], bl[0]);
            split(p[4], bh_[1], bl[1]);
            mma3(ps[0][n], ps[1][n], ah, al, bh_, bl);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < KNT; ++n)
#pragma unroll
          for (int r = 0; r < 4; ++r) s[m][n][r] += ps[m][n][r];
    }
    float rs[2][2] = {};
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < KNT; ++n) {
        if (n >= nkt) continue;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int il = r0 + 16 * m + 8 * hh, i = i0 + il;
          const int jl = kb + 8 * n + 2 * t4;
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int j = jl + e;
            p[e] = (j <= i && i < L)
                       ? expf(((Frow[il] - Fk[j]) + lik[j]) - Mrow[il]) *
                             s[m][n][2 * hh + e]
                       : 0.f;
            rs[m][hh] += p[e];
          }
          *reinterpret_cast<float2*>(Ps + il * PS + jl) =
              make_float2(p[0], p[1]);
        }
      }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float x = rs[m][hh];
        x += __shfl_xor_sync(kFull, x, 1);
        x += __shfl_xor_sync(kFull, x, 2);
        if (t4 == 0) denp[wn * kRows + r0 + 16 * m + 8 * hh] = x;
      }
  }

  // ---- O = q.C_prev, scaled by e^(F_i + m - m_i); q.n ---------------------
  float o[2][NTW][4] = {};
  const int cb = wn * 8 * NTW;         // this warp's first output column
  float qn = 0.f;
  for (int job = nB; job < nB + nC1; ++job) {
    cp_wait<kStages3 - 2>();
    __syncthreads();
    issue(job + kStages3 - 1);
    const float* Qs = sm + (job % kStages3) * stage;
    const float* Cs = Qs + kRows * kSl3;
#pragma unroll
    for (int kk = 0; kk < kKs3; kk += 8) {
      uint32_t ah[2][4], al[2][4];
      a_frags(Qs, kSl3, r0, kk, t4, scale, ah, al);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const float* p = Cs + (kk + t4) * CS + cb + 8 * n + g;
        uint32_t bh_[2], bl[2];
        split(p[0], bh_[0], bl[0]);
        split(p[4 * CS], bh_[1], bl[1]);
        mma3(o[0][n], o[1][n], ah, al, bh_, bl);
      }
    }
    constexpr int QN = kKs3 / TPR;     // columns of the slice per thread
    const float* ns = Cs + kKs3 * CS + QN * (tid % TPR);
    const float* qr = Qs + (tid / TPR) * kSl3 + QN * (tid % TPR);
#pragma unroll
    for (int e = 0; e < QN; ++e) qn = fmaf(qr[e] * scale, ns[e], qn);
  }
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    qn += __shfl_xor_sync(kFull, qn, off);
  if (tid % TPR == 0) qn_s[tid / TPR] = qn;
  if (nC1) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float sf = Sfrow[r0 + 16 * m + 8 * hh];
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          o[m][n][2 * hh] *= sf;
          o[m][n][2 * hh + 1] *= sf;
        }
      }
  }

  // ---- O += P.V ----------------------------------------------------------
  for (int job = nB + nC1; job < n_jobs; ++job) {
    cp_wait<kStages3 - 2>();
    __syncthreads();
    issue(job + kStages3 - 1);
    const int j0 = kKs3 * (job - nB - nC1);
    const float* Vs = sm + (job % kStages3) * stage + kRows * kSl3;
#pragma unroll
    for (int kk = 0; kk < kKs3; kk += 8) {
      uint32_t ah[2][4], al[2][4];
      a_frags(Ps, PS, r0, j0 + kk, t4, 1.f, ah, al);
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const float* p = Vs + (kk + t4) * CS + cb + 8 * n + g;
        uint32_t bh_[2], bl[2];
        split(p[0], bh_[0], bl[0]);
        split(p[4 * CS], bh_[1], bl[1]);
        mma3(o[0][n], o[1][n], ah, al, bh_, bl);
      }
    }
  }

  // ---- h = O / max(|den|, e^-m_i) -----------------------------------------
  T* og = static_cast<T*>(a.o) + ((long long)bh * a.S + s0) * dh;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int il = r0 + 16 * m + 8 * hh, i = i0 + il;
      if (i >= L) continue;
      float den = 0.f;
#pragma unroll
      for (int x = 0; x < kWarpsN3; ++x) den += denp[x * kRows + il];
      den += qn_s[il] * Sfrow[il];
      const float lim = fmaxf(fabsf(den), expf(-Mrow[il]));
      T* orow = og + (long long)i * dh;
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int e = cb + 8 * n + 2 * t4;
        if (e < dh) store(orow + e, o[m][n][2 * hh] / lim);
        if (e + 1 < dh) store(orow + e + 1, o[m][n][2 * hh + 1] / lim);
      }
    }
}

// ---- pass 3 past one block's reach: thread-block clusters ---------------------

// Every thread of the cluster arrives, then waits: the arrival releases this
// thread's shared-memory writes to the cluster, the wait acquires the
// others'.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// An A operand (64 rows x K) split once, in fragment order: the four
// registers a0..a3 of lane l for the 16-row block m and the 8-wide k step s
// (rows 16 m + l / 4 and + 8, columns 8 s + l % 4 and + 4) lie together, as
// one float4 at ((m K/8 + s) 32 + l) 4, in a hi and a lo array.
__device__ __forceinline__ void a_load(const float* hi, const float* lo,
                                       int idx, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const float4 h = *reinterpret_cast<const float4*>(hi + idx);
  const float4 l = *reinterpret_cast<const float4*>(lo + idx);
  ah[0] = __float_as_uint(h.x);
  ah[1] = __float_as_uint(h.y);
  ah[2] = __float_as_uint(h.z);
  ah[3] = __float_as_uint(h.w);
  al[0] = __float_as_uint(l.x);
  al[1] = __float_as_uint(l.y);
  al[2] = __float_as_uint(l.z);
  al[3] = __float_as_uint(l.w);
}

// O += A.B over one stage of KD along the contraction, for the cluster
// pass: A (64 rows) split once, in fragment order (hi, lo), its k steps s8
// .. s8 + kn - 1 of k8 (kn <= KD / 8: the rest are zeros of A); B a [k][e]
// slice of row stride cs, split as it is read.
// Warp (wm, wn) holds rows 32 wm .. 32 wm + 31 (two m tiles) and the unit
// tiles wn, wn + 8, ... below u_n of the CTA's columns.
template <int KD, int NT>
__device__ __forceinline__ void cluster_products(
    float (&o)[2][NT][4], const float* Ah, const float* Al, int k8, int s8,
    const float* X, int cs, int wm, int wn, int lane, int u_n, int kn) {
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KD / 8; ++kk) {
    if (kk >= kn) break;
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
      a_load(Ah, Al, (((2 * wm + m) * k8 + s8 + kk) * 32 + lane) * 4, ah[m],
             al[m]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int nt = wn + kWarpsN3 * n;
      if (nt < u_n) {
        const float* p = X + (8 * kk + t4) * cs + 8 * nt + g;
        uint32_t bh_[2], bl[2];
        split(p[0], bh_[0], bl[0]);
        split(p[4 * cs], bh_[1], bl[1]);
        mma3(o[0][n], o[1][n], ah, al, bh_, bl);
      }
    }
  }
}

constexpr int kMaxCluster = 8;      // CTAs a cluster (the portable limit)
constexpr int kFreshDh = 1280;      // past it a CTA holds 256 columns at most
constexpr int kFreshNt = 4;         // ... and adds q.C_prev's slices rounded
constexpr int kKeys = 128;          // keys of a key slice (one P tile)
constexpr int kSd = 64;             // S jobs: contraction slice per stage
constexpr int kSl4 = kSd + 4;       // row stride of their [row][slice] tiles

// P.V jobs' keys per stage: the whole key slice where a CTA holds 128
// columns or fewer, 64 where it holds 256 or fewer, else 32 (what the
// stages' shared memory holds): narrow heads leave the grid small, and
// each job's latency then sets the pace.
__host__ __device__ constexpr int cluster_vd(int nt) {
  return nt <= 2 ? kKeys : nt <= 4 ? 64 : 32;
}

// The shared memory of outputs_cluster_kernel<T, NT>, in floats.
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int cluster_stage(int nt) {
  return cmax(cmax(kKs3 * (64 * nt + 8) + kKs3, (kRows + kKeys) * kSl4),
              cluster_vd(nt) * (64 * nt + 8));
}
// q's hi (and lo) in fragment order: a 32-wide slice, or at nt = 1 (dh <=
// 64) the row tile's whole q, split once for every job
__host__ __device__ constexpr int cluster_qf(int nt) {
  return nt == 1 ? kRows * 64 : kRows * kKs3;
}
__host__ __device__ constexpr int cluster_floats(int nt) {
  return kStages3 * cluster_stage(nt) + 2 * cluster_qf(nt) +
         2 * kRows * kKeys + 4 * kRows + 2 * kKeys + kWarpsN3 * kRows +
         4 * kRows;
}

// Pass 3 past one block's reach (chunk > kMaxChunk or dh > kMaxDh): one
// thread-block cluster of ncl = min(ceil(dh / kMaxDh), 8) CTAs per (b, h,
// chunk, 64 query rows), past dh kFreshDh min(ceil(dh / 256), 8), the CTAs
// consecutive in the grid's x.
//
// * Columns. dh is cut into 8-column units; the npr CTAs of a row tile (ncl,
//   or past 8 CTAs groups of 8) take an even share of them each, at most 64
//   (512 columns), so no CTA computes a column past dh but the last unit's.
//   The 16 warps are 2 (32 rows each) x 8; column warp wn holds the unit
//   tiles wn, wn + 8, ... of the CTA's share, NT of them at most (64 NT
//   columns; NT = 1 only where dh <= 64).
// * S once per cluster. Rank r takes the partial S = q.k^T over its own
//   columns of q and k (an even share of dh's units over the ncl ranks), so
//   k is read once per cluster; the partial builds up in the P tile, and
//   after a cluster barrier every CTA reads all of them over distributed
//   shared memory (mapa, ld.shared::cluster) and sums them in rank order 0,
//   1, ..., ncl - 1: every CTA holds the same bits of S, so of P, its row
//   sums and the denominator max(|den|, e^-m_i) it divides by. A second
//   cluster barrier keeps the peers' reads ahead of P overwriting the
//   partial. Past 8 CTAs each group of 8 takes S anew over all of dh. q.n,
//   1/dh of q.C's work, is taken over all of dh by every CTA, in the same
//   order.
// * Split once, where it pays. For q.C_prev (most of the work) q is read
//   a slice ahead into registers, scaled and split by the thread that read
//   it into hi and lo tiles in fragment order (one more barrier a slice),
//   so a warp loads its A fragments as two float4s and no warp splits q
//   again; P is split once as it is written, the same way. C, k and v are
//   split as they are read (by two row warps each). S's jobs take q and k
//   raw, 64 columns a stage, and split q as they read it: there a second
//   barrier a stage cost more than the splits. At dh <= 64 (NT = 1) the
//   row tile's whole q fits: it is split once before the first job, and
//   S's jobs and q.C's read it there (QO), so S's stages carry k alone.
// * Accuracy. mma.sync adds with truncation, so one accumulator over all
//   of dh drifts: at dh = 2048 q.C_prev's sum reached the float32 bar. A
//   CTA of kFreshNt n tiles or fewer adds each 32-wide slice of q.C_prev
//   in fresh accumulators, rounded to nearest, and past dh kFreshDh every
//   CTA is one (256 columns at most).
// * Zeros. Keys past a warp's last row weigh 0: S and P.V leave out the
//   key tiles and k steps a warp's 32 rows do not see, and the P.V jobs of
//   a short last key slice stop at its last key.
// * Order. The keys in slices of kKeys (a P tile each): key slice 0's S,
//   the exchange, q.C_prev over the CTA's columns (scaled by e^(F_i + m -
//   m_i)), key slice 0's P.V; then each later key slice's S, exchange and
//   P.V. m_i comes from the scalar pass, so the slices add without a
//   rescale, and O is not live while the first S is taken.
// * Grid. Chunk 0 (no state) first, so that it runs while the states pass
//   ends. Up to chunk 256 (four row tiles) by (b, h, chunk), the row tiles
//   of one chunk together, heaviest first: they read the same C_prev
//   columns, so mostly from L2. Past it the row tiles' S and P.V work
//   spreads over more keys, and the heaviest tiles of every chunk go
//   first, as in outputs_kernel.
// * Copies. Each stage's (row, 4-float chunk) pairs go over all 512
//   threads: with a fixed chunk per thread, a narrow CTA left most threads
//   idle at the barrier while a few issued every copy.
//
// What sets its pace (benchmarks_torch/mlstm_variants.py's probes on an
// H100 at 700 W, B=8, H=4, S=2048): at dh = 1024 q.C_prev's products run
// at about two clocks per mma.sync, that instruction's rate on the SM, and
// the work around the products (copies, barriers, q's split, the scalars
// of P) takes about as long again; the exchange about 1%. Splitting C and
// v once would save at most what leaving their splits out saves, 6% of the
// pass at dh = 1024. TF32 wgmma would need C_prev and v K-major and split
// in shared memory; it is not tried. At dh = 64 the copies, barriers and
// scalars outweigh the products (about 0.15 of 0.27 ms).
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads3, 1)
    outputs_cluster_kernel(const Args a) {
  constexpr int CS = 64 * NT + 8;     // row stride of C and V slices [row][e]
  constexpr int VD = cluster_vd(NT);  // keys of a P.V job
  constexpr int STAGE = cluster_stage(NT);
  constexpr int QF = cluster_qf(NT);  // q in fragment order
  constexpr bool QO = NT == 1;        // q split once for the row tile
  constexpr int PF = kRows * kKeys;   // a P tile in fragment order
  extern __shared__ __align__(16) float sm[];
  float* Qh = sm + kStages3 * STAGE;  // q's hi and lo
  float* Ql = Qh + QF;
  float* Ph = Ql + QF;                // P's hi and lo; Ph holds the partial S
  float* Pl = Ph + PF;
  float* Frow = Pl + PF;              // F_i, m_i, e^(F_i + m - m_i) of the rows
  float* Mrow = Frow + kRows;
  float* Sfrow = Mrow + kRows;
  float* den_s = Sfrow + kRows;       // the rows' max(|den|, e^-m_i)
  float* Fk = den_s + kRows;          // F_j, li_j of the key slice
  float* lik = Fk + kKeys;
  float* denp = lik + kKeys;          // row sums of P per column warp
  float* qn_s = denp + kWarpsN3 * kRows;         // q_i.n by k step

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3, wm = w & 1, wn = w >> 1;
  const int L = a.L, NC = a.NC, dh = a.dh, dhp = a.dhp;
  const int ncl = a.ncl, npr = a.npr;
  const unsigned tile = blockIdx.x / (unsigned)npr;
  const int gx = (int)(blockIdx.x - tile * (unsigned)npr);  // CTA of the tile
  const int rank = gx % ncl;           // its rank in the cluster
  const int n_rt = (L + kRows - 1) / kRows, n0 = n_rt * a.BH;
  int it, c, bh;
  if (n_rt > 4) {                      // past chunk 256: heaviest tiles first
    if ((int)tile < n0) {
      c = 0;
      it = n_rt - 1 - (int)tile / a.BH;
      bh = (int)tile % a.BH;
    } else {
      const int x = (int)tile - n0, per = (NC - 1) * a.BH;
      it = n_rt - 1 - x / per;
      c = 1 + (x % per) % (NC - 1);
      bh = (x % per) / (NC - 1);
    }
  } else if ((int)tile < n0) {         // a chunk's row tiles together
    c = 0;
    it = n_rt - 1 - (int)tile % n_rt;
    bh = (int)tile / n_rt;
  } else {
    const int x = (int)tile - n0, y = x / n_rt;
    it = n_rt - 1 - x % n_rt;
    c = 1 + y % (NC - 1);
    bh = y / (NC - 1);
  }
  const int U = (dh + 7) >> 3;         // 8-column units of dh
  const int ou = U / npr, orem = U % npr;
  const int u_n = ou + (gx < orem);    // this CTA's output unit tiles
  const int e0 = 8 * (gx * ou + min(gx, orem));
  const int su = U / ncl, srem = U % ncl;       // S: this rank's columns
  const int sd0 = 8 * (rank * su + min(rank, srem));
  const int sd1 = min(dh, sd0 + 8 * (su + (rank < srem)));
  const int b = bh / a.H, h = bh % a.H;
  const int i0 = it * kRows, Nv = min(i0 + kRows, L);
  const T* qg = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const float* lig = a.li + b * a.si[0] + h * a.si[1];
  const long long s0 = (long long)c * L;               // the chunk's first row
  const long long w0 = (long long)bh * a.S + s0;       // ... in the workspace
  const long long st = (long long)bh * (NC - 1) + c - 1;  // state (c > 0)
  const float scale = a.scale;
  const bool vec = a.vec;

  if (tid < kRows) {
    const int i = i0 + tid;
    const bool ok = i < L;
    Frow[tid] = ok ? a.F[w0 + i] : 0.f;
    Mrow[tid] = ok ? a.Mi[w0 + i] : 0.f;
    Sfrow[tid] = ok ? a.Sf[w0 + i] : 0.f;
  }
  for (int e = tid; e < kWarpsN3 * kRows; e += kThreads3) denp[e] = 0.f;

  // Jobs, each a stage: nS slices of 64 of q and k over the rank's S
  // columns (per key slice), nC1 slices of 32 of q and C_prev (and n) over
  // all of dh, and the key slice's v rows, VD at a time. Order: key slice 0's S jobs, the q.C
  // jobs, key slice 0's P.V jobs, then each later slice's S and P.V jobs.
  // A job is (kind, ks, x): kind 0 S (key slice ks, d slice x), 1 q.C (d
  // slice x), 2 P.V (key slice ks, its keys VD x ...), 3 none.
  const int nd = (dh + kKs3 - 1) / kKs3;
  const int nC1 = c > 0 ? nd : 0;
  const int nS = (sd1 - sd0 + kSd - 1) / kSd;
  const int n_ks = (Nv + kKeys - 1) / kKeys;
  auto n_v = [&](int ks) {
    return (min(kKeys, Nv - ks * kKeys) + VD - 1) / VD;
  };
  auto next = [&](int& kind, int& ks, int& x) {   // the job after
    if (kind == 0) {
      if (++x < nS) return;
      kind = ks == 0 && nC1 > 0 ? 1 : 2;
    } else if (kind == 1) {
      if (++x < nC1) return;
      kind = 2;
    } else {
      if (++x < n_v(ks)) return;
      kind = ++ks < n_ks ? 0 : 3;
    }
    x = 0;
  };
  const int nch = 2 * u_n;             // 4-float chunks of the CTA's columns
  constexpr int CH = 16 * NT;          // ... at most: the pairs (row, chunk)
                                       // go over every thread
  auto issue = [&](int stage, int kind, int ks, int x) {
    float* X = sm + stage * STAGE;
    if (kind == 0) {                   // q and k [row][d], the rank's columns
      const int j0s = ks * kKeys, nks = min(kKeys, Nv - j0s);
      const int d0 = sd0 + kSd * x;
      for (int e = tid; e < (QO ? 0 : kRows * (kSd / 4)); e += kThreads3) {
        const int r = e / (kSd / 4), c4 = e % (kSd / 4);
        const bool ok = i0 + r < L;
        load4(X + r * kSl4 + 4 * c4, ok ? qg + (s0 + i0 + r) * a.sq[2] : qg,
              d0 + 4 * c4, ok ? sd1 : 0, vec);
      }
      float* Ks = X + kRows * kSl4;
      for (int e = tid; e < ((nks + 7) & ~7) * (kSd / 4); e += kThreads3) {
        const int r = e / (kSd / 4), c4 = e % (kSd / 4);
        const bool ok = r < nks;
        load4(Ks + r * kSl4 + 4 * c4,
              ok ? kg + (s0 + j0s + r) * a.sk[2] : kg, d0 + 4 * c4,
              ok ? sd1 : 0, vec);
      }
    } else if (kind == 1) {            // C_prev [d][e] and n, the CTA's columns
      if (x == 0) grid_wait();         // the states pass is done
      const int d0 = kKs3 * x;
      const float* Cg = a.Cst + st * dh * dhp + e0;
      for (int e = tid; e < kKs3 * CH; e += kThreads3) {
        const int r = e / CH, c4 = e % CH;
        const bool ok = d0 + r < dh;
        if (c4 < nch)
          cp16(X + r * CS + 4 * c4,
               ok ? Cg + (long long)(d0 + r) * dhp + 4 * c4 : Cg, ok);
      }
      if (tid < kKs3)
        cp4(X + kKs3 * CS + tid, a.nst + st * dhp + d0 + tid, true);
    } else if (kind == 2) {            // v [key][e], the CTA's columns
      const int j0 = ks * kKeys + VD * x;
      for (int e = tid; e < VD * CH; e += kThreads3) {
        const int r = e / CH, c4 = e % CH;
        const bool ok = j0 + r < Nv;
        if (c4 < nch)
          load4(X + r * CS + 4 * c4, ok ? vg + (s0 + j0 + r) * a.sv[2] : vg,
                e0 + 4 * c4, ok ? dh : 0, vec);
      }
    }
    cp_commit();
  };
  // This thread's A fragment of a job's q slice (m tile tid / 128, k step
  // (tid / 32) % 4, lane tid % 32: rows fr, fr + 8, columns fc, fc + 4),
  // read into registers a job ahead; it goes to Qh and Ql as one float4
  // each, at float 4 tid.
  const int fr = 16 * (tid >> 7) + g, fc = 8 * ((tid >> 5) & 3) + t4;
  float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
  auto fetch_q = [&](int kind, int x) {
    if (QO || kind != 1) return;
    const int d0 = kKs3 * x;
    const bool r0 = i0 + fr < L, r1 = i0 + fr + 8 < L;
    const bool c0 = d0 + fc < dh, c1 = d0 + fc + 4 < dh;
    const T* p0 = qg + (s0 + i0 + fr) * a.sq[2] + d0 + fc;
    const T* p1 = p0 + 8 * a.sq[2];
    qv = make_float4(r0 && c0 ? to_float(p0[0]) : 0.f,
                     r1 && c0 ? to_float(p1[0]) : 0.f,
                     r0 && c1 ? to_float(p0[4]) : 0.f,
                     r1 && c1 ? to_float(p1[4]) : 0.f);
  };

  // The top of job (kind, ks, x), the job-th: its stage has landed and
  // every warp is done with the job before; a q.C job's q slice goes to Qh
  // and Ql, scaled and split once, and adds its part of q.n; the next job
  // is issued and its q read ahead. Returns the job's stage.
  float qn0 = 0.f, qn1 = 0.f;          // this thread's part of q.n, rows fr, + 8
  auto begin = [&](int job, int kind, int ks, int x) {
    cp_wait<0>();
    __syncthreads();
    const float* X = sm + (job % kStages3) * STAGE;
    if (kind == 1 && QO) {             // q.n from q's hi + lo (exact)
      const int f = ((((tid >> 7) * 8 + 4 * x + ((tid >> 5) & 3)) * 32) + lane)
                    * 4;
      const float4 h = *reinterpret_cast<const float4*>(Qh + f);
      const float4 l = *reinterpret_cast<const float4*>(Ql + f);
      const float e4[4] = {h.x + l.x, h.y + l.y, h.z + l.z, h.w + l.w};
      const float* ns = X + kKs3 * CS;
      qn0 = fmaf(e4[2], ns[fc + 4], fmaf(e4[0], ns[fc], qn0));
      qn1 = fmaf(e4[3], ns[fc + 4], fmaf(e4[1], ns[fc], qn1));
    } else if (kind == 1) {
      const float e4[4] = {qv.x * scale, qv.y * scale, qv.z * scale,
                           qv.w * scale};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(e4[e], hi[e], lo[e]);
      *reinterpret_cast<uint4*>(Qh + 4 * tid) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(Ql + 4 * tid) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
      const float* ns = X + kKs3 * CS;
      qn0 = fmaf(e4[2], ns[fc + 4], fmaf(e4[0], ns[fc], qn0));
      qn1 = fmaf(e4[3], ns[fc + 4], fmaf(e4[1], ns[fc], qn1));
    }
    int nk = kind, nks = ks, nx = x;
    next(nk, nks, nx);
    issue((job + 1) % kStages3, nk, nks, nx);
    fetch_q(nk, nx);
    if (kind == 1 && !QO) __syncthreads();   // q's hi and lo are in place
    return X;
  };

  // ---- key slice ks: this rank's partial S, summed over the cluster; P ----
  // Warp (wm, wn) takes rows 32 wm .. 32 wm + 31 and the slice's keys 16 wn
  // .. 16 wn + 15 (two key tiles); q and k arrive raw, 64 columns a stage,
  // and are split as they are read (one barrier a stage). Each 32 columns'
  // sums start fresh and build up in Ph (this lane's 16 floats), which is
  // free: the slice before read its P there before this slice's first
  // barrier.
  auto s_phase = [&](int ks, int& job) {
    const int j0s = ks * kKeys, nks = min(kKeys, Nv - j0s);
    for (int j = tid; j < kKeys; j += kThreads3) {
      const bool ok = j0s + j < Nv;
      Fk[j] = ok ? a.F[w0 + j0s + j] : 0.f;
      lik[j] = ok ? lig[(s0 + j0s + j) * a.si[2]] : 0.f;
    }
    float* part = Ph + (w * 4 * 32 + lane) * 4;  // (m, n) at + 128 (2 m + n)
    // the warp's last row as a key of the slice: later keys weigh 0
    const int last = i0 + 32 * wm + 31 - j0s;
    for (int x = 0; x < nS; ++x, ++job) {
      const float* Qs = begin(job, 0, ks, x);     // q [row][d], k [key][d]
      const float* Ks = Qs + kRows * kSl4;
#pragma unroll
      for (int hf = 0; hf < kSd / kKs3; ++hf) {
        float ps[2][2][4] = {};        // these 32 columns' sums, added rounded
        if (16 * wn < nks && 16 * wn <= last) {
#pragma unroll
          for (int kk = 0; kk < kKs3 / 8; ++kk) {
            const int col = kKs3 * hf + 8 * kk;
            uint32_t ah[2][4], al[2][4], bh_[2][2], bl[2][2];
            if constexpr (QO) {        // k step col / 8 of all 64 columns
#pragma unroll
              for (int m = 0; m < 2; ++m)
                a_load(Qh, Ql, (((2 * wm + m) * 8 + col / 8) * 32 + lane) * 4,
                       ah[m], al[m]);
            } else {
              a_frags(Qs, kSl4, 32 * wm + g, col, t4, scale, ah, al);
            }
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              const float* p = Ks + (16 * wn + 8 * n + g) * kSl4 + col + t4;
              split(p[0], bh_[n][0], bl[n][0]);
              split(p[4], bh_[n][1], bl[n][1]);
            }
#pragma unroll
            for (int n = 0; n < 2; ++n)
              if (16 * wn + 8 * n < nks && 16 * wn + 8 * n <= last)
                mma3(ps[0][n], ps[1][n], ah, al, bh_[n], bl[n]);
          }
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            float4* q4 = reinterpret_cast<float4*>(part + (2 * m + n) * 128);
            float4 v = x == 0 && hf == 0 ? make_float4(0.f, 0.f, 0.f, 0.f)
                                         : *q4;
            v.x += ps[m][n][0];
            v.y += ps[m][n][1];
            v.z += ps[m][n][2];
            v.w += ps[m][n][3];
            *q4 = v;
          }
      }
    }
    if (ncl > 1) {
      cluster_arrive();
      cluster_wait();                  // every rank's partial is written
    }
    float S[2][2][4] = {};
    const uint32_t src = smem_u32(part);
    for (int r = 0; r < ncl; ++r) {    // in rank order, in every CTA
      const uint32_t at = mapa(src, (uint32_t)r);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float4 v = ld_cluster4(at + (2 * m + n) * 128 * 4);
          S[m][n][0] += v.x;
          S[m][n][1] += v.y;
          S[m][n][2] += v.z;
          S[m][n][3] += v.w;
        }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int il = 32 * wm + 16 * m + g + 8 * hh, i = i0 + il;
        float rs = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int jl = 16 * wn + 8 * n + 2 * t4 + e;
            const float pv =
                (j0s + jl <= i && i < L)
                    ? expf(((Frow[il] - Fk[jl]) + lik[jl]) - Mrow[il]) *
                          S[m][n][2 * hh + e]
                    : 0.f;
            S[m][n][2 * hh + e] = pv;
            rs += pv;
          }
        rs += __shfl_xor_sync(kFull, rs, 1);
        rs += __shfl_xor_sync(kFull, rs, 2);
        if (t4 == 0) denp[wn * kRows + il] += rs;
      }
    if (ncl > 1) {
      cluster_arrive();
      cluster_wait();                  // no peer reads this CTA's partial now
    } else {
      __syncthreads();                 // no warp reads its partial now
    }
    // P to fragment order: lane (g, t4) holds keys 2 t4, 2 t4 + 1 of rows
    // g and g + 8; its A fragment wants keys t4 and t4 + 4, which lanes
    // (g, t4 / 2) and (g, t4 / 2 + 2) hold. Four shuffles of each parity,
    // then one float4 of hi and one of lo.
    const int src0 = (g << 2) | (t4 >> 1), src1 = src0 + 2, odd = t4 & 1;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float f[4];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float e0 = __shfl_sync(kFull, S[m][n][2 * hh], src0);
          const float e1 = __shfl_sync(kFull, S[m][n][2 * hh + 1], src0);
          const float e2 = __shfl_sync(kFull, S[m][n][2 * hh], src1);
          const float e3 = __shfl_sync(kFull, S[m][n][2 * hh + 1], src1);
          f[hh] = odd ? e1 : e0;       // key t4, row g + 8 hh
          f[hh + 2] = odd ? e3 : e2;   // key t4 + 4
        }
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) split(f[r], hi[r], lo[r]);
        const int idx =
            (((2 * wm + m) * (kKeys / 8) + 2 * wn + n) * 32 + lane) * 4;
        *reinterpret_cast<uint4*>(Ph + idx) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(Pl + idx) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
  };

  issue(0, 0, 0, 0);
  if constexpr (QO) {                  // q scaled and split once (dh <= 64):
    for (int f = tid; f < 4 * 8 * 32; f += kThreads3) {  // m tile, k step, lane
      const int r = 16 * (f >> 8) + ((f & 31) >> 2);
      const int d = 8 * ((f >> 5) & 7) + (f & 3);
      const T* p0 = qg + (s0 + i0 + r) * a.sq[2];
      const T* p1 = p0 + 8 * a.sq[2];
      const bool r0 = i0 + r < L, r1 = i0 + r + 8 < L;
      const bool c0 = d < dh, c1 = d + 4 < dh;
      const float e4[4] = {r0 && c0 ? to_float(p0[d]) * scale : 0.f,
                           r1 && c0 ? to_float(p1[d]) * scale : 0.f,
                           r0 && c1 ? to_float(p0[d + 4]) * scale : 0.f,
                           r1 && c1 ? to_float(p1[d + 4]) * scale : 0.f};
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(e4[e], hi[e], lo[e]);
      *reinterpret_cast<uint4*>(Qh + 4 * f) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(Ql + 4 * f) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }                                  // (the first job's barrier orders it)
  }
  int job = 0;
  s_phase(0, job);
  // ---- O = q.C_prev over the CTA's columns, scaled by e^(F_i + m - m_i) ----
  float o[2][NT][4] = {};              // this warp's output tiles
  // one 32-wide slice of d; where a warp holds kFreshNt n tiles or fewer
  // (every CTA past dh kFreshDh) in fresh accumulators, added rounded, so
  // that the sum over dh does not drift with the accumulators' truncation
  auto qc_products = [&](const float* X, int x) {
    if constexpr (NT <= kFreshNt) {
      float f[2][NT][4] = {};
      cluster_products<kKs3>(f, Qh, Ql, QO ? 8 : kKs3 / 8, QO ? 4 * x : 0, X,
                             CS, wm, wn, lane, u_n, kKs3 / 8);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[m][n][e] += f[m][n][e];
    } else {
      cluster_products<kKs3>(o, Qh, Ql, kKs3 / 8, 0, X, CS, wm, wn, lane,
                             u_n, kKs3 / 8);
    }
  };
  for (int x = 0; x < nC1; ++x, ++job) qc_products(begin(job, 1, 0, x), x);
  if (nC1) {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float sf = Sfrow[32 * wm + 16 * m + g + 8 * hh];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[m][n][2 * hh] *= sf;
          o[m][n][2 * hh + 1] *= sf;
        }
      }
  }
  // ---- O += P.V, key slice by key slice ------------------------------------
  // Keys past the warp's last row, or past the chunk, weigh 0: their k
  // steps are left out (kn).
  const int seen = min(Nv, i0 + 32 * wm + 32);   // the keys the warp sees
  for (int ks = 0; ks < n_ks; ++ks) {
    if (ks > 0) s_phase(ks, job);
    for (int x = 0; x < n_v(ks); ++x, ++job) {
      const int kn = min(VD / 8, (seen - ks * kKeys - VD * x + 7) >> 3);
      cluster_products<VD>(o, Ph, Pl, kKeys / 8, x * (VD / 8),
                           begin(job, 2, ks, x), CS, wm, wn, lane, u_n, kn);
    }
  }

  // ---- h = O / max(|den|, e^-m_i) ------------------------------------------
  qn0 += __shfl_xor_sync(kFull, qn0, 1);
  qn0 += __shfl_xor_sync(kFull, qn0, 2);
  qn1 += __shfl_xor_sync(kFull, qn1, 1);
  qn1 += __shfl_xor_sync(kFull, qn1, 2);
  if (t4 == 0) {                       // k step (tid / 32) % 4's part of q.n
    qn_s[((tid >> 5) & 3) * kRows + fr] = qn0;
    qn_s[((tid >> 5) & 3) * kRows + fr + 8] = qn1;
  }
  __syncthreads();                     // denp and qn_s from every warp
  if (tid < kRows) {
    float den = 0.f;
    for (int x = 0; x < kWarpsN3; ++x) den += denp[x * kRows + tid];
    const float qn = ((qn_s[tid] + qn_s[kRows + tid]) + qn_s[2 * kRows + tid])
                     + qn_s[3 * kRows + tid];
    den += qn * Sfrow[tid];
    den_s[tid] = fmaxf(fabsf(den), expf(-Mrow[tid]));
  }
  __syncthreads();
  T* og = static_cast<T*>(a.o) + ((long long)bh * a.S + s0) * dh + e0;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int il = 32 * wm + 16 * m + g + 8 * hh, i = i0 + il;
      if (i >= L) continue;
      const float lim = den_s[il];
      T* orow = og + (long long)i * dh;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int nt = wn + kWarpsN3 * n, e = 8 * nt + 2 * t4;
        if (nt >= u_n) continue;
        if (e0 + e < dh) store(orow + e, o[m][n][2 * hh] / lim);
        if (e0 + e + 1 < dh) store(orow + e + 1, o[m][n][2 * hh + 1] / lim);
      }
    }
}

// ---- host side --------------------------------------------------------------

int outputs_smem_bytes(int dhp, int lp) {
  const int sk = kRows * kSl3 + lp * kSl3;
  const int sc = kRows * kSl3 + kKs3 * (dhp + 8) + kKs3;
  const int stage = sk > sc ? sk : sc;
  return 4 * (kStages3 * stage + kRows * (lp + 4) + 3 * kRows + 2 * lp +
              kWarpsN3 * kRows + kRows);
}

int states_smem_bytes(int bn) {
  return 4 * kStages2 * (kKs * (kDT + 8) + kKs * (bn + 8) + kKs);
}

// after_previous: a programmatic dependent launch on the kernel before it
template <typename K>
cudaError_t launch(K kernel, unsigned blocks, int threads, int smem,
                   cudaStream_t s, const Args& a, int extra,
                   bool after_previous) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = after_previous ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, a, extra);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The tiling of a shape (ops.plan): `nt` the outputs pass's n tiles per
// warp (the in-limit block holds 64 nt columns, a cluster CTA at most 64
// nt), `dhp` the states' row stride, `bn` the states block's columns, `lp`
// the keys of a P tile, `sliced` whether the outputs pass is the cluster one
// (chunk > kMaxChunk or dh > kMaxDh), and there `ncl` the CTAs a cluster
// and `npr` the CTAs a row tile (ncl, or groups of kMaxCluster).
struct Plan {
  int nt, dhp, bn, lp, ncl, npr;
  bool sliced;
};

Plan make_plan(int dh, int chunk) {
  Plan p;
  p.sliced = dh > kMaxDh || chunk > kMaxChunk;
  const int tiles[] = {8, 6, 4, 2, 1};
  int least = 8;                       // the least n tiles with 64 nt >= dh
  for (int n : tiles)
    if (64 * n >= dh) least = n;
  p.dhp = dh > kMaxDh ? (dh + 127) / 128 * 128 : 64 * least;
  p.bn = p.dhp == 384 ? 96 : p.dhp >= 256 ? 128 : 64;
  p.ncl = p.npr = 1;
  p.nt = least;
  p.lp = (chunk + 63) / 64 * 64 < kMaxChunk ? (chunk + 63) / 64 * 64
                                            : kMaxChunk;
  if (p.sliced) {
    const int most = dh > kFreshDh ? 64 * kFreshNt : kMaxDh;  // columns
    const int ctas = (dh + most - 1) / most;
    p.ncl = ctas < kMaxCluster ? ctas : kMaxCluster;
    p.npr = (ctas + p.ncl - 1) / p.ncl * p.ncl;
    const int units = (dh + 7) / 8, share = (units + p.npr - 1) / p.npr;
    const int tiles8 = (share + kWarpsN3 - 1) / kWarpsN3;  // a column warp's
    p.nt = tiles8 == 1 ? 1 : (tiles8 + 1) / 2 * 2;   // 1 (dh <= 64), 2 .. 8
    p.lp = kKeys;
  }
  return p;
}

int cluster_smem_bytes(int nt) { return 4 * cluster_floats(nt); }

// The cluster outputs pass's kernel for n tiles per warp `nt`.
template <typename T>
void (*cluster_kernel(int nt))(Args) {
  return nt == 1 ? outputs_cluster_kernel<T, 1>
         : nt == 2 ? outputs_cluster_kernel<T, 2>
         : nt == 4 ? outputs_cluster_kernel<T, 4>
         : nt == 6 ? outputs_cluster_kernel<T, 6>
                   : outputs_cluster_kernel<T, 8>;
}

// A launch of the cluster outputs pass over `blocks` CTAs in clusters of
// ncl along x, a programmatic dependent launch where after_previous; with
// max_active, no launch: the most such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters).
template <typename T>
cudaError_t launch_cluster(const Args& a, int nt, unsigned blocks,
                           cudaStream_t s, bool after_previous,
                           int* max_active = nullptr) {
  void (*kernel)(Args) = cluster_kernel<T>(nt);
  const int smem = cluster_smem_bytes(nt);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.ncl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads3);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = after_previous ? 2 : 1;
  if (max_active)
    return cudaOccupancyMaxActiveClusters(max_active, kernel, &cfg);
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T>
cudaError_t run(const Args& a, const Plan& pl, int smem2, int smem3,
                int passes, cudaStream_t s) {
  const int dhp = pl.dhp, bn = pl.bn, nt = pl.nt, lp = pl.lp;
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    if (a.L > kMaxChunk)
      chunk_long_kernel<<<(unsigned)a.NC * a.BH, kThreads1, 0, s>>>(a);
    else
      chunk_kernel<<<(unsigned)a.NC * a.BH, kThreads1, 0, s>>>(a);
    carry_kernel<<<a.BH, kThreads1, 0, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const bool states = (passes & 2) && a.NC > 1;
  if (states) {
    const unsigned blocks = (unsigned)(dhp / kDT) * (dhp / bn) * a.BH;
    auto k = bn == 128 ? states_kernel<T, 128>
             : bn == 96 ? states_kernel<T, 96> : states_kernel<T, 64>;
    err = launch(k, blocks, kThreads2, smem2, s, a, dhp, false);
    if (err != cudaSuccess) return err;
  }
  if ((passes & 4) && pl.sliced) {
    const unsigned blocks =
        (unsigned)((a.L + kRows - 1) / kRows) * a.NC * a.BH * pl.npr;
    err = launch_cluster<T>(a, nt, blocks, s, states);
  } else if (passes & 4) {
    const unsigned blocks =
        (unsigned)((a.L + kRows - 1) / kRows) * a.NC * a.BH;
    auto k = nt == 1 ? outputs_kernel<T, 1>
             : nt == 2 ? outputs_kernel<T, 2>
             : nt == 4 ? outputs_kernel<T, 4>
             : nt == 6 ? outputs_kernel<T, 6> : outputs_kernel<T, 8>;
    err = launch(k, blocks, kThreads3, smem3, s, a, lp, states);
  }
  return err;
}

bool aligned(const void* p, long long n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

// C entry for ctypes. strides: 15 int64, the (batch, head, seq) strides in
// elements of q, k, v, lf and li, in that order (the last dimension of q, k
// and v is contiguous); out is a contiguous (B, H, S, dh) tensor. lf and li
// are float32; dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and
// out). The float32 workspace: scal (4, B*H, S), chunks (3, B*H, S/chunk +
// 1), and where S/chunk > 1 nst (B*H, S/chunk - 1, dhp) and cst (B*H,
// S/chunk - 1, dh, dhp). The plan (make_plan: nt, the outputs pass's n tiles
// per warp; bn, the states block's columns; smem2, smem3: the dynamic shared
// memory of passes 2 and 3) comes from ops.plan and is checked here. passes:
// a mask of the passes to run (1 scalars, 2 states, 4 outputs; 7 for the
// function). scale is dh^-1/2. Launches on `stream` of `device` and returns
// the CUDA error (0 when every launch was accepted); shapes and plans it
// does not take return cudaErrorInvalidValue without launching. Past chunk
// 256 or dh 512 (make_plan's `sliced`) the outputs pass runs in clusters;
// any chunk that divides S and any dh, up to 2^31 - 1 blocks a pass.
extern "C" int mlstm_scan_sm90_launch(
    const void* q, const void* k, const void* v, const void* lf,
    const void* li, void* out, const long long* strides, float* scal,
    float* chunks, float* nst, float* cst, int B, int H, int S, int dh,
    int chunk, int nt, int bn, int smem2, int smem3, float scale, int dtype,
    int passes, int device, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || dh <= 0 || chunk <= 0 ||
      S % chunk != 0 || dtype < 0 || dtype > 2 ||
      (long long)B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(dh, chunk);
  const long long dt = pl.dhp / kDT, bh = (long long)B * H;
  if (nt != pl.nt || bn != pl.bn || smem2 != states_smem_bytes(bn) ||
      smem3 != (pl.sliced ? cluster_smem_bytes(pl.nt)
                          : outputs_smem_bytes(64 * pl.nt, pl.lp)) ||
      smem3 > 232448 ||
      (long long)((chunk + 63) / 64) * (S / chunk) * bh * pl.npr >
          0x7fffffffLL ||
      dt * (pl.dhp / pl.bn) * bh > 0x7fffffffLL ||
      (long long)(S / chunk) * bh > 0x7fffffffLL ||
      (S / chunk > 1 && (nst == nullptr || cst == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lf = static_cast<const float*>(lf);
  a.li = static_cast<const float*>(li);
  a.o = out;
  bool vec = true;
  const long long elt = dtype == 0 ? 4 : 2;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.sf[i] = strides[9 + i];
    a.si[i] = strides[12 + i];
    vec = vec && a.sq[i] % 4 == 0 && a.sk[i] % 4 == 0 && a.sv[i] % 4 == 0;
  }
  vec = vec && aligned(q, 4 * elt) && aligned(k, 4 * elt) &&
        aligned(v, 4 * elt);
  a.BH = B * H;
  a.H = H;
  a.S = S;
  a.dh = dh;
  a.L = chunk;
  a.NC = S / chunk;
  a.dhp = pl.dhp;
  a.ncl = pl.ncl;
  a.npr = pl.npr;
  a.vec = vec;
  a.scale = scale;
  const long long n = (long long)B * H * S;
  a.F = scal;
  a.Mi = scal + n;
  a.Sf = scal + 2 * n;
  a.wL = scal + 3 * n;
  const long long nq = (long long)B * H * (S / chunk + 1);
  a.FL = chunks;
  a.G = chunks + nq;
  a.M = chunks + 2 * nq;
  a.nst = nst;
  a.Cst = cst;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = run<float>(a, pl, smem2, smem3, passes, s);
  else if (dtype == 1)
    err = run<__nv_bfloat16>(a, pl, smem2, smem3, passes, s);
  else
    err = run<__half>(a, pl, smem2, smem3, passes, s);
  return (int)err;
}

// The cluster outputs pass at (dh, chunk) past one block's reach, float32
// instance, on `device`: the CTAs a cluster, the CTAs a row tile, the n
// tiles per warp, and the most such clusters the card holds at once
// (cudaOccupancyMaxActiveClusters). Returns the CUDA error.
extern "C" int mlstm_scan_sm90_clusters(int dh, int chunk, int device,
                                        int* cluster, int* ctas, int* nt,
                                        int* max_active) {
  const Plan pl = make_plan(dh, chunk);
  if (dh <= 0 || chunk <= 0 || !pl.sliced) return (int)cudaErrorInvalidValue;
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  *cluster = pl.ncl;
  *ctas = pl.npr;
  *nt = pl.nt;
  Args a = {};
  a.ncl = pl.ncl;
  return (int)launch_cluster<float>(a, pl.nt, (unsigned)pl.ncl, 0, false,
                                    max_active);
}
