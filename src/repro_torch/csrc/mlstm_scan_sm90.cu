// Chunkwise-parallel stabilized mLSTM forward for Hopper (sm_90a) in the
// chunk-state form: three passes, float32 or bfloat16 q/k/v, float32 gates,
// every product on the tensor cores as 3xTF32 with float32 accumulation.
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
// Passes 2 and 3 stream their operands through shared memory in slices of
// 32 along the contraction with cp.async (3 and 2 stages); bfloat16 inputs
// are widened to float32 on the way in, so the tiles are float32 throughout.
// Keys above the diagonal are skipped or get weight 0: the TPU kernel's
// masked weight e^(-1e30 - m_i) is exactly 0 in float32.
//
// Accuracy. mma.sync adds into its float32 accumulator with truncation, so
// three products per k-step into one accumulator over K = dh drift further
// from float64 than the plain float32 scan; q.k^T, where that drift mattered
// most, sums each 32-wide slice in fresh accumulators and adds the slice
// rounded to nearest.
//
// What sets the pace is not the tensor cores: a build that kept one product
// in three kept most of the time, and deeper pipelines did not help. It is
// the operand traffic from L2 into shared memory and the latency of the
// fragment loads and splits between barriers, which the outputs pass hides
// with 16 warps (a 256-thread block, free of spills, was slower).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxChunk = 256;
constexpr int kMaxDh = 512;
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

template <typename T>
__device__ __forceinline__ void store(T* p, float x);
template <>
__device__ __forceinline__ void store<float>(float* p, float x) { *p = x; }
template <>
__device__ __forceinline__ void store<__nv_bfloat16>(__nv_bfloat16* p,
                                                     float x) {
  *p = __float2bfloat16(x);
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

template <typename T>
cudaError_t run(const Args& a, int nt, int bn, int smem2, int smem3,
                int passes, cudaStream_t s) {
  const int dhp = 64 * nt, lp = (a.L + 63) / 64 * 64;
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
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
  if (passes & 4) {
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
// are float32; dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). The
// float32 workspace: scal (4, B*H, S), chunks (3, B*H, S/chunk + 1), and where
// S/chunk > 1 nst (B*H, S/chunk - 1, 64 nt) and cst (B*H, S/chunk - 1, dh,
// 64 nt). The plan (nt: output n tiles per warp, the least of 1, 2, 4, 6, 8
// with 64 nt >= dh; bn: state columns per block, 128 where 64 nt is a
// multiple of 128 from 256 up, else 64; smem2, smem3: the dynamic shared
// memory of passes 2 and 3) comes from ops.plan and is checked here. passes:
// a mask of the passes to run (1 scalars, 2 states, 4 outputs; 7 for the
// function). scale is dh^-1/2. Launches on `stream` of `device` and returns
// the CUDA error (0 when every launch was accepted); shapes and plans it
// does not take return cudaErrorInvalidValue without launching.
extern "C" int mlstm_scan_sm90_launch(
    const void* q, const void* k, const void* v, const void* lf,
    const void* li, void* out, const long long* strides, float* scal,
    float* chunks, float* nst, float* cst, int B, int H, int S, int dh,
    int chunk, int nt, int bn, int smem2, int smem3, float scale, int dtype,
    int passes, int device, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || dh <= 0 || dh > kMaxDh || chunk <= 0 ||
      chunk > kMaxChunk || S % chunk != 0 || (dtype != 0 && dtype != 1) ||
      (long long)B * H > 0x7fffffffLL ||
      (long long)((chunk + 63) / 64) * (S / chunk) * B * H > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int tiles[] = {8, 6, 4, 2, 1};
  int want_nt = 8;
  for (int n : tiles)
    if (64 * n >= dh) want_nt = n;
  const int dhp = 64 * want_nt, lp = (chunk + 63) / 64 * 64;
  const int want_bn = dhp == 384 ? 96 : dhp >= 256 ? 128 : 64;
  if (nt != want_nt || bn != want_bn || smem2 != states_smem_bytes(bn) ||
      smem3 != outputs_smem_bytes(dhp, lp) || smem3 > 232448 ||
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
  err = dtype == 0 ? run<float>(a, nt, bn, smem2, smem3, passes, s)
                   : run<__nv_bfloat16>(a, nt, bn, smem2, smem3, passes, s);
  return (int)err;
}
