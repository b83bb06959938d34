// Chunkwise-parallel stabilized mLSTM forward for Hopper (sm_90a), float32 or
// bfloat16 q/k/v, float32 gates and arithmetic.
//
// Replaces src/repro/kernels/mlstm_scan/kernel.py::mlstm_scan (the Pallas TPU
// kernel, body `_kernel`). From a zero state (C = 0, n = 0, m = -40) it walks
// the chunks of length L of every (batch, head) in order:
//
//   q, k, v (B, H, S, dh)    lf, li (B, H, S)    out (B, H, S, dh)
//
// q, k, v, lf and li are given by (batch, head, seq) strides in elements, the
// last dimension of q, k and v contiguous; out is contiguous, in q's dtype.
//
// Arithmetic of the TPU kernel, kept step for step: q is scaled by dh^-1/2
// and used in both the intra-chunk and the state term; F = cumsum(lf); the
// log weight of key j at row i is (F_i - F_j) + li_j for j <= i; the row
// stabilizer is m_i = max(max_j<=i of it, F_i + m, -40); the row's output is
//   (sum_j e^(D_ij - m_i) (q_i.k_j) v_j + e^(F_i + m - m_i) q_i C)
//     / max(|sum_j e^(D_ij - m_i) (q_i.k_j) + e^(F_i + m - m_i) q_i.n|, e^-m_i)
// and the chunk then folds into the state with m_new = max(F_L + m,
// max_j (F_L - F_j) + li_j, -40), wL_j = e^((F_L - F_j) + li_j - m_new),
// C = e^(F_L + m - m_new) C + sum_j (k_j wL_j) v_j^T, n likewise. Keys above
// the diagonal are skipped: the TPU kernel's masked weight e^(-1e30 - m_i)
// is exactly 0 in float32.
//
// Design. The TPU grid is (B*H, chunks) with the chunk axis sequential and
// C (dh x dh), n, m in VMEM scratch. At xLSTM-125m's dh = 384 the float32 C
// is 576 KiB, more than one SM's shared memory, so C is split by value
// columns: one block per (b*H + h, 64-column tile), with the chunk loop
// inside the block and C[:, tile] (dh x 64 floats, 96 KiB at dh = 384)
// carried in shared memory. The column tiles of C and of the output are
// independent and the normaliser needs only n, so every block keeps its own
// copy of n and m. Within a chunk, 64-row tiles of queries meet 64-key tiles
// at or below the diagonal; q.k^T streams the head dimension in 32-wide
// slices through shared memory, and the first key tile's slices also feed
// q.C and q.n. 256 threads form a 16 x 16 grid and compute 4 x 4 outputs as
// float4 outer products. Every column block recomputes q.k^T, the weights
// and the denominator (6 times at dh = 384): that redundancy, the float32
// CUDA-core products and one block per SM are what a redesign (wgmma, TMA,
// a two-pass chunk-state form) removes.
//
// Bound: at the model's layer shape the work is operations (4 dh per visible
// (i, j) pair plus 4 dh^2 per row for q.C and the state update), far above
// the bytes of q, k, v and out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;       // a 16 x 16 thread grid
constexpr int kT = 64;              // query rows, keys and value columns per tile
constexpr int kDs = 32;             // head-dim slice streamed through shared memory
constexpr int kLd = kT + 4;         // row stride of 64-wide tiles (16-B aligned)
constexpr int kMaxChunk = kThreads; // one thread per row for the scalars
constexpr int kMaxDh = 512;         // C tile 128 KiB: the shared-memory limit
constexpr float kNeg = -1e30f;
constexpr float kMMin = -40.0f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* lf;
  const float* li;
  void* o;
  long long sq[3], sk[3], sv[3], sf[3], si[3];  // (batch, head, seq) strides
  int H, S, dh, L;
  int dh32, dh64;   // dh rounded up to a slice (32) and to a tile (64)
  float scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[x][y] += a[x] * b[y]
__device__ __forceinline__ void fma4x4(float (&acc)[4][4], const float4 a,
                                       const float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    mlstm_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                    // [dh64][kT]  C[:, c0:c0+64], carried
  float* ns = Cs + a.dh64 * kT;        // [dh64]      n, carried
  float* Fs = ns + a.dh64;             // [L]  cumsum of lf in the chunk
  float* lis = Fs + kMaxChunk;         // [L]  li
  float* Ms = lis + kMaxChunk;         // [L]  row stabilizers m_i
  float* wLs = Ms + kMaxChunk;         // [L]  end-of-chunk weights wL_j
  float* Qt = wLs + kMaxChunk;         // [kDs][kLd]  q slice, transposed
  float* Kt = Qt + kDs * kLd;          // [kDs][kLd]  k slice, transposed
  float* Pt = Kt + kDs * kLd;          // [kT][kLd]   P transposed; k * wL
  float* Vs = Pt + kT * kLd;           // [kT][kLd]   v tile
  __shared__ float s_mnew;

  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H;
  const int c0 = blockIdx.y * kT;      // this block's first value column
  const int L = a.L, dh = a.dh;
  const T* qg = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* kg = static_cast<const T*>(a.k) + b * a.sk[0] + h * a.sk[1];
  const T* vg = static_cast<const T*>(a.v) + b * a.sv[0] + h * a.sv[1];
  const float* lfg = a.lf + b * a.sf[0] + h * a.sf[1];
  const float* lig = a.li + b * a.si[0] + h * a.si[1];
  T* og = static_cast<T*>(a.o) + (long long)bh * a.S * dh;

  for (int e = t; e < a.dh64 * kT; e += kThreads) Cs[e] = 0.f;
  for (int e = t; e < a.dh64; e += kThreads) ns[e] = 0.f;
  float m = kMMin;                     // carried stabilizer, the same in all threads

  for (int s0 = 0; s0 < a.S; s0 += L) {
    // ---- the chunk's scalars: F, m_i, m_new, wL -------------------------
    __syncthreads();
    if (t < L) {
      Fs[t] = lfg[(long long)(s0 + t) * a.sf[2]];
      lis[t] = lig[(long long)(s0 + t) * a.si[2]];
    }
    __syncthreads();
    if (t == 0) {
      float acc = 0.f;
      for (int j = 0; j < L; ++j) {
        acc += Fs[j];
        Fs[j] = acc;
      }
      float mx = -INFINITY;
      for (int j = 0; j < L; ++j) mx = fmaxf(mx, (acc - Fs[j]) + lis[j]);
      s_mnew = fmaxf(fmaxf(acc + m, mx), kMMin);
    }
    __syncthreads();
    const float FL = Fs[L - 1];
    const float m_new = s_mnew;
    if (t < L) {
      const float Fi = Fs[t];
      float mx = kNeg;
      for (int j = 0; j <= t; ++j) mx = fmaxf(mx, (Fi - Fs[j]) + lis[j]);
      Ms[t] = fmaxf(fmaxf(mx, Fi + m), kMMin);
      wLs[t] = expf(((FL - Fi) + lis[t]) - m_new);
    }

    // ---- the chunk's output, 64 query rows at a time -------------------
    for (int i0 = 0; i0 < L; i0 += kT) {
      float acc[4][4] = {}, sq[4][4] = {}, dsum[4] = {}, qn[4] = {};
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        float sc[4][4] = {};
        for (int d0 = 0; d0 < a.dh32; d0 += kDs) {
          __syncthreads();
          for (int e = t; e < kT * kDs; e += kThreads) {
            const int row = e / kDs, dd = e % kDs, d = d0 + dd;
            const int qi = i0 + row, kj = j0 + row;
            float qv = 0.f, kv = 0.f;
            if (d < dh && qi < L)
              qv = ld(qg + (long long)(s0 + qi) * a.sq[2] + d) * a.scale;
            if (d < dh && kj < L)
              kv = ld(kg + (long long)(s0 + kj) * a.sk[2] + d);
            Qt[dd * kLd + row] = qv;
            Kt[dd * kLd + row] = kv;
          }
          __syncthreads();
#pragma unroll 8
          for (int dd = 0; dd < kDs; ++dd)
            fma4x4(sc, ld4(Qt + dd * kLd + 4 * ty), ld4(Kt + dd * kLd + 4 * tx));
          if (j0 == 0) {               // q.C and q.n reuse this q slice
#pragma unroll 8
            for (int dd = 0; dd < kDs; ++dd)
              fma4x4(sq, ld4(Qt + dd * kLd + 4 * ty),
                     ld4(Cs + (d0 + dd) * kT + 4 * tx));
            for (int dd = tx; dd < kDs; dd += 16) {
              const float4 qa = ld4(Qt + dd * kLd + 4 * ty);
              const float nv = ns[d0 + dd];
              qn[0] = fmaf(qa.x, nv, qn[0]);
              qn[1] = fmaf(qa.y, nv, qn[1]);
              qn[2] = fmaf(qa.z, nv, qn[2]);
              qn[3] = fmaf(qa.w, nv, qn[3]);
            }
          }
        }
        // P = w * (q.k), w = e^((F_i - F_j) + li_j - m_i) for j <= i, else 0
        float p[4][4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int i = i0 + 4 * ty + x;
          const bool row_ok = i < L;
          const float Fi = row_ok ? Fs[i] : 0.f, mi = row_ok ? Ms[i] : 0.f;
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const int j = j0 + 4 * tx + y;
            p[x][y] = (row_ok && j <= i)
                          ? expf(((Fi - Fs[j]) + lis[j]) - mi) * sc[x][y]
                          : 0.f;
            dsum[x] += p[x][y];
          }
        }
#pragma unroll
        for (int y = 0; y < 4; ++y)
          *reinterpret_cast<float4*>(Pt + (4 * tx + y) * kLd + 4 * ty) =
              make_float4(p[0][y], p[1][y], p[2][y], p[3][y]);
        for (int e = t; e < kT * kT; e += kThreads) {
          const int jj = e / kT, cc = e % kT, j = j0 + jj, col = c0 + cc;
          Vs[jj * kLd + cc] =
              (j < L && col < dh) ? ld(vg + (long long)(s0 + j) * a.sv[2] + col)
                                  : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int jj = 0; jj < kT; ++jj)
          fma4x4(acc, ld4(Pt + jj * kLd + 4 * ty), ld4(Vs + jj * kLd + 4 * tx));
      }
      // row sums of P and q.n: across the 16 lanes that share rows 4ty..
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int off = 8; off; off >>= 1) {
          dsum[x] += __shfl_xor_sync(0xffffffffu, dsum[x], off);
          qn[x] += __shfl_xor_sync(0xffffffffu, qn[x], off);
        }
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int i = i0 + 4 * ty + x;
        if (i >= L) continue;
        const float mi = Ms[i];
        const float sfac = expf((Fs[i] + m) - mi);
        const float den = dsum[x] + qn[x] * sfac;
        const float lim = fmaxf(fabsf(den), expf(-mi));
        T* orow = og + (long long)(s0 + i) * dh;
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const int col = c0 + 4 * tx + y;
          if (col < dh) st(orow + col, (acc[x][y] + sq[x][y] * sfac) / lim);
        }
      }
    }

    // ---- fold the chunk into C[:, tile] and n, 64 rows of C at a time ---
    const float decay = expf((FL + m) - m_new);
    for (int d0 = 0; d0 < a.dh64; d0 += kT) {
      float cs[4][4] = {};
      float npart = 0.f;
      for (int j0 = 0; j0 < L; j0 += kT) {
        __syncthreads();
        for (int e = t; e < kT * kT; e += kThreads) {
          const int jj = e / kT, cc = e % kT, j = j0 + jj;
          const int d = d0 + cc, col = c0 + cc;
          const long long row = (long long)(s0 + j);
          Pt[jj * kLd + cc] =
              (j < L && d < dh) ? ld(kg + row * a.sk[2] + d) * wLs[j] : 0.f;
          Vs[jj * kLd + cc] =
              (j < L && col < dh) ? ld(vg + row * a.sv[2] + col) : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int jj = 0; jj < kT; ++jj)
          fma4x4(cs, ld4(Pt + jj * kLd + 4 * ty), ld4(Vs + jj * kLd + 4 * tx));
        if (t < kT)
          for (int jj = 0; jj < kT; ++jj) npart += Pt[jj * kLd + t];
      }
      // each thread rewrites only its own C entries; n by the first 64
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          float* c = Cs + (d0 + 4 * ty + x) * kT + 4 * tx + y;
          *c = decay * *c + cs[x][y];
        }
      if (t < kT) ns[d0 + t] = decay * ns[d0 + t] + npart;
    }
    m = m_new;
  }
}

template <typename T>
cudaError_t launch(const Args& a, dim3 grid, size_t bytes,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  mlstm_scan_kernel<T><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// C entry for ctypes. strides: 15 int64, the (batch, head, seq) strides in
// elements of q, k, v, lf and li, in that order (the last dimension of q, k
// and v is contiguous); out is a contiguous (B, H, S, dh) tensor. lf and li
// are float32; dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). scale is
// dh^-1/2. Launches on `stream` of `device` and returns the CUDA error (0
// when the launch was accepted); shapes it does not take (dh > 512,
// chunk > 256, S % chunk != 0) return cudaErrorInvalidValue without
// launching.
extern "C" int mlstm_scan_launch(const void* q, const void* k, const void* v,
                                 const void* lf, const void* li, void* out,
                                 const long long* strides, int B, int H,
                                 int S, int dh, int chunk, float scale,
                                 int dtype, int device, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || dh <= 0 || dh > kMaxDh || chunk <= 0 ||
      chunk > kMaxChunk || S % chunk != 0 ||
      (long long)B * H > 0x7fffffffLL || (dtype != 0 && dtype != 1))
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
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.sf[i] = strides[9 + i];
    a.si[i] = strides[12 + i];
  }
  a.H = H;
  a.S = S;
  a.dh = dh;
  a.L = chunk;
  a.dh32 = (dh + kDs - 1) / kDs * kDs;
  a.dh64 = (dh + kT - 1) / kT * kT;
  a.scale = scale;
  const size_t bytes =
      sizeof(float) * ((size_t)a.dh64 * kT + a.dh64 + 4 * kMaxChunk +
                       2 * kDs * kLd + 2 * kT * kLd);
  const dim3 grid((unsigned)(B * H), (unsigned)(a.dh64 / kT));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? launch<float>(a, grid, bytes, s)
                   : launch<__nv_bfloat16>(a, grid, bytes, s);
  return (int)err;
}
