// Blocked (flash) attention forward for Hopper (sm_90a), float32 or bfloat16.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention (the
// Pallas TPU kernel, body `_kernel`). Causal, sliding-window and softcapped
// attention with grouped kv heads:
//
//   q    (B, Hq, Sq, d)     k/v (B, Hkv, Sk, d)     out (B, Hq, Sq, d)
//
// each given by (batch, head, seq) strides in elements with a contiguous
// last dimension, so the caller's (B, S, H, d) -> (B, H, S, d) transposes
// stay views. q-head h reads kv-head h / g (g = Hq / Hkv), never expanded.
//
// Semantics follow the TPU kernel: q is scaled by 1/sqrt(d); a score takes
// the optional tanh softcap, then the mask (causal q_pos >= k_pos with both
// positions counted from 0, window q_pos - k_pos < window) sets it to -1e30;
// the softmax is an online softmax in float32 with the running max starting
// at -1e30; the output is acc / max(l, 1e-30) in q's dtype. Key tiles that
// lie wholly outside the causal or window band are skipped, as the TPU
// kernel's `band` test does. Sq and Sk need not be multiples of a tile: keys
// past Sk score -inf (they do not exist, so they weigh 0 even for a row that
// has seen only masked keys), and rows past Sq are not written.
//
// Design. The TPU grid is (B*Hq, q blocks, k blocks) with the k axis
// sequential and (acc, m, l) in VMEM scratch; Hopper blocks run in no order,
// so here the k loop runs inside one block per (b*Hq + h, 64-row q tile).
// The q tile (pre-scaled, transposed) stays in shared memory; each 64-key
// tile of K (transposed) and then of V is staged in one shared buffer. 256
// threads form a 16 x 16 grid: thread (ty, tx) computes the 4 x 4 scores of
// rows 4ty.. and keys 4tx.. as outer products of float4 reads, reduces the
// row max across its 16-thread half-warp with shuffles, and keeps its rows'
// float32 accumulator for columns 64j + 4tx.. of the output. Probabilities
// pass to the P.V product through shared memory. Heaviest causal q tiles
// are launched first.
//
// Bound: at the model's shape (S = 4096, d = 128) the work is operations,
// 4 d per visible (q, k) pair, far above the bytes of q, k, v and out. This
// kernel does that arithmetic in float32 on the CUDA cores; wgmma, TMA and
// bf16 tensor-core products are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;             // q rows per block
constexpr int kBK = 64;             // keys per tile
constexpr int kThreads = 256;
constexpr int kLd = kBQ + 4;        // row stride of transposed tiles (16-B aligned)
constexpr float kMasked = -1e30f;

static_assert(kBQ == kBK, "the 16 x 16 thread grid covers square tiles");

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq[3], sk[3], sv[3], so[3];  // (batch, head, seq) strides
  int Hq, g, Sq, Sk, d, causal, window;
  float scale, softcap;
};

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

// Shared floats: q tile [D][kLd], K^T tile [D][kLd] or V tile [kBK][D] (one
// buffer), probabilities [kBK][kLd].
template <int D>
constexpr int smem_bytes() {
  return (2 * D * kLd + kBK * kLd) * (int)sizeof(float);
}

// D: padded head dim (64, 128 or 256), d <= D.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, D <= 128 ? 2 : 1)
flash_attention_kernel(const Args a) {
  constexpr int NV = D / 64;  // float4 output column groups per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kv = qs + D * kLd;
  float* ps = kv + D * kLd;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / a.Hq, h = bh % a.Hq, hk = h / a.g;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const T* q = static_cast<const T*>(a.q) + b * a.sq[0] + h * a.sq[1];
  const T* k = static_cast<const T*>(a.k) + b * a.sk[0] + hk * a.sk[1];
  const T* v = static_cast<const T*>(a.v) + b * a.sv[0] + hk * a.sv[1];
  T* o = static_cast<T*>(a.o) + b * a.so[0] + h * a.so[1];

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, e = i % D;
    float x = 0.f;
    if (q0 + r < a.Sq && e < a.d)
      x = to_f32(q[(long long)(q0 + r) * a.sq[2] + e]) * a.scale;
    qs[e * kLd + r] = x;
  }

  // the keys any row of this tile can see
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  const int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;

  float acc[4][NV][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  }

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile's P.V is done with kv and ps
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, e = i % D;
      float x = 0.f;
      if (k0 + c < a.Sk && e < a.d)
        x = to_f32(k[(long long)(k0 + c) * a.sk[2] + e]);
      kv[e * kLd + c] = x;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int e = 0; e < D; ++e) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + e * kLd + ty * 4);
      const float4 kb = *reinterpret_cast<const float4*>(kv + e * kLd + tx * 4);
      const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kr[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx * 4 + j;
        float x = s[i][j];
        if (a.softcap != 0.f) x = a.softcap * tanhf(x / a.softcap);
        if (kp >= a.Sk)
          x = -INFINITY;
        else if ((a.causal && qp < kp) || (a.window > 0 && qp - kp >= a.window))
          x = kMasked;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
      l[i] = l[i] * corr + rs;  // this thread's share of the row sum
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(ps + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();  // every thread is done reading K^T

    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, e = i % D;
      float x = 0.f;
      if (k0 + c < a.Sk && e < a.d)
        x = to_f32(v[(long long)(k0 + c) * a.sv[2] + e]);
      kv[c * D + e] = x;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(ps + c * kLd + ty * 4);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float4 vb =
            *reinterpret_cast<const float4*>(kv + c * D + 64 * j + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] = fmaf(pr[i], vb.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(pr[i], vb.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(pr[i], vb.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(pr[i], vb.w, acc[i][j][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 1; off < 16; off <<= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    lt = fmaxf(lt, 1e-30f);
    const int qp = q0 + ty * 4 + i;
    if (qp >= a.Sq) continue;
    T* orow = o + (long long)qp * a.so[2];
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int e = 64 * j + tx * 4 + c;
        if (e < a.d) orow[e] = from_f32<T>(acc[i][j][c] / lt);
      }
  }
}

template <typename T, int D>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const Args& a, dim3 grid, cudaStream_t stream) {
  if (a.d <= 64) return launch<T, 64>(a, grid, stream);
  if (a.d <= 128) return launch<T, 128>(a, grid, stream);
  return launch<T, 256>(a, grid, stream);
}

}  // namespace

// C entry for ctypes. strides: 12 int64, the (batch, head, seq) strides in
// elements of q, k, v and out, in that order (the last dimension of each is
// contiguous). dtype: 0 = float32, 1 = bfloat16 (q, k, v and out). Launches
// on `stream` of `device` and returns the CUDA error (0 when the launch was
// accepted); shapes it does not take return cudaErrorInvalidValue without
// launching.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out,
                                      const long long* strides, int B, int Hq,
                                      int Hkv, int Sq, int Sk, int d,
                                      int causal, int window, float scale,
                                      float softcap, int dtype, int device,
                                      void* stream) {
  const long long n_qt = (Sq + kBQ - 1) / kBQ;
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Sk < 0 ||
      d <= 0 || d > 256 || window < 0 || n_qt > 65535 ||
      (long long)B * Hq > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  for (int i = 0; i < 3; ++i) {
    a.sq[i] = strides[i];
    a.sk[i] = strides[3 + i];
    a.sv[i] = strides[6 + i];
    a.so[i] = strides[9 + i];
  }
  a.Hq = Hq;
  a.g = Hq / Hkv;
  a.Sq = Sq;
  a.Sk = Sk;
  a.d = d;
  a.causal = causal != 0;
  a.window = window;
  a.scale = scale;
  a.softcap = softcap;
  const dim3 grid((unsigned)(B * Hq), (unsigned)n_qt);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 0 ? launch_t<float>(a, grid, s)
                   : launch_t<__nv_bfloat16>(a, grid, s);
  return (int)err;
}
