// Paged decode attention for Hopper (sm_90a), float32 or bfloat16 pools.
//
// Replaces src/repro/kernels/paged_attention/kernel.py::paged_attention (the
// Pallas TPU kernel, body `_kernel`). One new-token query per sequence
// attends over that sequence's pages of a paged KV pool:
//
//   q          (B, Hq, d)            out (B, Hq, d), same dtype as q
//   k/v pages  (P, Hkv, page, d)     page_table (B, n_slots) int32
//   lengths    (B,) int32            g = Hq / Hkv query rows per kv head
//
// Semantics follow the TPU kernel: scores are scaled by 1/sqrt(d), then an
// optional tanh softcap; keys at positions >= length do not count; the
// softmax is an online softmax in float32; the output is acc / max(l, 1e-30),
// so a sequence of length 0 gets zeros. Slots that start at or past the
// length are never read, so their page ids may be garbage. A page id outside
// [0, P) inside the length makes that (b, kv-head) output NaN.
//
// Design. The TPU kernel carries (acc, m, l) in scratch across a sequential
// page axis of its grid; Hopper blocks run in no order, so here the page
// axis is a loop inside the block. One block of 4 warps per (kv head, b);
// the g query rows, pre-scaled, sit in shared memory. The block walks the
// pages while i * page < length and reads page_table[b, i] inside that loop;
// the warps split each page's keys. A warp reads a key row and a value row
// with lane-contiguous loads (lane owns d-indices lane + 32 j), reduces the
// g dot products with butterfly shuffles and updates its own float32
// running max, sum and accumulator. At the end the warps' states merge
// through shared memory.
//
// Bound: the K/V bytes of the live pages (each key and value row is read
// once); the arithmetic is 4 g d flops per key, far below the memory line.
// Splitting long sequences across blocks, TMA and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;

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

// DL: d-elements per lane (d <= 32 * DL). G: query rows held (g <= G).
template <typename T, int DL, int G>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                       const T* __restrict__ v_pages,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int Hkv, int g, int d, int page, int n_slots, int P,
                       float scale, float softcap) {
  constexpr int DW = 32 * DL;
  __shared__ float q_s[G][DW];
  __shared__ float acc_s[kWarps][G][DW];
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row0 = (size_t)b * Hkv * g + (size_t)h * g;  // first q row

  const int n_keys = min(max(lengths[b], 0), n_slots * page);

  for (int i = threadIdx.x; i < G * DW; i += blockDim.x) {
    const int gi = i / DW, e = i % DW;
    q_s[gi][e] = (gi < g && e < d) ? to_f32(q[(row0 + gi) * d + e]) * scale
                                   : 0.f;
  }
  __syncthreads();

  float m[G], l[G], acc[G][DL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = -INFINITY;
    l[gi] = 0.f;
#pragma unroll
    for (int j = 0; j < DL; ++j) acc[gi][j] = 0.f;
  }

  bool bad = false;
  for (int i = 0; i * page < n_keys; ++i) {
    const int pid = page_table[(size_t)b * n_slots + i];
    if (pid < 0 || pid >= P) {  // the same for every thread of the block
      bad = true;
      break;
    }
    const size_t base = ((size_t)pid * Hkv + h) * page;
    const int t_end = min(page, n_keys - i * page);
    for (int t = warp; t < t_end; t += kWarps) {
      const T* kr = k_pages + (base + t) * d;
      const T* vr = v_pages + (base + t) * d;
      float kv[DL], vv[DL];
#pragma unroll
      for (int j = 0; j < DL; ++j) {
        const int e = lane + 32 * j;
        kv[j] = e < d ? to_f32(kr[e]) : 0.f;
        vv[j] = e < d ? to_f32(vr[e]) : 0.f;
      }
      float s[G];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < DL; ++j) a += q_s[gi][lane + 32 * j] * kv[j];
        s[gi] = a;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int gi = 0; gi < G; ++gi)
          s[gi] += __shfl_xor_sync(0xffffffffu, s[gi], off);
      }
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float x = s[gi];
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        const float m_new = fmaxf(m[gi], x);
        const float corr = expf(m[gi] - m_new);
        const float p = expf(x - m_new);
        l[gi] = l[gi] * corr + p;
#pragma unroll
        for (int j = 0; j < DL; ++j) acc[gi][j] = acc[gi][j] * corr + p * vv[j];
        m[gi] = m_new;
      }
    }
  }

#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) {
      m_s[warp][gi] = m[gi];
      l_s[warp][gi] = l[gi];
    }
#pragma unroll
    for (int j = 0; j < DL; ++j) acc_s[warp][gi][lane + 32 * j] = acc[gi][j];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < g * d; i += blockDim.x) {
    const int gi = i / d, e = i % d;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w][gi]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = m_s[w][gi];
      if (mw == -INFINITY) continue;  // this warp saw no key
      const float c = expf(mw - M);
      L += l_s[w][gi] * c;
      A += acc_s[w][gi][e] * c;
    }
    const float o = bad ? NAN : A / fmaxf(L, 1e-30f);
    out[(row0 + gi) * d + e] = from_f32<T>(o);
  }
}

#define PA_ARGS                                                             \
  static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), \
      page_table, lengths, static_cast<T*>(out), Hkv, g, d, page, n_slots, P, \
      scale, softcap

template <typename T, int DL>
void launch_dl(int G, dim3 grid, dim3 block, cudaStream_t stream,
               const void* q, const void* k, const void* v,
               const int* page_table, const int* lengths, void* out, int Hkv,
               int g, int d, int page, int n_slots, int P, float scale,
               float softcap) {
  switch (G) {
    case 1: paged_attention_kernel<T, DL, 1><<<grid, block, 0, stream>>>(PA_ARGS); break;
    case 2: paged_attention_kernel<T, DL, 2><<<grid, block, 0, stream>>>(PA_ARGS); break;
    case 4: paged_attention_kernel<T, DL, 4><<<grid, block, 0, stream>>>(PA_ARGS); break;
    default: paged_attention_kernel<T, DL, 8><<<grid, block, 0, stream>>>(PA_ARGS); break;
  }
}

template <typename T>
void launch_t(int DL, int G, dim3 grid, dim3 block, cudaStream_t stream,
              const void* q, const void* k, const void* v,
              const int* page_table, const int* lengths, void* out, int Hkv,
              int g, int d, int page, int n_slots, int P, float scale,
              float softcap) {
  switch (DL) {
    case 1: launch_dl<T, 1>(G, grid, block, stream, q, k, v, page_table, lengths, out, Hkv, g, d, page, n_slots, P, scale, softcap); break;
    case 2: launch_dl<T, 2>(G, grid, block, stream, q, k, v, page_table, lengths, out, Hkv, g, d, page, n_slots, P, scale, softcap); break;
    case 4: launch_dl<T, 4>(G, grid, block, stream, q, k, v, page_table, lengths, out, Hkv, g, d, page, n_slots, P, scale, softcap); break;
    default: launch_dl<T, 8>(G, grid, block, stream, q, k, v, page_table, lengths, out, Hkv, g, d, page, n_slots, P, scale, softcap); break;
  }
}

}  // namespace

// C entry for ctypes. dtype: 0 = float32, 1 = bfloat16 (q, pools and out).
// Launches on `stream` of `device` and returns cudaGetLastError() (0 when
// the launch was accepted); shapes it does not take return
// cudaErrorInvalidValue without launching.
extern "C" int paged_attention_launch(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const int* page_table,
                                      const int* lengths, void* out, int B,
                                      int Hq, int Hkv, int d, int page,
                                      int n_slots, int P, float scale,
                                      float softcap, int dtype, int device,
                                      void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > 8 || d <= 0 ||
      d > 256 || page <= 0 || n_slots <= 0 || P <= 0 || B > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int g = Hq / Hkv;
  const int G = g <= 1 ? 1 : g <= 2 ? 2 : g <= 4 ? 4 : 8;
  const int DL = d <= 32 ? 1 : d <= 64 ? 2 : d <= 128 ? 4 : 8;
  const dim3 grid(Hkv, B), block(kWarps * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_t<float>(DL, G, grid, block, s, q, k_pages, v_pages, page_table,
                    lengths, out, Hkv, g, d, page, n_slots, P, scale, softcap);
  else
    launch_t<__nv_bfloat16>(DL, G, grid, block, s, q, k_pages, v_pages,
                            page_table, lengths, out, Hkv, g, d, page, n_slots,
                            P, scale, softcap);
  return (int)cudaGetLastError();
}
