// paged_attention_decode: one query token per row over a paged K/V pool.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/paged_attention.py:
//   paged_attention_decode (+ _kernel).
//
// Computes, for every row b and query head hq (GQA: kv head h = hq / rep):
//   out[b, hq] = softmax_t(softcap(scale * q[b, hq] . K[t, h])) @ V[t, h]
// over positions t < kv_len[b], where position t lives at page
// block_tables[b, t / ps], row t % ps of the pools (n_pages, ps, KV, d).
// Rows with kv_len 0 produce exactly 0. q, the pools and out share one type
// (bf16 or f32); scores, the softmax and the sums are f32.
//
// What bounds it on the card: it streams each row's K and V once,
// 2 * kv_len * d * sizeof(T) bytes per (row, kv head), at 3.35 TB/s;
// the arithmetic is ~4 * rep flops per streamed element, far below the
// card's ratio. Packed prefill flattens every prompt token into its own
// row, so there each token re-reads its sequence's K/V (slow for long
// prompts but exact; the flash-attention kernel of a later slice fixes it).
//
// Design (simple and correct first):
//   * one thread block (128 threads) per (row, kv head), serving the rep
//     query heads that share the kv head, so K/V is read once for all rep;
//   * a loop over ceil(kv_len / ps) pages: read the page id from the block
//     table, stage the page's (ps, d) K and V rows for this head in shared
//     memory (stride KV * d in the pool), one warp per (query head, key)
//     score with a fixed-order shuffle reduction, then an f32 online softmax
//     update (running max, sum and rescaled accumulator) — the pages never
//     materialise as a gathered copy in device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int ACC_MAX = 8;   // rep * d <= ACC_MAX * THREADS

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
paged_attention_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ kv_lens, T* __restrict__ out,
                              int H, int KV, int d, int ps, int max_pages,
                              float scale, float softcap) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int rep = H / KV;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = THREADS / 32;
  float* qs = smem;               // (rep, d)
  float* ks = qs + rep * d;       // (ps, d)
  float* vs = ks + ps * d;        // (ps, d)
  float* ss = vs + ps * d;        // (rep, ps) scores, then probabilities
  float* ms = ss + rep * ps;      // (rep,) running max
  float* ls = ms + rep;           // (rep,) running sum
  float* cs = ls + rep;           // (rep,) rescale factor of this page

  const int kv_len = kv_lens[b];
  const size_t q_off = ((size_t)b * H + (size_t)h * rep) * d;
  for (int i = tid; i < rep * d; i += THREADS) qs[i] = to_f(q[q_off + i]);
  if (tid < rep) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }
  float acc[ACC_MAX];
#pragma unroll
  for (int j = 0; j < ACC_MAX; ++j) acc[j] = 0.f;
  __syncthreads();

  const int n_used = (kv_len + ps - 1) / ps;
  const size_t row_stride = (size_t)KV * d;
  for (int j = 0; j < n_used; ++j) {
    const int page = block_tables[(size_t)b * max_pages + j];
    for (int i = tid; i < ps * d; i += THREADS) {
      const int t = i / d, dd = i - t * d;
      const size_t off = ((size_t)page * ps + t) * row_stride + (size_t)h * d + dd;
      ks[i] = to_f(k_pool[off]);
      vs[i] = to_f(v_pool[off]);
    }
    __syncthreads();
    for (int p = warp; p < rep * ps; p += n_warps) {
      const int r = p / ps, t = p - r * ps;
      float s = 0.f;
      for (int dd = lane; dd < d; dd += 32) s = fmaf(qs[r * d + dd], ks[t * d + dd], s);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == 0) {
        s *= scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        ss[p] = (j * ps + t < kv_len) ? s : -INFINITY;
      }
    }
    __syncthreads();
    if (tid < rep) {
      // every visited page holds at least one unmasked key, so mx is finite
      float mx = ms[tid];
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, ss[tid * ps + t]);
      const float corr = expf(ms[tid] - mx);
      float sum = 0.f;
      for (int t = 0; t < ps; ++t) {
        const float sv = ss[tid * ps + t];
        const float pv = (sv == -INFINITY) ? 0.f : expf(sv - mx);
        ss[tid * ps + t] = pv;
        sum += pv;
      }
      ls[tid] = ls[tid] * corr + sum;
      ms[tid] = mx;
      cs[tid] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < ACC_MAX; ++jj) {
      const int i = tid + jj * THREADS;
      if (i < rep * d) {
        const int r = i / d, dd = i - r * d;
        float a = acc[jj] * cs[r];
        for (int t = 0; t < ps; ++t) a = fmaf(ss[r * ps + t], vs[t * d + dd], a);
        acc[jj] = a;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int jj = 0; jj < ACC_MAX; ++jj) {
    const int i = tid + jj * THREADS;
    if (i < rep * d) {
      const int r = i / d;
      const float v = kv_len > 0 ? acc[jj] / fmaxf(ls[r], 1e-30f) : 0.f;
      out[q_off + i] = from_f<T>(v);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_tables, const void* kv_lens, void* out, int B,
           int H, int KV, int d, int ps, int max_pages, float scale,
           float softcap, cudaStream_t stream) {
  const int rep = H / KV;
  const size_t smem = sizeof(float) * ((size_t)rep * d + 2 * (size_t)ps * d +
                                       (size_t)rep * ps + 3 * (size_t)rep);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(paged_attention_decode_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(B, KV);
  paged_attention_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(kv_lens), static_cast<T*>(out), H, KV, d, ps,
      max_pages, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). The caller has checked shapes,
// types and contiguity, that rep * d <= 1024, that the shared-memory need
// fits, and allocated out (B, H, d). Returns a CUDA error code (0 = ok).
extern "C" int paged_attention_decode(const void* q, const void* k_pool,
                                      const void* v_pool, const void* block_tables,
                                      const void* kv_lens, void* out, int B, int H,
                                      int KV, int d, int ps, int max_pages,
                                      float scale, float softcap, int is_bf16,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_pool, v_pool, block_tables, kv_lens, out, B,
                                 H, KV, d, ps, max_pages, scale, softcap, s);
  return launch<float>(q, k_pool, v_pool, block_tables, kv_lens, out, B, H, KV,
                       d, ps, max_pages, scale, softcap, s);
}
