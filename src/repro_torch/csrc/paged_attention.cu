// Paged-attention decode kernels: one query token per row over a paged
// K/V pool, kv16 (paged_attention_decode) or MSB-quantized
// (paged_attention_decode_quant). Both share one page walk and differ only
// in how a page is staged in shared memory.
//
// Replace the Pallas TPU kernels
//   src/repro/kernels/paged_attention/paged_attention.py:
//   paged_attention_decode (+ _kernel) and
//   paged_attention_decode_quant (+ _quant_kernel, _dequant_tile).
//
// Computes, for every row b and query head hq (GQA: kv head h = hq / rep):
//   out[b, hq] = softmax_t(softcap(scale * q[b, hq] . K[t, h])) @ V[t, h]
// over positions t < kv_len[b]. Position t lives on page j = t / ps, row
// t % ps. Rows with kv_len 0 produce exactly 0. q, out and the kv16 pools
// (or the hot pools) share one type T (bf16 or f32); scores, the softmax
// and the sums are f32.
//
// kv16: page j is page block_tables[b, j] of the pools (n_pages, ps, KV, d).
// Quantized: pages j < n_full[b] are committed and come from the codes pool
// of page block_tables[b, j] and that page's codebooks; page j == n_full[b]
// is the frontier page, read at full precision from hot row hot_rows[b] of
// the hot pools (n_hot, ps, KV, d). In decode n_full = kv_len / ps; in
// packed prefill kv_len is the token's causal bound and n_full its
// segment's frontier, which is why the two are separate inputs.
//   8-bit: codes int8 (n_pages, ps, KV, d); scales f32 (n_pages, KV, nb, 1),
//          value = code * (absmax / 127).
//   4-bit: codes uint8 (n_pages, ps, KV, d/2), nibble (sign<<3)|level, the
//          low nibble holding the even element; scales bf16
//          (n_pages, KV, nb, 8), value = +-codebook[level].
//   Token row t of a page uses codebook row t / tpb (tpb token rows per
//   group). Each dequantized value is rounded to T, as the model path
//   rounds its dequantized copy, before it enters the dot products.
//
// What bounds them on the card: each row's K and V are streamed once —
// 2 * kv_len * d * sizeof(T) bytes per (row, kv head) at kv16, a half (8-bit)
// or a quarter (4-bit) of that plus the codebooks when quantized — at
// 3.35 TB/s; the arithmetic is ~4 * rep flops per streamed element, far
// below the card's ratio. Packed prefill flattens every prompt token into
// its own row, so there each token re-reads its sequence's K/V (slow for
// long prompts but exact; the flash-attention kernel of a later slice
// fixes it).
//
// Design (simple and correct first):
//   * one thread block (128 threads) per (row, kv head), serving the rep
//     query heads that share the kv head, so K/V is read once for all rep;
//   * a loop over ceil(kv_len / ps) pages: stage the page's (ps, d) K and V
//     rows for this head in shared memory (a copy at kv16, a dequantization
//     or a hot-row copy when quantized), one warp per (query head, key)
//     score with a fixed-order shuffle reduction, then an f32 online softmax
//     update (running max, sum and rescaled accumulator) — the pages never
//     materialise as a gathered (or dequantized) copy in device memory.
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

// Stages page j of kv head h of row b (kv16 pools) into ks / vs (ps, d).
template <typename T>
struct PoolPages {
  const T* __restrict__ k_pool;
  const T* __restrict__ v_pool;
  const int* __restrict__ table;  // this row's block-table row
  int h, KV, d, ps;

  __device__ __forceinline__ void operator()(int j, float* ks, float* vs) const {
    const int page = table[j];
    const size_t row_stride = (size_t)KV * d;
    for (int i = threadIdx.x; i < ps * d; i += THREADS) {
      const int t = i / d, dd = i - t * d;
      const size_t off = ((size_t)page * ps + t) * row_stride + (size_t)h * d + dd;
      ks[i] = to_f(k_pool[off]);
      vs[i] = to_f(v_pool[off]);
    }
  }
};

// Dequantized value of element dd of token row t (page-relative) for kv
// head h of page `page`, rounded to T and returned as f32.
template <typename T, int BITS>
__device__ __forceinline__ float dequant(const uint8_t* __restrict__ codes,
                                         const void* __restrict__ scales, int page,
                                         int t, int h, int dd, int KV, int d, int ps,
                                         int tpb, int nb) {
  const size_t srow = ((size_t)page * KV + h) * nb + t / tpb;
  const size_t row = ((size_t)page * ps + t) * KV + h;
  float v;
  if (BITS == 8) {
    const float s = static_cast<const float*>(scales)[srow] / 127.f;
    v = (float)(int8_t)codes[row * d + dd] * s;
  } else {
    const uint8_t byte = codes[row * (d / 2) + dd / 2];
    const int nib = (dd & 1) ? (byte >> 4) : (byte & 0xF);
    const float mag = __bfloat162float(
        static_cast<const __nv_bfloat16*>(scales)[srow * 8 + (nib & 7)]);
    v = (nib & 8) ? -mag : mag;
  }
  return to_f<T>(from_f<T>(v));
}

// Stages page j of kv head h of row b (quantized pools): dequantized from
// the codes for j < n_full, copied from the row's hot row otherwise.
template <typename T, int BITS>
struct QuantPages {
  const uint8_t* __restrict__ k_codes;
  const void* __restrict__ k_scales;
  const uint8_t* __restrict__ v_codes;
  const void* __restrict__ v_scales;
  const T* __restrict__ k_hot;
  const T* __restrict__ v_hot;
  const int* __restrict__ table;  // this row's block-table row
  int n_full, hot, h, KV, d, ps, tpb, nb;

  __device__ __forceinline__ void operator()(int j, float* ks, float* vs) const {
    if (j < n_full) {
      const int page = table[j];
      for (int i = threadIdx.x; i < ps * d; i += THREADS) {
        const int t = i / d, dd = i - t * d;
        ks[i] = dequant<T, BITS>(k_codes, k_scales, page, t, h, dd, KV, d, ps, tpb, nb);
        vs[i] = dequant<T, BITS>(v_codes, v_scales, page, t, h, dd, KV, d, ps, tpb, nb);
      }
    } else {
      const size_t row_stride = (size_t)KV * d;
      for (int i = threadIdx.x; i < ps * d; i += THREADS) {
        const int t = i / d, dd = i - t * d;
        const size_t off = ((size_t)hot * ps + t) * row_stride + (size_t)h * d + dd;
        ks[i] = to_f(k_hot[off]);
        vs[i] = to_f(v_hot[off]);
      }
    }
  }
};

// The page walk of one (row b, kv head h) block; `stage` puts page j's K and
// V rows in shared memory.
template <typename T, typename Stage>
__device__ __forceinline__ void attend_row(const T* __restrict__ q, T* __restrict__ out,
                                           int kv_len, int H, int KV, int d, int ps,
                                           float scale, float softcap, const Stage& stage) {
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
  for (int j = 0; j < n_used; ++j) {
    stage(j, ks, vs);
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
__global__ void __launch_bounds__(THREADS)
paged_attention_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                              const T* __restrict__ v_pool,
                              const int* __restrict__ block_tables,
                              const int* __restrict__ kv_lens, T* __restrict__ out,
                              int H, int KV, int d, int ps, int max_pages,
                              float scale, float softcap) {
  const int b = blockIdx.x;
  const PoolPages<T> stage{k_pool, v_pool, block_tables + (size_t)b * max_pages,
                           (int)blockIdx.y, KV, d, ps};
  attend_row<T>(q, out, kv_lens[b], H, KV, d, ps, scale, softcap, stage);
}

template <typename T, int BITS>
__global__ void __launch_bounds__(THREADS)
paged_attention_quant_kernel(const T* __restrict__ q, const uint8_t* __restrict__ k_codes,
                             const void* __restrict__ k_scales,
                             const uint8_t* __restrict__ v_codes,
                             const void* __restrict__ v_scales,
                             const T* __restrict__ k_hot, const T* __restrict__ v_hot,
                             const int* __restrict__ block_tables,
                             const int* __restrict__ kv_lens,
                             const int* __restrict__ n_full,
                             const int* __restrict__ hot_rows, T* __restrict__ out,
                             int H, int KV, int d, int ps, int max_pages, int tpb,
                             int nb, float scale, float softcap) {
  const int b = blockIdx.x;
  const QuantPages<T, BITS> stage{k_codes, k_scales, v_codes, v_scales, k_hot, v_hot,
                                  block_tables + (size_t)b * max_pages, n_full[b],
                                  hot_rows[b], (int)blockIdx.y, KV, d, ps, tpb, nb};
  attend_row<T>(q, out, kv_lens[b], H, KV, d, ps, scale, softcap, stage);
}

size_t smem_bytes(int rep, int d, int ps) {
  return sizeof(float) * ((size_t)rep * d + 2 * (size_t)ps * d + (size_t)rep * ps +
                          3 * (size_t)rep);
}

// Opts a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* block_tables, const void* kv_lens, void* out, int B,
           int H, int KV, int d, int ps, int max_pages, float scale,
           float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, d, ps);
  cudaError_t e = allow_smem(paged_attention_decode_kernel<T>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, KV);
  paged_attention_decode_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const int*>(block_tables),
      static_cast<const int*>(kv_lens), static_cast<T*>(out), H, KV, d, ps,
      max_pages, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T, int BITS>
int launch_quant(const void* q, const void* k_codes, const void* k_scales,
                 const void* v_codes, const void* v_scales, const void* k_hot,
                 const void* v_hot, const void* block_tables, const void* kv_lens,
                 const void* n_full, const void* hot_rows, void* out, int B, int H,
                 int KV, int d, int ps, int max_pages, int tpb, int nb, float scale,
                 float softcap, cudaStream_t stream) {
  const size_t smem = smem_bytes(H / KV, d, ps);
  cudaError_t e = allow_smem(paged_attention_quant_kernel<T, BITS>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, KV);
  paged_attention_quant_kernel<T, BITS><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const uint8_t*>(k_codes), k_scales,
      static_cast<const uint8_t*>(v_codes), v_scales, static_cast<const T*>(k_hot),
      static_cast<const T*>(v_hot), static_cast<const int*>(block_tables),
      static_cast<const int*>(kv_lens), static_cast<const int*>(n_full),
      static_cast<const int*>(hot_rows), static_cast<T*>(out), H, KV, d, ps, max_pages,
      tpb, nb, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). The caller has checked shapes,
// types and contiguity, that rep * d <= 1024, that the shared-memory need
// fits, and allocated out (B, H, d). They return a CUDA error code (0 = ok).
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

// bits is 8 or 4; tpb and nb are the pools' token rows per codebook group
// and groups per page.
extern "C" int paged_attention_decode_quant(
    const void* q, const void* k_codes, const void* k_scales, const void* v_codes,
    const void* v_scales, const void* k_hot, const void* v_hot, const void* block_tables,
    const void* kv_lens, const void* n_full, const void* hot_rows, void* out, int B,
    int H, int KV, int d, int ps, int max_pages, int tpb, int nb, float scale,
    float softcap, int bits, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PAQ_ARGS                                                                   \
  q, k_codes, k_scales, v_codes, v_scales, k_hot, v_hot, block_tables, kv_lens, n_full, \
      hot_rows, out, B, H, KV, d, ps, max_pages, tpb, nb, scale, softcap, s
  if (bits == 8)
    return is_bf16 ? launch_quant<__nv_bfloat16, 8>(PAQ_ARGS)
                   : launch_quant<float, 8>(PAQ_ARGS);
  if (bits == 4)
    return is_bf16 ? launch_quant<__nv_bfloat16, 4>(PAQ_ARGS)
                   : launch_quant<float, 4>(PAQ_ARGS);
#undef PAQ_ARGS
  return (int)cudaErrorInvalidValue;
}
