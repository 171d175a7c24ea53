// msb_matmul: y = x @ dequant(W) (+ bias) for 4-bit MSB weights, on Hopper.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/msb_matmul/msb_matmul.py: msb_matmul (+ _dequant_tile,
//   _kernel, _kernel_bias, pick_blocks).
//
// Storage (byte-identical to the reference's PackedQTensor):
//   packed  uint8 (K, N/2), nibble (sign << 3) | level, low nibble = even col
//   scales  f32, one 8-entry codebook per 64-element block:
//             n-blocked (K, N/64, 8): scales[k, n/64, level]
//             k-blocked (K/64, N, 8): scales[k/64, n, level]
//   x       (M, K) bf16 or f32; bias optional f32 (N,); out (M, N) in x's type
//
// What bounds it on the card: decode shapes (M <= 8) are memory-bound on the
// weight stream. With the f32 codebooks quantize_params produces, that stream
// is 0.5 B/weight of codes plus 0.5 B/weight of scales, so the bound is
//   (K*N/2 + K*N/64*8*4) B / 3.35 TB/s
// (2048 x 2048: 4.2 MB -> 1.25 us). Prefill shapes (M = 512) are bound by
// the arithmetic, which this SIMT version does in f32 FMA.
//
// Design (simple and correct first; wgmma, TMA and warp specialisation are
// later work):
//   * one thread block per (BM x 64) output tile and K split; K is walked in
//     steps of 64 = one MSB block, so a step's codebooks are one 64 x 8 table
//     (indexed by the row for n-blocked scales, by the column for k-blocked);
//   * each step stages the packed bytes (64 x 32 B) and that table in shared
//     memory and decodes the nibbles there (sign, 3-bit level, lookup in the
//     shared codebook; no per-weight gather from device memory), rounding
//     each weight to x's type as the reference does;
//   * every output element is owned by one thread that sums its K range in
//     ascending k with f32 FMA. The K split count depends on (K, N) only and
//     the splits are added in ascending order by a second pass, so the
//     reduction order of an output row never depends on M or on other rows:
//     decode buckets 1/2/4/8 and horizon 1 vs 8 give bit-identical logits;
//   * for small N the K split (at most K/256 splits) fills the 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;       // K step == MSB block
constexpr int BN = 64;       // N tile == MSB block
constexpr int LEVELS = 8;
constexpr int THREADS = 256;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, like astype
}

// grid: (N / 64, ceil(M / BM), splits). partial == nullptr: write y (+bias)
// to out; else write the split's f32 sum to partial[split, m, n].
template <typename T, int BM, bool KBLOCKED>
__global__ void __launch_bounds__(THREADS)
msb_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ packed,
                  const float* __restrict__ scales, const float* __restrict__ bias,
                  T* __restrict__ out, float* __restrict__ partial,
                  int M, int K, int N, int k_per_split) {
  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][BN];
  __shared__ float cb[BK][LEVELS];
  __shared__ __align__(16) uint8_t pk[BK][BN / 2];

  constexpr int RPT = BM / (THREADS / BN);   // output rows per thread
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = k_begin + k_per_split;
  const int tid = threadIdx.x;
  const int col = tid % BN;
  const int rgrp = tid / BN;
  const int half = N / 2;

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, kk = i % BK;
      const int m = m0 + r;
      xs[r][kk] = (m < M) ? to_f(x[(size_t)m * K + k0 + kk]) : 0.f;
    }
    {  // 64 rows x 32 bytes: 8 bytes per thread
      const int r = tid / 4, c8 = (tid % 4) * 8;
      *reinterpret_cast<uint2*>(&pk[r][c8]) = *reinterpret_cast<const uint2*>(
          packed + (size_t)(k0 + r) * half + n0 / 2 + c8);
    }
    for (int i = tid; i < BK * LEVELS; i += THREADS) {
      const int r = i / LEVELS, z = i % LEVELS;
      const size_t off =
          KBLOCKED ? ((size_t)(k0 / BK) * N + n0 + r) * LEVELS + z
                   : ((size_t)(k0 + r) * (N / BN) + n0 / BN) * LEVELS + z;
      cb[r][z] = scales[off];
    }
    __syncthreads();
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, nn = i % BN;
      const uint8_t byte = pk[kk][nn / 2];
      const int nib = (nn & 1) ? (byte >> 4) : (byte & 0xF);
      const float mag = KBLOCKED ? cb[nn][nib & 7] : cb[kk][nib & 7];
      ws[kk][nn] = to_f(from_f<T>((nib & 8) ? -mag : mag));
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float w = ws[kk][col];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = fmaf(xs[rgrp + i * (THREADS / BN)][kk], w, acc[i]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + rgrp + i * (THREADS / BN);
    if (m >= M) continue;
    const int n = n0 + col;
    if (partial != nullptr) {
      partial[((size_t)blockIdx.z * M + m) * N + n] = acc[i];
    } else {
      const float b = bias != nullptr ? bias[n] : 0.f;
      out[(size_t)m * N + n] = from_f<T>(acc[i] + b);
    }
  }
}

// out[m, n] = sum over splits in ascending order (+ bias), cast to T.
template <typename T>
__global__ void split_reduce_kernel(const float* __restrict__ partial,
                                    const float* __restrict__ bias,
                                    T* __restrict__ out, int M, int N, int splits) {
  const size_t total = (size_t)M * N;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = 0.f;
    for (int s = 0; s < splits; ++s) v += partial[(size_t)s * total + i];
    if (bias != nullptr) v += bias[i % N];
    out[i] = from_f<T>(v);
  }
}

template <typename T, int BM, bool KB>
void launch(const void* x, const void* packed, const void* scales,
            const void* bias, void* out, void* partial, int M, int K, int N,
            int splits, cudaStream_t stream) {
  dim3 grid(N / BN, (M + BM - 1) / BM, splits);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  msb_matmul_kernel<T, BM, KB><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const float*>(scales), static_cast<const float*>(bias),
      static_cast<T*>(out), part, M, K, N, K / splits);
  if (splits > 1) {
    const size_t total = (size_t)M * N;
    int blocks = (int)((total + 255) / 256);
    if (blocks > 4096) blocks = 4096;
    split_reduce_kernel<T><<<blocks, 256, 0, stream>>>(
        part, static_cast<const float*>(bias), static_cast<T*>(out), M, N,
        splits);
  }
}

template <typename T>
void dispatch(const void* x, const void* packed, const void* scales,
              const void* bias, void* out, void* partial, int M, int K, int N,
              int splits, int kblocked, cudaStream_t s) {
  if (M <= 8) {
    if (kblocked) launch<T, 8, true>(x, packed, scales, bias, out, partial, M, K, N, splits, s);
    else launch<T, 8, false>(x, packed, scales, bias, out, partial, M, K, N, splits, s);
  } else {
    if (kblocked) launch<T, 32, true>(x, packed, scales, bias, out, partial, M, K, N, splits, s);
    else launch<T, 32, false>(x, packed, scales, bias, out, partial, M, K, N, splits, s);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes). The caller has checked shapes,
// types, contiguity and 16-byte alignment, and allocated out (M, N) and,
// when splits > 1, the f32 workspace partial (splits, M, N). Requires
// K % (64 * splits) == 0 and N % 64 == 0. Returns cudaGetLastError().
extern "C" int msb_matmul(const void* x, const void* packed, const void* scales,
                          const void* bias, void* out, void* partial, int M,
                          int K, int N, int splits, int kblocked, int x_is_bf16,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16)
    dispatch<__nv_bfloat16>(x, packed, scales, bias, out, partial, M, K, N, splits, kblocked, s);
  else
    dispatch<float>(x, packed, scales, bias, out, partial, M, K, N, splits, kblocked, s);
  return (int)cudaGetLastError();
}
