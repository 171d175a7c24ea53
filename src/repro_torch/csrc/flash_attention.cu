// Flash-attention forward: tiled attention with an online softmax, for
// prefill and the loss forward of the static path.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:
//   flash_attention_fwd (+ _kernel).
//
// Computes, for every batch row b, query head hq (GQA: kv head hk = hq / rep)
// and query position i < Sq:
//   out[b, hq, i] = sum_j p_ij V[b, hk, j] / sum_j p_ij,
//   s_ij = softcap(scale * q[b, hq, i] . K[b, hk, j])   (f32 dot, then scale)
// over the keys j < Skv the mask allows: causal j <= i, window
// j > i - window (window > 0), and, with segment ids, kv_seg[j] == q_seg[i]
// with q_seg[i] >= 0. Positions count from 0 on both sides. p_ij is the
// online-softmax weight, exactly 0 where masked, and enters the PV product
// rounded to V's type (as the Pallas kernel and the jnp path do); maxima,
// sums and the accumulator are f32. Masked scores never enter the maximum,
// whose floor is the finite -2e38, so a row with no visible key (a pad)
// keeps l = 0 and comes out exactly 0, never NaN. A key another segment owns
// is multiplied by an exact 0 and so cannot change a row's bits.
// q, k, v and out share one type T (bf16 or f32); each is addressed by its
// own (batch, head, position) strides with the last dim contiguous, so the
// model passes (B, S, H, d) activations without a transposed copy. Any Sq
// and Skv: the last tiles are masked, never padded in memory.
//
// What bounds it on the card: at the static path's prefill shape (B=8,
// H=16, KV=8, S=512, d=128, causal, bf16) it reads q, K, V and writes out
// once, ~50 MB (~0.015 ms at 3.35 TB/s), and does ~8.6 GFLOP (~0.009 ms on
// the bf16 tensor cores) — memory-bound in the limit, but this first kernel
// runs its products on the SIMT f32 units, so it is bound by their rate and
// by shared-memory bandwidth instead.
//
// Design (simple and correct first):
//   * one block of 256 threads per (q tile of 64 rows, query head, batch
//     row); q tiles are issued last-first, so under a causal mask the tiles
//     with the most keys start first; the block reads its kv head's K/V
//     directly — no GQA repeat copy;
//   * a loop over 64-key tiles from the window's first to the causal
//     frontier (tiles entirely above the diagonal or below the window are
//     skipped, which cannot change any result: they hold only exact 0
//     weights); K and V are staged in shared memory as f32 (K rows padded
//     against bank conflicts), keys past Skv as 0;
//   * each thread holds a 4 x 4 block of scores (rows ty + 16i, keys
//     tx + 16j) and a 4 x d/16 block of the output accumulator in
//     registers; four threads per row run the softmax update of a tile with
//     shuffle reductions. mma/wgmma tensor-core tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;         // 16 x 16
constexpr int BQ = 64;               // query rows per block
constexpr int BKV = 64;              // keys per tile
constexpr int RPT = BQ / 16;         // rows per thread
constexpr int CPT = BKV / 16;        // score columns per thread
constexpr int NJ_MAX = 16;           // d / 16 output columns per thread, d <= 256
constexpr int S_STRIDE = BKV + 4;    // score-tile row stride (bank spread)
constexpr float NEG_INF = -2.0e38f;  // the reference's finite mask value

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

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* q_segs;   // (B, Sq) or null
  const int* kv_segs;  // (B, Skv) or null
  void* out;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int H, KV, Sq, Skv, d, causal, window;
  float scale, softcap;
};

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)BQ * d + (size_t)BKV * (d + 1) + (size_t)BKV * d +
                          (size_t)BQ * S_STRIDE + 3 * (size_t)BQ);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) flash_attention_fwd_kernel(const Args a) {
  extern __shared__ float smem[];
  const int d = a.d, nj = d / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (a.H / a.KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float* qs = smem;                  // (BQ, d)
  float* ks = qs + BQ * d;           // (BKV, d + 1)
  float* vs = ks + BKV * (d + 1);    // (BKV, d)
  float* ss = vs + BKV * d;          // (BQ, S_STRIDE) scores, then p
  float* ms = ss + BQ * S_STRIDE;    // (BQ,) running max
  float* ls = ms + BQ;               // (BQ,) running sum
  float* cs = ls + BQ;               // (BQ,) rescale factor of this tile

  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + hq * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int* kseg = a.kv_segs ? a.kv_segs + (size_t)b * a.Skv : nullptr;

  for (int i = tid; i < BQ * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    qs[i] = (q0 + r < a.Sq) ? to_f(q[(long long)(q0 + r) * a.q_ss + c]) : 0.f;
  }
  if (tid < BQ) {
    ms[tid] = NEG_INF;
    ls[tid] = 0.f;
  }
  int qseg[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int qpos = q0 + ty + 16 * i;
    qseg[i] = (a.q_segs && qpos < a.Sq) ? a.q_segs[(size_t)b * a.Sq + qpos] : 0;
  }
  float acc[RPT][NJ_MAX];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < NJ_MAX; ++j) acc[i][j] = 0.f;

  // key tiles that can hold a visible key for rows q0 .. q0 + BQ - 1
  int hi = (a.Skv + BKV - 1) / BKV;
  if (a.causal) hi = min(hi, (q0 + BQ + BKV - 1) / BKV);
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) / BKV : 0;
  __syncthreads();

  for (int t = lo; t < hi; ++t) {
    const int k0 = t * BKV;
    for (int i = tid; i < BKV * d; i += THREADS) {
      const int r = i / d, c = i - r * d;
      const bool in = k0 + r < a.Skv;
      ks[r * (d + 1) + c] = in ? to_f(k[(long long)(k0 + r) * a.k_ss + c]) : 0.f;
      vs[i] = in ? to_f(v[(long long)(k0 + r) * a.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < CPT; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qv[RPT], kv[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) qv[i] = qs[(ty + 16 * i) * d + c];
#pragma unroll
      for (int j = 0; j < CPT; ++j) kv[j] = ks[(tx + 16 * j) * (d + 1) + c];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = qpos < a.Sq && kpos < a.Skv;
        if (a.causal) ok = ok && kpos <= qpos;
        if (a.window > 0) ok = ok && kpos > qpos - a.window;
        if (kseg) ok = ok && qseg[i] >= 0 && kseg[kpos] == qseg[i];
        float sv = s[i][j] * a.scale;
        if (a.softcap > 0.f) sv = a.softcap * tanhf(sv / a.softcap);
        // -inf marks a masked key: below the -2e38 floor, so it never
        // enters the maximum, and its weight is set to exactly 0 below
        ss[(ty + 16 * i) * S_STRIDE + tx + 16 * j] = ok ? sv : -INFINITY;
      }
    }
    __syncthreads();

    {  // online-softmax update: four threads per row, 16 keys each
      const int r = tid >> 2, part = tid & 3;
      float* row = ss + r * S_STRIDE;
      float mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i) mx = fmaxf(mx, row[part + 4 * i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < BKV / 4; ++i) {
        const float sv = row[part + 4 * i];
        const float pv = (sv == -INFINITY) ? 0.f : expf(sv - m_new);
        sum += pv;
        row[part + 4 * i] = to_f<T>(from_f<T>(pv));   // p in V's type
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = expf(m_old - m_new);
        ls[r] = ls[r] * corr + sum;
        ms[r] = m_new;
        cs[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float corr = cs[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ_MAX; ++j) acc[i][j] *= corr;
    }
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[RPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = ss[(ty + 16 * i) * S_STRIDE + kk];
#pragma unroll
      for (int j = 0; j < NJ_MAX; ++j) {
        if (j < nj) {
          const float vv = vs[kk * d + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  T* out = static_cast<T*>(a.out) + b * a.o_sb + hq * a.o_sh;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    if (qpos >= a.Sq) continue;
    const float l = fmaxf(ls[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ_MAX; ++j)
      if (j < nj) out[(long long)qpos * a.o_ss + tx + 16 * j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T>
int launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.d);
  cudaError_t e = cudaFuncSetAttribute(flash_attention_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.H, B);
  flash_attention_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes). The caller has checked shapes,
// types and strides (last dim contiguous) and allocated out (B, H, Sq, d).
// q_segs / kv_segs are both null or both (B, Sq) / (B, Skv) int32. Returns a
// CUDA error code (0 = ok); cudaErrorInvalidValue for a head_dim that is not
// a multiple of 16 in [16, 256] or H not a multiple of KV.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* q_segs,
    const void* kv_segs, void* out, int B, int H, int KV, int Sq, int Skv, int d,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, float scale,
    float softcap, int is_bf16, void* stream) {
  if (d % 16 || d < 16 || d > 16 * NJ_MAX || KV <= 0 || H % KV)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const Args a{q,    k,    v,    static_cast<const int*>(q_segs),
               static_cast<const int*>(kv_segs),
               out,  q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
               o_sb, o_sh, o_ss, H, KV, Sq, Skv, d, causal, window, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, B, s) : launch<float>(a, B, s);
}
