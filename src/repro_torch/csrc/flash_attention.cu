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
// over the keys j < Skv the mask allows: causal j <= q_offset + i, window
// j > q_offset + i - window (window > 0), and, with segment ids,
// kv_seg[j] == q_seg[i] with q_seg[i] >= 0. Keys count from 0; query row i
// sits at position q_offset + i (q_offset >= 0; context parallelism gives a
// rank's rows their global positions, 0 everywhere else). p_ij is the
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
// the bf16 tensor cores): memory-bound in the limit, so mma.sync tiles
// (not wgmma) suffice to leave the products off the critical path.
//
// bf16 (the model's type), on the tensor cores, FlashAttention-2 shape:
//   * one block of 4 warps per (q tile of 64 rows, query head, batch row),
//     each warp 16 query rows; q tiles are issued last-first, so under a
//     causal mask the tiles with the most keys start first; the block reads
//     its kv head's K/V directly (no GQA repeat copy);
//   * Q (once) and 64-key K and V tiles are staged in shared memory as bf16
//     by 16-byte cp.async copies: K in a 2-stage ring (the next tile loads
//     while this one computes), V in one buffer that loads while QK^T and
//     the softmax run (70 KB at d = 128: three blocks an SM); rows are
//     padded by 16 bytes so ldmatrix reads hit distinct banks; keys past
//     Skv (and columns past d) are zero-filled by the copy, so a 0 weight
//     never meets garbage;
//   * S = Q K^T and O += P V run on mma.sync.m16n8k16 (bf16 in, f32
//     accumulate), operands through ldmatrix (ldmatrix.trans for V); S
//     stays in registers as accumulator fragments, kept in log2 units
//     (scale * log2 e folded into one multiply, exp2 for the weights); the
//     row max and sum take quad shuffles, per-key masks run only on edge
//     tiles, and p is rounded to bf16 in registers and fed straight in as
//     the A operand of the PV product;
//   * tiles entirely above the diagonal or below the window are skipped,
//     which cannot change any result: they hold only exact 0 weights.
// f32 keeps the SIMT kernel below (f32 products on the FMA units, exact to
// 1e-5 against the plain version, which TF32 tensor cores would not be):
//   * one block of 256 threads per (q tile, head, batch row); K and V tiles
//     staged in shared memory as f32 (K rows padded against bank
//     conflicts), keys past Skv as 0;
//   * each thread holds a 4 x 4 block of scores and a 4 x d/16 block of the
//     output accumulator in registers; four threads per row run the
//     softmax update of a tile with shuffle reductions.
// The kernel is chosen by dtype alone. Either kernel also writes, when asked
// (a non-null lse), each query row's log-sum-exp m + log(max(l, 1e-30)) in
// f32 once its last tile is done: the residual the training backward
// (models/attention.py:flash_attention_bwd) reads, as the reference's VJP
// keeps it. A null lse leaves every other output as it was.
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
  float* lse;          // (B, H, Sq) f32 or null
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int H, KV, Sq, Skv, d, causal, window;
  int q_offset;        // query row i sits at position q_offset + i
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
  if (a.causal) hi = min(hi, (a.q_offset + q0 + BQ + BKV - 1) / BKV);
  const int lo = a.window > 0 ? max(0, a.q_offset + q0 - a.window + 1) / BKV : 0;
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
        if (a.causal) ok = ok && kpos <= qpos + a.q_offset;
        if (a.window > 0) ok = ok && kpos > qpos + a.q_offset - a.window;
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
    if (a.lse && tx == 0)
      a.lse[((size_t)b * a.H + hq) * a.Sq + qpos] = ms[r] + logf(l);
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = 32 * TC_WARPS;
constexpr int TC_BQ = 16 * TC_WARPS;   // query rows per block, 16 per warp
constexpr int TC_BKV = 64;             // keys per tile
constexpr int TC_K_STAGES = 2;         // K tiles in flight; V has one buffer

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared memory of the tensor-core kernel for padded head dim DP: Q (TC_BQ
// rows), TC_K_STAGES K tiles and one V tile, rows of DP + 8 bf16 (70 KB at
// DP = 128, so three blocks fit on an SM).
size_t tc_smem_bytes(int dp) {
  return sizeof(bf16) * (size_t)(dp + 8) * (TC_BQ + (TC_K_STAGES + 1) * TC_BKV);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; zero-filled when !in (src is then not read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stages rows r0 .. r0 + ROWS - 1 (of `limit`) of a (rows, d) bf16 matrix
// with row stride ss into shared memory rows of DP + 8; rows past `limit`
// and columns past d are zero-filled. Each thread copies one fixed 16-byte
// column chunk of every (TC_THREADS / (DP / 8))-th row.
template <int DP, int ROWS>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long long ss,
                                           int r0, int limit, int d) {
  constexpr int CPR = DP / 8;               // 16-byte chunks a row
  constexpr int RPI = TC_THREADS / CPR;     // rows a pass of the block
  static_assert(ROWS % RPI == 0, "tile rows must split into block passes");
  const int c = threadIdx.x % CPR, rr = threadIdx.x / CPR;
  const bool col_in = c * 8 < d;
  const bf16* p = src + (long long)(r0 + rr) * ss + c * 8;
  const uint32_t s0 = smem_u32(dst + rr * (DP + 8) + c * 8);
#pragma unroll
  for (int i = 0; i < ROWS / RPI; ++i) {
    const bool in = col_in && r0 + rr + i * RPI < limit;
    cp_async16(s0 + i * RPI * (DP + 8) * (int)sizeof(bf16),
               in ? p + (long long)i * RPI * ss : src, in);
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS, DP <= 128 ? 3 : 1)
    flash_attention_tc_kernel(const Args a) {
  constexpr int LD = DP + 8;
  constexpr int NT = DP / 8;   // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // (TC_BQ, LD)
  bf16* ks = qs + TC_BQ * LD;                      // (TC_K_STAGES, TC_BKV, LD)
  bf16* vs = ks + TC_K_STAGES * TC_BKV * LD;       // (TC_BKV, LD)

  const int q0 = (gridDim.x - 1 - blockIdx.x) * TC_BQ;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (a.H / a.KV);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + hq * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int* kseg = a.kv_segs ? a.kv_segs + (size_t)b * a.Skv : nullptr;

  // key tiles that can hold a visible key for rows q0 .. q0 + TC_BQ - 1
  int hi = (a.Skv + TC_BKV - 1) / TC_BKV;
  if (a.causal) hi = min(hi, (a.q_offset + q0 + TC_BQ + TC_BKV - 1) / TC_BKV);
  const int lo = a.window > 0 ? max(0, a.q_offset + q0 - a.window + 1) / TC_BKV : 0;

  stage_rows<DP, TC_BQ>(qs, q, a.q_ss, q0, a.Sq, a.d);
  if (lo < hi) stage_rows<DP, TC_BKV>(ks, k, a.k_ss, lo * TC_BKV, a.Skv, a.d);
  cp_async_commit();

  // this thread's two query rows (fragment rows g and g + 8 of its warp)
  const int row0 = q0 + warp * 16 + g, row1 = row0 + 8;
  int qseg0 = 0, qseg1 = 0;
  if (a.q_segs) {
    qseg0 = row0 < a.Sq ? a.q_segs[(size_t)b * a.Sq + row0] : -1;
    qseg1 = row1 < a.Sq ? a.q_segs[(size_t)b * a.Sq + row1] : -1;
  }
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  const uint32_t q_addr = smem_u32(qs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8);
  // K: matrices (keys +0..7 | +8..15) x (dims +0 | +8) -> b0, b1 of two key tiles
  const int k_row = (lane & 7) + ((lane >> 4) << 3), k_col = ((lane >> 3) & 1) * 8;
  // V (transposed): (keys +0..7 | +8..15) x (dims +0 | +8) -> b0, b1 of two dim tiles
  const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8, v_col = (lane >> 4) * 8;

  // Copy groups, oldest first: Q + K(lo); then per tile V(t), K(t + 1).
  // V(t) lands while QK(t) and the softmax run; K(t + 1) while all of tile
  // t runs.
  const float scale2 = a.scale * LOG2E;   // scores are kept in log2 units
  for (int t = lo; t < hi; ++t) {
    const int st = (t - lo) & 1;
    stage_rows<DP, TC_BKV>(vs, v, a.v_ss, t * TC_BKV, a.Skv, a.d);
    cp_async_commit();
    if (t + 1 < hi)
      stage_rows<DP, TC_BKV>(ks + (st ^ 1) * TC_BKV * LD, k, a.k_ss, (t + 1) * TC_BKV,
                             a.Skv, a.d);
    cp_async_commit();
    cp_async_wait<2>();   // Q and K(t) have landed
    __syncthreads();
    const bf16* kt = ks + st * TC_BKV * LD;
    const bf16* vt = vs;
    const int k0 = t * TC_BKV;

    // S = Q K^T, 16 x 64 per warp, f32 in registers
    float s[TC_BKV / 8][4];
#pragma unroll
    for (int j = 0; j < TC_BKV / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc) {
      uint32_t af[4];
      ldsm_x4(af, q_addr + kc * 16 * sizeof(bf16));
#pragma unroll
      for (int np = 0; np < TC_BKV / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4(bf, smem_u32(kt + (np * 16 + k_row) * LD + kc * 16 + k_col));
        mma_bf16(s[2 * np], af, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], af, bf[2], bf[3]);
      }
    }

    // scale, softcap, mask: the scores become scale * q.k (softcapped)
    // times log2(e), so exp2 gives the softmax weights. -inf marks a masked
    // key (below the -2e38 floor, so it never enters the maximum, and
    // 2^(-inf - m) is exactly 0). A tile wholly below the diagonal and
    // inside Skv, with no window and no segments, needs no mask (rows past
    // Sq hold zero queries and are not written), so the per-key tests run
    // only on edge tiles.
    const bool masked = (a.causal && k0 + TC_BKV - 1 > q0 + a.q_offset) || k0 + TC_BKV > a.Skv ||
                        a.window > 0 || kseg;
    if (a.softcap > 0.f) {
#pragma unroll
      for (int j = 0; j < TC_BKV / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[j][i] = a.softcap * tanhf(s[j][i] * a.scale / a.softcap) * LOG2E;
    } else {
#pragma unroll
      for (int j = 0; j < TC_BKV / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[j][i] *= scale2;
    }
    if (masked) {
#pragma unroll
      for (int j = 0; j < TC_BKV / 8; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = i < 2 ? row0 : row1;
          const int qsg = i < 2 ? qseg0 : qseg1;
          const int kpos = k0 + j * 8 + 2 * tq + (i & 1);
          bool ok = row < a.Sq && kpos < a.Skv;
          if (a.causal) ok = ok && kpos <= row + a.q_offset;
          if (a.window > 0) ok = ok && kpos > row + a.q_offset - a.window;
          if (kseg) ok = ok && qsg >= 0 && kseg[kpos] == qsg;
          if (!ok) s[j][i] = -INFINITY;
        }
      }
    }
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < TC_BKV / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < TC_BKV / 8; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);   // mn0, mn1 >= -2e38: finite
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
    m0 = mn0;
    m1 = mn1;
    // a factor of exactly 1 changes nothing, so the rescale is skipped
    // when no row max of the warp moved
    if (!__all_sync(0xffffffffu, c0 == 1.f && c1 == 1.f)) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= c0;
        o[n][1] *= c0;
        o[n][2] *= c1;
        o[n][3] *= c1;
      }
    }
    cp_async_wait<1>();   // V(t) has landed
    __syncthreads();

    // O += P V: p rounded to bf16 in registers is the A operand
    uint32_t pf[TC_BKV / 16][4];
#pragma unroll
    for (int kc = 0; kc < TC_BKV / 16; ++kc) {
      pf[kc][0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
      pf[kc][1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
      pf[kc][2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
      pf[kc][3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
    }
#pragma unroll
    for (int kc = 0; kc < TC_BKV / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t bf[4];
        ldsm_x4_trans(bf, smem_u32(vt + (kc * 16 + v_row) * LD + np * 16 + v_col));
        mma_bf16(o[2 * np], pf[kc], bf[0], bf[1]);
        mma_bf16(o[2 * np + 1], pf[kc], bf[2], bf[3]);
      }
    }
    __syncthreads();   // V and K stage st are refilled by the next copies
  }
  cp_async_wait<0>();

  bf16* out = static_cast<bf16*>(a.out) + b * a.o_sb + hq * a.o_sh;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  if (a.lse && tq == 0) {   // m and l are the same in the four lanes of a quad
    float* lse = a.lse + ((size_t)b * a.H + hq) * a.Sq;
    if (row0 < a.Sq) lse[row0] = (m0 == NEG_INF ? NEG_INF : m0 * LN2) + logf(d0);
    if (row1 < a.Sq) lse[row1] = (m1 == NEG_INF ? NEG_INF : m1 * LN2) + logf(d1);
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int col = n * 8 + 2 * tq;
    if (col >= a.d) continue;
    if (row0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)row0 * a.o_ss + col) =
          __floats2bfloat162_rn(o[n][0] / d0, o[n][1] / d0);
    if (row1 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)row1 * a.o_ss + col) =
          __floats2bfloat162_rn(o[n][2] / d1, o[n][3] / d1);
  }
}

template <int DP>
int launch_tc(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(DP);
  cudaError_t e = cudaFuncSetAttribute(flash_attention_tc_kernel<DP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((a.Sq + TC_BQ - 1) / TC_BQ, a.H, B);
  flash_attention_tc_kernel<DP><<<grid, TC_THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The tensor-core kernel for the smallest padded head dim that holds d.
int launch_bf16(const Args& a, int B, cudaStream_t stream) {
  if (a.d <= 16) return launch_tc<16>(a, B, stream);
  if (a.d <= 32) return launch_tc<32>(a, B, stream);
  if (a.d <= 64) return launch_tc<64>(a, B, stream);
  if (a.d <= 128) return launch_tc<128>(a, B, stream);
  return launch_tc<256>(a, B, stream);
}

}  // namespace

// Plain C entry point (bound with ctypes). The caller has checked shapes,
// types and strides (last dim contiguous; for bf16 every pointer and row
// stride 16-byte aligned) and allocated out (B, H, Sq, d) with q's strides.
// q_segs / kv_segs are both null or both (B, Sq) / (B, Skv) int32. lse is null
// or a contiguous (B, H, Sq) f32 output for each query row's log-sum-exp of
// its scores, m + log(max(l, 1e-30)) in natural units (the reference's
// residual for the backward; -2e38 for a row that sees no key). Returns a
// CUDA error code (0 = ok); cudaErrorInvalidValue for a head_dim that is not
// a multiple of 16 in [16, 256], H not a multiple of KV or q_offset < 0.
// bf16 runs on the tensor cores, f32 on the SIMT kernel.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* q_segs,
    const void* kv_segs, void* out, void* lse, int B, int H, int KV, int Sq, int Skv, int d,
    long long q_sb, long long q_sh, long long q_ss, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, long long o_sb,
    long long o_sh, long long o_ss, int causal, int window, int q_offset, float scale,
    float softcap, int is_bf16, void* stream) {
  if (d % 16 || d < 16 || d > 16 * NJ_MAX || KV <= 0 || H % KV || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0 || H == 0) return 0;
  const Args a{q,    k,    v,    static_cast<const int*>(q_segs),
               static_cast<const int*>(kv_segs),
               out,  static_cast<float*>(lse),
               q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
               o_sb, o_sh, o_ss, H, KV, Sq, Skv, d, causal, window, q_offset, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bf16(a, B, s) : launch<float>(a, B, s);
}
