// Paged-attention decode kernels: one query token per row over a paged
// K/V pool, kv16 (kernel B, paged_attention_decode) or MSB-quantized
// (kernel C, paged_attention_decode_quant).
//
// Replace the Pallas TPU kernels
//   src/repro/kernels/paged_attention/paged_attention.py:
//   paged_attention_decode (+ _kernel) and
//   paged_attention_decode_quant (+ _quant_kernel, _dequant_tile).
//
// Computes, for every row b and query head hq (GQA: kv head h = hq / rep):
//   out[b, hq] = softmax_t(softcap(scale * q[b, hq] . K[t, h])) @ V[t, h]
// over positions kv_start[b] <= t < kv_len[b]. Position t lives on page
// j = t / ps, row t % ps. kv_start is a sliding window's first visible
// position (gemma2's local layers: max(0, q_pos + 1 - window); 0 without a
// window), computed per row on the device by the caller. Rows with
// kv_start >= kv_len (kv_len 0: pad rows) produce exactly 0. q, out and
// the kv16 pools (or the hot pools) share one type T (bf16 or f32);
// scores, the softmax and the sums are f32.
//
// kv16: page j is page block_tables[b, j] of the pools (n_pages, ps, KV, d).
// Quantized: page j == n_full[b] is the frontier page, read at full
// precision from hot row hot_rows[b] of the hot pools (n_hot, ps, KV, d);
// every other page comes from the codes pool of page block_tables[b, j] and
// that page's codebooks, as the plain version reads them. In decode n_full =
// kv_len / ps; in packed prefill kv_len is the token's causal bound and
// n_full its segment's frontier, which is why the two are separate inputs.
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
// below the card's ratio. At decode sizes (a few MB) the real limit is
// latency: how many loads are in flight across the card.
//
// Both kernels run one split-KV walk ("flash-decoding"); they differ only
// in how a lane reads a token row (RowSlice): kernel B reads E values of T
// straight from the pools with 16-byte loads, kernel C dequantizes codes
// (and reads its frontier page from the hot pools). The walk:
//   * a row's walk starts on the page that holds kv_start (page-aligned
//     base = kv_start - kv_start % ps) and covers [base, kv_len): splits
//     are counted from base, so no split lies wholly before the window;
//     only the positions below kv_start on that first page are masked.
//     Without a window base = 0 and the walk is the one below, bit for bit;
//   * a split is a fixed run of pages_per_split pages of a row; grid
//     (B, H, n_splits) with n_splits = min(splits the block table's width
//     needs, SPLIT_BLOCKS): block z of a row serves one query head over
//     splits z, z + n_splits, ... of its row, in order. A row with at most
//     SPLIT_BLOCKS splits gets one split a block whatever the grid; a longer
//     row meets a grid of exactly SPLIT_BLOCKS. So the mapping depends on
//     the row's own length alone, and a row's bits never depend on the
//     other rows of the launch or on the table's width; the grid and the
//     scratch stay bounded however wide the table is. A block whose first
//     split starts at or past the row's ceil(kv_len / ps) pages returns at
//     once;
//   * no block barrier inside the page walk: each warp owns token rows of
//     the block's splits, LPR = d / E lanes per row, each lane E = 16
//     elements (32 at 4 bits when d % 32 == 0): kv16 values (two or four
//     16-byte loads), or one 16-byte vector of codes (8 bytes at d = 16,
//     4-bit) whose group's absmax or 8-entry codebook is one load per row,
//     dequantized in registers; dot products reduced by a fixed-order xor
//     shuffle, and every warp keeps its own online-softmax state and
//     accumulator;
//   * the warps merge once, in warp order, through shared memory, and the
//     block writes its partial (m, l, unnormalised acc) in f32;
//   * a second small kernel merges a row's partials by the log-sum-exp
//     rule in block order, normalises and writes out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

// Opts a kernel into more than 48 KB of dynamic shared memory when needed.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// ---------------------------------------------------------------------------
// The split-KV walk (kernels B and C) and the merge of its partials
// ---------------------------------------------------------------------------

constexpr int SPLIT_WARPS = 4;
constexpr int SPLIT_THREADS = 32 * SPLIT_WARPS;
constexpr int COMBINE_THREADS = 128;
constexpr int SPLIT_BLOCKS = 16;   // most blocks a row gets (grid z)

struct SplitArgs {
  const void* q;
  const uint8_t* k_pool;   // kv16: the K pool (n_pages, ps, KV, d) of T;
  const void* k_scales;    // quantized: codes and their scales
  const uint8_t* v_pool;
  const void* v_scales;
  const void* k_hot;       // quantized only: the hot pools and, per row,
  const void* v_hot;       // the frontier page and its hot row
  const int* block_tables;
  const int* kv_lens;
  const int* kv_start;     // (B,) first visible position of each row
  const int* n_full;
  const int* hot_rows;
  float* part_ml;   // (2, B, H, n_splits): running max, then sum
  float* part_acc;  // (B, H, n_splits, d): unnormalised accumulator
  void* out;
  int B, H, KV, d, ps, max_pages, tpb, nb, n_splits, pages_per_split;
  float scale, softcap;
};

// CB bytes of codes (16 or 8) at p, as 32-bit words.
template <int CB>
__device__ __forceinline__ void load_codes(const uint8_t* p, uint32_t* w) {
  if constexpr (CB == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  }
}

// Element e of a lane's int8 codes, as f32.
__device__ __forceinline__ float code8(const uint32_t* w, int e) {
  return (float)((int)(w[e >> 2] << (24 - 8 * (e & 3))) >> 24);
}

// Element e of a lane's 4-bit codes looked up in the 8-entry bf16 codebook
// cb (16 bytes, entry i in bytes 2i, 2i+1): +-codebook[level], exactly.
__device__ __forceinline__ float code4(const uint32_t* w, const uint32_t* cb, int e) {
  const uint32_t nib = (w[e >> 3] >> (4 * (e & 7))) & 0xFu;
  const uint32_t lv = nib & 3u;
  const uint32_t sel = (2u * lv) | ((2u * lv + 1u) << 4);
  const uint32_t lo = __byte_perm(cb[0], cb[1], sel);
  const uint32_t hi = __byte_perm(cb[2], cb[3], sel);
  const uint32_t bits = ((nib & 4u) ? hi : lo) & 0xFFFFu;
  return __uint_as_float((bits << 16) ^ ((nib & 8u) << 28));
}

// Element e of 32-bit words holding values of T (bf16 pairs or f32), as f32.
template <typename T>
__device__ __forceinline__ float value16(const uint32_t* w, int e) {
  if constexpr (sizeof(T) == 4) return __uint_as_float(w[e]);
  const uint32_t x = w[e >> 1];
  return __uint_as_float((e & 1) ? (x & 0xFFFF0000u) : (x << 16));
}

// 16 bytes of T at p (16-byte aligned) as 16 / sizeof(T) floats.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* f) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) f[i] = value16<T>(w, i);
}

// One lane's view of one token row: E values of T read straight from the
// pool (BITS == 16, kernel B), or E dequantized values (codes with the
// group's factor or codebook) or E full-precision values (hot row) (BITS
// 8 or 4, kernel C).
template <typename T, int BITS, int E>
struct RowSlice {
  static constexpr int CB = BITS == 16 ? E * (int)sizeof(T) : E * BITS / 8;  // bytes
  uint32_t w[CB / 4];
  uint32_t cb[4];    // 4-bit codebook (16 bytes)
  float factor;      // 8-bit absmax / 127
  const T* hot;      // non-null: read the hot row instead

  // kv16: E values of T at p (16-byte aligned), all loads issued here.
  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < CB / 16; ++i) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x; w[4 * i + 1] = v.y; w[4 * i + 2] = v.z; w[4 * i + 3] = v.w;
    }
  }

  __device__ __forceinline__ void load(const uint8_t* codes, const void* scales,
                                       size_t code_off, size_t srow, const T* hot_row) {
    hot = hot_row;
    if (hot_row) return;
    load_codes<CB>(codes + code_off, w);
    if constexpr (BITS == 8) {
      factor = __ldg(static_cast<const float*>(scales) + srow) / 127.f;
    } else {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(scales) + srow * 8));
      cb[0] = v.x; cb[1] = v.y; cb[2] = v.z; cb[3] = v.w;
    }
  }

  // Calls f(e, value) for e = 0 .. E-1 in order; value rounded to T.
  template <typename F>
  __device__ __forceinline__ void each(F f) const {
    if constexpr (BITS == 16) {
#pragma unroll
      for (int e = 0; e < E; ++e) f(e, value16<T>(w, e));
    } else if (hot) {
      constexpr int PE = 16 / sizeof(T);
#pragma unroll
      for (int p = 0; p < E / PE; ++p) {
        float v[PE];
        load16<T>(hot + p * PE, v);
#pragma unroll
        for (int i = 0; i < PE; ++i) f(p * PE + i, v[i]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float v = BITS == 8 ? code8(w, e) * factor : code4(w, cb, e);
        f(e, to_f<T>(from_f<T>(v)));
      }
    }
  }
};

// Blocks an SM must hold. Quantized: 6 at 16-element lanes (80 registers, a
// few bytes spilled), 4 at 32 (128). Left to itself ptxas takes 96 and 163,
// and at chip_smoke.py's decode shape (B=8, H=16, rows up to 2048 keys)
// the 768 busy blocks then need a second wave, which was slower (PERF.md).
// kv16 holds E values of T a row slice, four slices live (this pass and
// the next, K and V): 6 blocks at bf16, 4 at f32.
template <typename T, int BITS, int E>
constexpr int split_min_blocks() {
  if constexpr (BITS == 16) return sizeof(T) == 2 ? 6 : 4;
  return E == 16 ? 6 : 4;
}

// One block per (row b, query head hq, z): splits z, z + n_splits, ... of
// row b, each pages_per_split pages. BITS == 16 reads every page from the
// kv16 pools; BITS 8 or 4 reads page n_full[b] from the hot pools and every
// other page from the codes.
template <typename T, int BITS, int E>
__global__ void __launch_bounds__(SPLIT_THREADS, (split_min_blocks<T, BITS, E>()))
paged_attention_split_kernel(const SplitArgs a) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, hq = blockIdx.y, split = blockIdx.z;
  const int h = hq / (a.H / a.KV);
  const int kv_len = a.kv_lens[b];
  const int start = a.kv_start[b];
  const int base = start - start % a.ps;       // first position of the walk
  const int len = kv_len - base;               // positions the walk covers
  const int lo = start - base;                 // masked head of its first page
  const int ns = a.n_splits;
  const int span = a.pages_per_split * a.ps;   // tokens a split covers
  if (start >= kv_len || split * span >= len) return;   // nothing of the row here
  // this block's tokens, splits split, split + ns, ... back to back: local
  // token i lies at position base + (split + (i / span) * ns) * span + i %
  // span. Every local token below n_tok is a position below kv_len; those
  // below kv_start (local position < lo, split 0 only) are masked.
  const int own = (len + span - 1) / span;     // the row's splits
  const int n_mine = (own - split + ns - 1) / ns;
  const int n_tok = (n_mine - 1) * span + min(span, len - (split + (n_mine - 1) * ns) * span);
  const size_t pidx = ((size_t)b * a.H + hq) * ns + split;
  const int d = a.d;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lpr = d / E;               // lanes per token row: a power of two <= 32
  const int rpp = 32 / lpr;            // token rows per warp pass
  const int rg = lane / lpr, c0 = (lane - rg * lpr) * E;

  float qv[E], acc[E];
  const T* q = static_cast<const T*>(a.q) + ((size_t)b * a.H + hq) * d + c0;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qv[e] = to_f(q[e]);
    acc[e] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int* table = a.block_tables + (size_t)b * a.max_pages;
  int n_full = -1, hot = 0;
  if constexpr (BITS != 16) {
    n_full = a.n_full[b];
    hot = a.hot_rows[b];
  }
  const size_t code_row = (size_t)d * BITS / 8;
  const T* k_hot = static_cast<const T*>(a.k_hot);
  const T* v_hot = static_cast<const T*>(a.v_hot);

  // Loads of one pass: this lane's token row of K and V (kv16 values, or
  // codes and their group's factor or codebook, or the hot row). The next
  // pass's loads are issued before this pass computes, so two passes are
  // in flight. A lane's local token is tracked as (k, off) = (i / span,
  // i % span), stepped without a division.
  auto issue = [&](int k, int off, RowSlice<T, BITS, E>& kr, RowSlice<T, BITS, E>& vr) {
    if (k * span + off >= n_tok) return;
    const int pos = base + (split + k * ns) * span + off;
    const int j = pos / a.ps, t = pos - j * a.ps;
    if constexpr (BITS == 16) {
      const size_t at = (((size_t)table[j] * a.ps + t) * a.KV + h) * d + c0;
      kr.load(reinterpret_cast<const T*>(a.k_pool) + at);
      vr.load(reinterpret_cast<const T*>(a.v_pool) + at);
    } else if (j != n_full) {
      const int page = table[j];
      const size_t row = ((size_t)page * a.ps + t) * a.KV + h;
      const size_t srow = ((size_t)page * a.KV + h) * a.nb + t / a.tpb;
      const size_t at = row * code_row + (size_t)c0 * BITS / 8;
      kr.load(a.k_pool, a.k_scales, at, srow, nullptr);
      vr.load(a.v_pool, a.v_scales, at, srow, nullptr);
    } else {
      const size_t at = (((size_t)hot * a.ps + t) * a.KV + h) * d + c0;
      kr.load(nullptr, nullptr, 0, 0, k_hot + at);
      vr.load(nullptr, nullptr, 0, 0, v_hot + at);
    }
  };
  const int stride = SPLIT_WARPS * rpp;
  auto step = [&](int& k, int& off) {
    for (off += stride; off >= span; off -= span) ++k;
  };
  int k = 0, off = -stride + warp * rpp + rg;
  step(k, off);
  RowSlice<T, BITS, E> ks, vs, ks_next, vs_next;
  issue(k, off, ks, vs);
  for (int base = warp * rpp; base < n_tok; base += stride) {
    const bool valid = k * span + off < n_tok && (split + k * ns) * span + off >= lo;
    int k_next = k, off_next = off;
    step(k_next, off_next);
    issue(k_next, off_next, ks_next, vs_next);
    float s = 0.f;
    if (valid) ks.each([&](int e, float kv) { s = fmaf(qv[e], kv, s); });
    for (int o = lpr / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    float sv = s * a.scale;
    if (a.softcap > 0.f) sv = a.softcap * tanhf(sv / a.softcap);
    sv = valid ? sv : -INFINITY;
    float mx = sv;
    for (int o = lpr; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float corr = (m_new == m) ? 1.f : expf(m - m_new);
    const float p = valid ? expf(sv - m_new) : 0.f;
    float sum = p;
    for (int o = lpr; o < 32; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    l = l * corr + sum;
    m = m_new;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= corr;
    if (valid) vs.each([&](int e, float vv) { acc[e] = fmaf(p, vv, acc[e]); });
    ks = ks_next;
    vs = vs_next;
    k = k_next;
    off = off_next;
  }

  // sum the row groups of the warp, then merge the warps in warp order
  float* wacc = smem;                      // (warps, d)
  float* wm = wacc + SPLIT_WARPS * d;      // (warps,)
  float* wl = wm + SPLIT_WARPS;            // (warps,)
#pragma unroll
  for (int e = 0; e < E; ++e)
    for (int o = lpr; o < 32; o <<= 1) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  if (rg == 0) {
#pragma unroll
    for (int e = 0; e < E; ++e) wacc[warp * d + c0 + e] = acc[e];
  }
  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
  __syncthreads();
  float mb = -INFINITY;
  for (int w = 0; w < SPLIT_WARPS; ++w) mb = fmaxf(mb, wm[w]);
  for (int c = threadIdx.x; c < d; c += SPLIT_THREADS) {
    float sa = 0.f, sl = 0.f;
    for (int w = 0; w < SPLIT_WARPS; ++w) {
      const float f = (wm[w] == -INFINITY) ? 0.f : expf(wm[w] - mb);
      sa = fmaf(f, wacc[w * d + c], sa);
      sl = fmaf(f, wl[w], sl);
    }
    a.part_acc[pidx * d + c] = sa;
    if (c == 0) {
      a.part_ml[pidx] = mb;
      a.part_ml[(size_t)a.B * a.H * ns + pidx] = sl;
    }
  }
}

// Merges row b's partials for query head hq in block order (log-sum-exp),
// normalises and writes out. Only the blocks that held pages of the row
// are read (counted from the walk's base, as the walk counts them: every
// one of them saw a visible position, so no partial max is -inf); their
// factors exp(m_z - max m) are computed once, in shared memory.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
paged_attention_combine_kernel(const SplitArgs a) {
  extern __shared__ float fs[];   // (n_splits,) factors
  __shared__ float l_tot;
  const int b = blockIdx.x, hq = blockIdx.y;
  const int kv_len = a.kv_lens[b];
  const int start = a.kv_start[b];
  const int len = kv_len - (start - start % a.ps);
  const int span = a.pages_per_split * a.ps;
  const int n_own = start >= kv_len ? 0 : min((len + span - 1) / span, a.n_splits);
  const size_t base = ((size_t)b * a.H + hq) * a.n_splits;
  const float* part_m = a.part_ml + base;
  const float* part_l = a.part_ml + (size_t)a.B * a.H * a.n_splits + base;
  for (int s = threadIdx.x; s < n_own; s += COMBINE_THREADS) fs[s] = part_m[s];
  __syncthreads();
  if (threadIdx.x == 0) {
    float mt = -INFINITY;
    for (int s = 0; s < n_own; ++s) mt = fmaxf(mt, fs[s]);
    float l = 0.f;
    for (int s = 0; s < n_own; ++s) {
      fs[s] = expf(fs[s] - mt);
      l = fmaf(fs[s], part_l[s], l);
    }
    l_tot = l;
  }
  __syncthreads();
  const float l = fmaxf(l_tot, 1e-30f);
  const float* acc_p = a.part_acc + base * a.d;
  T* out = static_cast<T*>(a.out) + ((size_t)b * a.H + hq) * a.d;
  for (int c = threadIdx.x; c < a.d; c += COMBINE_THREADS) {
    float acc = 0.f;
    for (int s = 0; s < n_own; ++s) acc = fmaf(fs[s], acc_p[(size_t)s * a.d + c], acc);
    out[c] = from_f<T>(n_own > 0 ? acc / l : 0.f);
  }
}

template <typename T, int BITS, int E>
int launch_split(const SplitArgs& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * SPLIT_WARPS * ((size_t)a.d + 2);
  cudaError_t e = allow_smem(paged_attention_split_kernel<T, BITS, E>, smem);
  if (e != cudaSuccess) return (int)e;
  paged_attention_split_kernel<T, BITS, E>
      <<<dim3(a.B, a.H, a.n_splits), SPLIT_THREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t csmem = sizeof(float) * a.n_splits;
  e = allow_smem(paged_attention_combine_kernel<T>, csmem);
  if (e != cudaSuccess) return (int)e;
  paged_attention_combine_kernel<T>
      <<<dim3(a.B, a.H), COMBINE_THREADS, csmem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bits(const SplitArgs& a, int bits, cudaStream_t stream) {
  if (bits == 16) return launch_split<T, 16, 16>(a, stream);
  if (bits == 8) return launch_split<T, 8, 16>(a, stream);
  if (a.d % 32 == 0) return launch_split<T, 4, 32>(a, stream);
  return launch_split<T, 4, 16>(a, stream);
}

// Checks what both entry points take, then launches. E = 32 at 4 bits when
// d % 32 == 0, else 16: d / E lanes a token row must be a power of two
// <= 32, so d is a power of two in [16, 512] ([16, 1024] at 4 bits).
int run(const SplitArgs& a, int bits, int is_bf16, void* stream) {
  const int e = (bits == 4 && a.d % 32 == 0) ? 32 : 16;
  const int lpr = a.d / e;
  if ((bits != 16 && bits != 8 && bits != 4) || a.d % e || lpr > 32 || (lpr & (lpr - 1)) ||
      a.KV <= 0 || a.H % a.KV || a.pages_per_split <= 0 || a.n_splits < 1 ||
      a.n_splits > SPLIT_BLOCKS ||
      (a.n_splits < SPLIT_BLOCKS && a.n_splits * a.pages_per_split < a.max_pages))
    return (int)cudaErrorInvalidValue;
  if (a.B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_bits<__nv_bfloat16>(a, bits, s) : launch_bits<float>(a, bits, s);
}

}  // namespace

// Plain C entry points (bound with ctypes). They return a CUDA error code
// (0 = ok). The caller has checked shapes, types and contiguity, that the
// pools are 16-byte aligned, and allocated out (B, H, d) and the f32
// scratch part_ml (2, B, H, n_splits) and part_acc (B, H, n_splits, d), with
// n_splits = min(ceil(max_pages / pages_per_split), SPLIT_BLOCKS), at least
// 1. d must be a power of two in [16, 512] ([16, 1024] at 4 bits);
// anything else returns cudaErrorInvalidValue.

// Kernel B: kv16 pools (n_pages, ps, KV, d) in q's type. kv_start (B,):
// each row's first visible position (0 without a window).
extern "C" int paged_attention_decode(const void* q, const void* k_pool,
                                      const void* v_pool, const void* block_tables,
                                      const void* kv_lens, const void* kv_start,
                                      void* part_ml, void* part_acc,
                                      void* out, int B, int H, int KV, int d, int ps,
                                      int max_pages, int n_splits, int pages_per_split,
                                      float scale, float softcap, int is_bf16,
                                      void* stream) {
  const SplitArgs a{q,
                    static_cast<const uint8_t*>(k_pool),
                    nullptr,
                    static_cast<const uint8_t*>(v_pool),
                    nullptr,
                    nullptr,
                    nullptr,
                    static_cast<const int*>(block_tables),
                    static_cast<const int*>(kv_lens),
                    static_cast<const int*>(kv_start),
                    nullptr,
                    nullptr,
                    static_cast<float*>(part_ml),
                    static_cast<float*>(part_acc),
                    out,
                    B, H, KV, d, ps, max_pages, 1, 1, n_splits, pages_per_split,
                    scale, softcap};
  return run(a, 16, is_bf16, stream);
}

// Kernel C. bits is 8 or 4; tpb and nb are the pools' token rows per
// codebook group and groups per page.
extern "C" int paged_attention_decode_quant(
    const void* q, const void* k_codes, const void* k_scales, const void* v_codes,
    const void* v_scales, const void* k_hot, const void* v_hot, const void* block_tables,
    const void* kv_lens, const void* kv_start, const void* n_full, const void* hot_rows,
    void* part_ml,
    void* part_acc, void* out, int B, int H, int KV, int d, int ps, int max_pages,
    int tpb, int nb, int n_splits, int pages_per_split, float scale, float softcap,
    int bits, int is_bf16, void* stream) {
  if (bits != 8 && bits != 4) return (int)cudaErrorInvalidValue;
  const SplitArgs a{q,
                    static_cast<const uint8_t*>(k_codes),
                    k_scales,
                    static_cast<const uint8_t*>(v_codes),
                    v_scales,
                    k_hot,
                    v_hot,
                    static_cast<const int*>(block_tables),
                    static_cast<const int*>(kv_lens),
                    static_cast<const int*>(kv_start),
                    static_cast<const int*>(n_full),
                    static_cast<const int*>(hot_rows),
                    static_cast<float*>(part_ml),
                    static_cast<float*>(part_acc),
                    out,
                    B, H, KV, d, ps, max_pages, tpb, nb, n_splits, pages_per_split,
                    scale, softcap};
  return run(a, bits, is_bf16, stream);
}
