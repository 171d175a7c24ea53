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
// Each weight is +-codebook[level] rounded to x's type, as msb_matmul_ref
// rounds it; products are summed in f32.
//
// What bounds it on the card. Decode shapes (M <= 8) stream the weights:
// 0.5 B/weight of codes plus 0.5 B/weight of f32 codebooks, so the bound is
//   (K*N/2 + K*N/64*8*4) B / 3.35 TB/s
// (2048 x 8192: 16.8 MB -> 5.0 us). Prefill shapes (M = 4096) are bound by
// the products: 2*M*K*N flops on the bf16 tensor cores (989 TFLOP/s dense;
// 4096 x 2048 x 8192: 0.139 ms).
//
// bf16 x: one tensor-core kernel for every M (mma.sync.m16n8k16, bf16 in,
// f32 accumulate). Tiles (BM x BN, warps) depend on M (Tile below):
//   * a ring of STAGES cp.async stages holds, per K step of 64 (one MSB
//     block), the x tile (BM x 64 bf16, rows past M zero-filled), the packed
//     bytes (64 x BN/2) and the step's codebooks (BN * 8 f32);
//   * the block decodes a landed stage into a bf16 W tile (64 x BN) in
//     shared memory, double-buffered: step i + 1 is decoded right after
//     step i's products are issued, while the tensor cores run them, and
//     one barrier a step suffices. n-blocked:
//     a thread decodes 32 columns of one k row, which share one codebook:
//     its 8 entries rounded to bf16 are split into high and low bytes, and
//     four weights at a time take their bytes with one prmt each, the sign
//     flipped from the nibble by a third (2 instructions a weight).
//     k-blocked (off the main path: a codebook per column) looks each
//     weight up one by one;
//   * the warps read x with ldmatrix and W with ldmatrix.trans (W's storage
//     pairs neighbouring columns, the B fragment neighbouring k, so the
//     transpose is done by the load).
// Rows independent of M: every output element is summed from its own row
// and column; the K split count depends on (K, N) only (ops.k_splits) and
// each split's k16 steps run in ascending order into a zeroed accumulator.
// The splits are added in ascending order to a running f32 total starting
// from 0, then the bias: inside the block at large M (one block walks all
// of K; no scratch), or by split_reduce_kernel at small M, where the
// splits run on separate blocks to spread the weight stream over the SMs.
// Both orders are the same f32 additions, so a row's bits depend on (K, N)
// and the row alone, whatever M and the tile.
//
// Expert batch (msb_matmul_experts, the MoE FFN): E independent products
// x[e] (M, K) @ dequant(W[e]) (K, N) in one launch. An expert whose
// routed-token count counts[e] (int32 on the device) is 0 reads no weight
// and no x and writes zeros: the reference's lax.cond zero branch, with no
// host sync, so a CUDA graph can capture it. Every other expert's rows are
// bit for bit those of msb_matmul on the expert alone: the same K plan,
// the same mma.sync steps into zeroed per-split sums, the same ascending
// additions of the splits. bf16 x at M <= 128 (decode steps, packed-prefill
// waves: msb_experts_kernel):
//   * what bounds it: the routed experts' weights, 1 B a weight, once; x
//     and the output are smaller at these M (granite-moe's 512-token wave:
//     31 MB of weights, 14 of x). Tiled as msb_matmul's 16-row tiles, a
//     wave re-streamed each expert's weights and re-decoded them once per
//     16 rows; its splits went through an f32 (E, splits, M, N) scratch in
//     device memory and a second launch;
//   * one block holds all M rows of an expert (up to 8 m16 fragments,
//     warps over rows and columns), so a step's weights are loaded and
//     decoded once for every row;
//   * the K splits of one item (an expert's N tile) run as the blocks of
//     one thread block cluster (at most 8; past 8 splits a block walks
//     several in a row and keeps each sum apart). Each leaves its f32 sums
//     in shared memory; after cluster.sync() every block adds a share of
//     the tile over all splits through distributed shared memory, in
//     ascending split order from 0, and writes bf16: no scratch, no second
//     launch;
//   * what bounds it in practice is a block's fixed cost (filling its
//     ring, the cluster's barrier and reduction), not the decode or the
//     products: at up to 64 rows as many clusters as the card holds each
//     take routed items in turn, the ring running on into the next item
//     while the last one is reduced; at 128 rows (a wave) two sets of
//     sum tiles do not fit beside the ring, so each cluster takes one
//     item and its last sums lie over the drained ring. A thread's copies
//     advance by fixed strides a step (StepCopies), and an N tile of 128
//     columns reads 64 contiguous bytes a row of codes and codebooks.
// f32 x, and M > 128 (LargeTile walks all of K in a block), run
// msb_matmul's kernels with the experts on the grid's z axis.
//
// f32 x (f32 projections): SIMT f32 FMA (TF32 would miss the 1e-5
// tolerance): each 256-thread block owns a BM x 64 tile and one K split,
// stages the packed bytes and a 64 x 8 f32 codebook table a step, decodes
// them into an f32 tile and runs 64 FMAs a thread; splits summed by
// split_reduce_kernel in ascending order.
//
// The unembedding (msb_unembed, below) has a kernel of its own: it streams
// the table's weights into registers and reads both of its layouts, the
// untied k-blocked table and a tied n-blocked table as its transpose.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

typedef __nv_bfloat16 bf16;

constexpr int BK = 64;       // K step == MSB block
constexpr int LEVELS = 8;
constexpr size_t SMEM_LIMIT = 232448;   // shared bytes a block may opt into

// Expert e of a batch (blockIdx.z = e * zs + split): moves the operands'
// pointers to its slices and returns the split index within the expert.
// counts == nullptr: one product, e = 0. (Templated on the pointer types
// so that __restrict__ parameters bind as they are.)
template <typename X, typename PK, typename SC, typename O, typename PA>
__device__ __forceinline__ int expert_slice(X& x, PK& packed, SC& scales, O& out,
                                            PA& partial, int zs, int M, int K, int N,
                                            int& e) {
  e = blockIdx.z / zs;
  if (e > 0) {
    x += (size_t)e * M * K;
    packed += (size_t)e * K * (N / 2);
    scales += (size_t)e * K * (N / 8);   // K * N/64 * 8 == K/64 * N * 8
    out += (size_t)e * M * N;
    if (partial != nullptr) partial += (size_t)e * zs * M * N;
  }
  return blockIdx.z - e * zs;
}

// Zeros the block's BM x BN tile of out (an expert with no routed token).
template <int BM, int BN, typename O>
__device__ __forceinline__ void zero_tile(O* out, int m0, int n0, int M, int N) {
  for (int i = threadIdx.x; i < BM * BN; i += blockDim.x) {
    const int m = m0 + i / BN, n = n0 + i % BN;
    if (m >= M || n >= N) continue;
    if constexpr (sizeof(O) == 4) out[(size_t)m * N + n] = 0.f;
    else out[(size_t)m * N + n] = __float2bfloat16(0.f);
  }
}

// ---------------------------------------------------------------------------
// f32 x: SIMT kernel
// ---------------------------------------------------------------------------

constexpr int SIMT_BN = 64;
constexpr int SIMT_THREADS = 256;

// grid: (N / 64, ceil(M / BM), E * splits), zs = splits (expert_slice).
// partial == nullptr: write y (+bias) to out; else write the split's f32
// sum to partial[split, m, n] of the expert's slice.
template <int BM, bool KBLOCKED>
__global__ void __launch_bounds__(SIMT_THREADS)
msb_matmul_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                      const float* __restrict__ scales, const float* __restrict__ bias,
                      float* __restrict__ out, float* __restrict__ partial,
                      const int* __restrict__ counts, int zs, int M, int K, int N,
                      int k_per_split) {
  __shared__ float xs[BM][BK];
  __shared__ float ws[BK][SIMT_BN];
  __shared__ float cb[BK][LEVELS];
  __shared__ __align__(16) uint8_t pk[BK][SIMT_BN / 2];

  constexpr int RPT = BM / (SIMT_THREADS / SIMT_BN);   // output rows per thread
  const int n0 = blockIdx.x * SIMT_BN;
  const int m0 = blockIdx.y * BM;
  int e;
  const int z = expert_slice(x, packed, scales, out, partial, zs, M, K, N, e);
  if (counts != nullptr && counts[e] == 0) {   // the reduce zeros split sums
    if (partial == nullptr) zero_tile<BM, SIMT_BN>(out, m0, n0, M, N);
    return;
  }
  const int k_begin = z * k_per_split;
  const int k_end = k_begin + k_per_split;
  const int tid = threadIdx.x;
  const int col = tid % SIMT_BN;
  const int rgrp = tid / SIMT_BN;
  const int half = N / 2;

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int i = tid; i < BM * BK; i += SIMT_THREADS) {
      const int r = i / BK, kk = i % BK;
      const int m = m0 + r;
      xs[r][kk] = (m < M) ? x[(size_t)m * K + k0 + kk] : 0.f;
    }
    {  // 64 rows x 32 bytes: 8 bytes per thread
      const int r = tid / 4, c8 = (tid % 4) * 8;
      *reinterpret_cast<uint2*>(&pk[r][c8]) = *reinterpret_cast<const uint2*>(
          packed + (size_t)(k0 + r) * half + n0 / 2 + c8);
    }
    for (int i = tid; i < BK * LEVELS; i += SIMT_THREADS) {
      const int r = i / LEVELS, z = i % LEVELS;
      const size_t off =
          KBLOCKED ? ((size_t)(k0 / BK) * N + n0 + r) * LEVELS + z
                   : ((size_t)(k0 + r) * (N / SIMT_BN) + n0 / SIMT_BN) * LEVELS + z;
      cb[r][z] = scales[off];
    }
    __syncthreads();
    for (int i = tid; i < BK * SIMT_BN; i += SIMT_THREADS) {
      const int kk = i / SIMT_BN, nn = i % SIMT_BN;
      const uint8_t byte = pk[kk][nn / 2];
      const int nib = (nn & 1) ? (byte >> 4) : (byte & 0xF);
      const float mag = KBLOCKED ? cb[nn][nib & 7] : cb[kk][nib & 7];
      ws[kk][nn] = (nib & 8) ? -mag : mag;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float w = ws[kk][col];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        acc[i] = fmaf(xs[rgrp + i * (SIMT_THREADS / SIMT_BN)][kk], w, acc[i]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + rgrp + i * (SIMT_THREADS / SIMT_BN);
    if (m >= M) continue;
    const int n = n0 + col;
    if (partial != nullptr) {
      partial[((size_t)z * M + m) * N + n] = acc[i];
    } else {
      const float b = bias != nullptr ? bias[n] : 0.f;
      out[(size_t)m * N + n] = acc[i] + b;
    }
  }
}

// out[e, m, n] = sum over expert e's splits in ascending order from 0 (+
// bias), cast to T; 0 where counts[e] == 0. partial is (E, splits, M, N).
template <typename T>
__global__ void split_reduce_kernel(const float* __restrict__ partial,
                                    const float* __restrict__ bias,
                                    const int* __restrict__ counts,
                                    T* __restrict__ out, int E, int M, int N, int splits) {
  const size_t mn = (size_t)M * N, total = (size_t)E * mn;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i / mn, r = i - e * mn;
    float v = 0.f;
    if (counts == nullptr || counts[e] != 0) {
      for (int s = 0; s < splits; ++s) v += partial[(e * splits + s) * mn + r];
      if (bias != nullptr) v += bias[r % N];
    }
    if constexpr (sizeof(T) == 4) out[i] = v;
    else out[i] = __float2bfloat16(v);
  }
}

template <typename T>
void launch_reduce(const float* partial, const float* bias, const int* counts, T* out,
                   int E, int M, int N, int splits, cudaStream_t stream) {
  const size_t total = (size_t)E * M * N;
  int blocks = (int)((total + 255) / 256);
  if (blocks > 4096) blocks = 4096;
  split_reduce_kernel<T><<<blocks, 256, 0, stream>>>(partial, bias, counts, out, E, M, N,
                                                     splits);
}

template <int BM, bool KB>
int launch_f32(const float* x, const uint8_t* packed, const float* scales,
               const float* bias, const int* counts, float* out, float* partial, int E,
               int M, int K, int N, int splits, cudaStream_t stream) {
  dim3 grid(N / SIMT_BN, (M + BM - 1) / BM, E * splits);
  float* part = splits > 1 ? partial : nullptr;
  msb_matmul_f32_kernel<BM, KB><<<grid, SIMT_THREADS, 0, stream>>>(
      x, packed, scales, bias, out, part, counts, splits, M, K, N, K / splits);
  if (splits > 1) {
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    launch_reduce<float>(part, bias, counts, out, E, M, N, splits, stream);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 x: tensor-core kernel
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_, int STAGES_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;   // a warp's tile
  static constexpr int MT = WTM / 16, NT = WTN / 8;               // its mma tiles
  static constexpr int LDX = BK + 8;    // bf16 row stride of the x tile
  static constexpr int LDW = BN + 8;    // bf16 row stride of the W tile
  static constexpr int X_BYTES = BM * LDX * 2;
  static constexpr int PK_BYTES = BK * BN / 2;
  static constexpr int CB_BYTES = BN * LEVELS * 4;   // BK x BN/64 or BN codebooks
  static constexpr int STAGE_BYTES = X_BYTES + PK_BYTES + CB_BYTES;
  static constexpr int W_BYTES = BK * LDW * 2;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * W_BYTES;
  static constexpr int LDS = BN + 8;    // f32 row stride of a split's sum tile
  static constexpr int SUM_BYTES = BM * LDS * 4;
  static constexpr int WPT = BK * BN / 8 / THREADS;   // packed words a thread decodes
  static constexpr int TPR = BN / 8 / WPT;             // decoding threads per k row
  static_assert(BK * TPR == THREADS && (WPT == 2 || WPT == 4) && 64 % (8 * WPT) == 0,
                "one slice of a k row, inside one 64-column codebook, per thread");
  static_assert(MT >= 1 && NT % 2 == 0, "warp tile of m16 x (2 n8) tiles");
};
// M <= 128: 16-row blocks, K splits on separate blocks (decode)
using SmallTile = Tile<16, 64, 1, 4, 5, 4>;
// M > 128: one block walks all of K, 16 warps of 32 x 32 (about 128
// registers with the running total); 8 warps of 64 x 32 (218 registers,
// one block an SM) were slower, and a 64 x 128 tile was no faster summed
// over a layer's projections at M = 256 to 2048.
using LargeTile = Tile<128, 128, 4, 4, 3, 1>;
// The expert batch at M <= 128 (msb_experts_kernel): one block holds all
// the rows of an expert, so its tile is chosen by M (ops.EXPERT_TILES):
// 16 rows x 128 columns on 8 warps, 32 and 64 rows x 64 columns on 4
// warps, 128 rows on 8 warps of 32 x 64 (32 x 32 where N is not a multiple
// of 128 or the split sums would not fit); 2-3 blocks an SM. At 16 rows,
// 64 columns on 4 warps (4 blocks an SM) were slower
// (chip_experts_variants.py).
template <class TL, bool PERSIST_>
struct ExpertTile : TL {
  static constexpr bool PERSIST = PERSIST_;   // clusters persist over items
};
using ExpertTile16 = ExpertTile<Tile<16, 128, 1, 8, 4, 2>, true>;
using ExpertTile32 = ExpertTile<Tile<32, 64, 2, 2, 4, 3>, true>;
using ExpertTile64 = ExpertTile<Tile<64, 64, 2, 2, 4, 2>, true>;
using ExpertTile128 = ExpertTile<Tile<128, 128, 4, 2, 3, 2>, false>;
using ExpertTile128N = ExpertTile<Tile<128, 64, 4, 2, 3, 2>, false>;

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

// c (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col). Not
// volatile: registers only, so the compiler may interleave the products
// with the decode's integer work.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// PTX prmt in its generic mode: byte n of the result is byte s[4n+2:4n] of
// {b, a} (a = bytes 0-3), or that byte's sign replicated when s[4n+3] is set.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// An 8-entry f32 codebook rounded to bf16, as its high bytes (hi[0..1]) and
// low bytes (lo[0..1]), entry i in byte i of each pair.
struct Codebook {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ explicit Codebook(const float* c) {
    const float4 a = *reinterpret_cast<const float4*>(c);
    const float4 b = *reinterpret_cast<const float4*>(c + 4);
    const uint32_t e01 = pack_bf16(a.x, a.y), e23 = pack_bf16(a.z, a.w);
    const uint32_t e45 = pack_bf16(b.x, b.y), e67 = pack_bf16(b.z, b.w);
    hi[0] = prmt(e01, e23, 0x7531);
    hi[1] = prmt(e45, e67, 0x7531);
    lo[0] = prmt(e01, e23, 0x6420);
    lo[1] = prmt(e45, e67, 0x6420);
  }

  // The 8 weights of one packed word (nibble i = column i) as 4 bf16 pairs
  // (columns 2j, 2j + 1 in out[j]): +-codebook[level], the sign flipped on
  // the rounded value, exactly as rounding -codebook[level] gives.
  __device__ __forceinline__ void decode(uint32_t w, uint32_t* out) const {
    const uint32_t lv = w & 0x77777777u;   // levels: prmt selectors, copy mode
    const uint32_t w4 = w << 4;            // even columns' signs at byte msbs
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const uint32_t sel = half ? lv >> 16 : lv;
      const uint32_t h = prmt(hi[0], hi[1], sel);
      const uint32_t l = prmt(lo[0], lo[1], sel);
      // 0xff in byte i where column 4 * half + i is negative
      const uint32_t sg = prmt(w4, w, half ? 0xFBEAu : 0xD9C8u);
      const uint32_t hs = h ^ (sg & 0x80808080u);
      out[2 * half] = prmt(l, hs, 0x5140);
      out[2 * half + 1] = prmt(l, hs, 0x7362);
    }
  }
};

// Weight of nibble `nib` with the f32 codebook c, rounded to bf16 bits.
__device__ __forceinline__ uint32_t weight_bits(const float* c, uint32_t nib) {
  const bf16 v = __float2bfloat16(c[nib & 7]);
  return (uint32_t)(*reinterpret_cast<const unsigned short*>(&v)) ^ ((nib & 8u) << 12);
}

// The pieces of a bf16 tile's K step (TL: tile, KBLOCKED: scales layout),
// on the shared memory of one block: a ring of STAGES stages, each the x
// tile (BM x 64 bf16, rows past M zero-filled), the packed bytes (64 x
// BN/2) and codebooks of one 64-row K step, then two decoded bf16 W tiles.
template <class TL, bool KBLOCKED>
struct TileSteps {
  static constexpr int BM = TL::BM, BN = TL::BN, MT = TL::MT, NT = TL::NT;
  static constexpr int LDX = TL::LDX, LDW = TL::LDW, STAGES = TL::STAGES;
  unsigned char* smem;
  int tid, wm, wn, lane;

  __device__ __forceinline__ explicit TileSteps(unsigned char* s) : smem(s) {
    tid = threadIdx.x;
    lane = tid % 32;
    wm = (tid / 32) / TL::WARPS_N;
    wn = (tid / 32) % TL::WARPS_N;
  }
  __device__ __forceinline__ bf16* xs_of(int s) const {
    return reinterpret_cast<bf16*>(smem + s * TL::STAGE_BYTES);
  }
  __device__ __forceinline__ unsigned char* pk_of(int s) const {
    return smem + s * TL::STAGE_BYTES + TL::X_BYTES;
  }
  __device__ __forceinline__ float* cb_of(int s) const {
    return reinterpret_cast<float*>(smem + s * TL::STAGE_BYTES + TL::X_BYTES + TL::PK_BYTES);
  }
  __device__ __forceinline__ bf16* ws_of(int b) const {
    return reinterpret_cast<bf16*>(smem + STAGES * TL::STAGE_BYTES + b * TL::W_BYTES);
  }

  // The K step at k0 of x rows m0.. and W columns n0.. -> stage s (the
  // copies only; the caller commits).
  __device__ __forceinline__ void load(int s, const bf16* __restrict__ x,
                                       const uint8_t* __restrict__ packed,
                                       const float* __restrict__ scales, int m0, int n0, int M,
                                       int K, int N, int k0) const {
    const uint32_t xs = smem_u32(xs_of(s)), pk = smem_u32(pk_of(s));
    const uint32_t cb = smem_u32(cb_of(s));
    for (int c = tid; c < BM * 8; c += TL::THREADS) {
      const int r = c / 8, j = c % 8;
      const bool in = m0 + r < M;
      cp_async16(xs + (r * LDX + j * 8) * 2, in ? x + (size_t)(m0 + r) * K + k0 + j * 8 : x,
                 in);
    }
    for (int c = tid; c < BK * BN / 32; c += TL::THREADS) {
      const int r = c / (BN / 32), j = c % (BN / 32);
      const bool in = n0 + j * 32 < N;
      cp_async16(pk + c * 16, in ? packed + (size_t)(k0 + r) * (N / 2) + n0 / 2 + j * 16
                                 : packed, in);
    }
    for (int c = tid; c < BN * LEVELS / 4; c += TL::THREADS) {
      const float* src;
      bool in;
      if constexpr (KBLOCKED) {   // BN codebooks of this 64-k block
        const int col = c / 2;
        in = n0 + col < N;
        src = scales + ((size_t)(k0 / BK) * N + n0 + col) * LEVELS + (c % 2) * 4;
      } else {                    // BK rows x BN / 64 codebooks
        const int r = c / (BN / 32), j = c % (BN / 32);
        in = n0 + (j / 2) * 64 < N;
        src = scales + ((size_t)(k0 + r) * (N / 64) + n0 / 64 + j / 2) * LEVELS + (j % 2) * 4;
      }
      cp_async16(cb + c * 16, in ? src : scales, in);
    }
  }

  // Stage s -> W tile b: thread tid decodes the WPT packed words (8
  // columns each) from column c0 of k row r.
  __device__ __forceinline__ void decode(int s, int b) const {
    constexpr int WPT = TL::WPT;
    const int r = tid / TL::TPR, c0 = (tid % TL::TPR) * WPT * 8;
    uint32_t words[WPT];
    const uint8_t* src = pk_of(s) + r * (BN / 2) + c0 / 2;
    if constexpr (WPT == 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(src);
      words[0] = v.x; words[1] = v.y; words[2] = v.z; words[3] = v.w;
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(src);
      words[0] = v.x; words[1] = v.y;
    }
    bf16* dst = ws_of(b) + r * LDW + c0;
    if constexpr (!KBLOCKED) {
      const Codebook cb(cb_of(s) + (r * (BN / 64) + c0 / 64) * LEVELS);
#pragma unroll
      for (int j = 0; j < WPT; ++j) {
        uint32_t o[4];
        cb.decode(words[j], o);
        *reinterpret_cast<uint4*>(dst + j * 8) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    } else {
      const float* cbs = cb_of(s) + c0 * LEVELS;   // column c0 + c at c * 8
#pragma unroll
      for (int j = 0; j < WPT; ++j) {
        uint32_t o[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const int c = j * 8 + 2 * p;
          const uint32_t n_lo = (words[j] >> (8 * p)) & 0xFu;
          const uint32_t n_hi = (words[j] >> (8 * p + 4)) & 0xFu;
          o[p] = weight_bits(cbs + c * LEVELS, n_lo) |
                 (weight_bits(cbs + (c + 1) * LEVELS, n_hi) << 16);
        }
        *reinterpret_cast<uint4*>(dst + j * 8) = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }

  // acc += stage s's x tile times W tile b: the step's four k16 products in
  // ascending order. ldmatrix lanes: x rows (lane & 15), k offset (lane >>
  // 4) * 8; W (trans) k rows (lane & 7) + ((lane >> 3) & 1) * 8, columns
  // (lane >> 4) * 8.
  __device__ __forceinline__ void mma(int s, int b, float (&acc)[MT][NT][4]) const {
    const int x_row = wm * TL::WTM + (lane & 15), x_col = (lane >> 4) * 8;
    const int w_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int w_col = wn * TL::WTN + (lane >> 4) * 8;
    const bf16* xs = xs_of(s);
    const bf16* wt = ws_of(b);
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        ldsm_x4(af[mt], smem_u32(xs + (x_row + mt * 16) * LDX + kc * 16 + x_col));
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        ldsm_x4_trans(r, smem_u32(wt + (kc * 16 + w_row) * LDW + w_col + np * 16));
        bfr[2 * np][0] = r[0];
        bfr[2 * np][1] = r[1];
        bfr[2 * np + 1][0] = r[2];
        bfr[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt][0], bfr[nt][1]);
    }
  }
};

// The K loop of a bf16 tile (TL) at rows m0.. and columns n0.. of one
// product: n_steps steps of 64 from k_begin, each split of split_steps
// steps summed in ascending k16 order into acc (zeroed by the caller). At
// each split's end, after the next step's weights are decoded, split_end(j)
// (j the split's index from 0) takes acc and leaves it zeroed. Returns once
// every copy has landed; a caller that reuses the ring syncs first.
template <class TL, bool KBLOCKED, class SplitEnd>
__device__ __forceinline__ void tile_k_loop(unsigned char* smem, const bf16* __restrict__ x,
                                            const uint8_t* __restrict__ packed,
                                            const float* __restrict__ scales, int m0, int n0,
                                            int M, int K, int N, int k_begin, int n_steps,
                                            int split_steps, float (&acc)[TL::MT][TL::NT][4],
                                            SplitEnd&& split_end) {
  constexpr int STAGES = TL::STAGES;
  const TileSteps<TL, KBLOCKED> st(smem);
  // step i -> stage i % STAGES, one commit group (empty past the last step,
  // so the group count stays fixed)
  auto load = [&](int i) {
    if (i < n_steps) st.load(i % STAGES, x, packed, scales, m0, n0, M, K, N, k_begin + i * BK);
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  cp_async_wait<STAGES - 2>();   // step 0 has landed
  __syncthreads();
  st.decode(0, 0);

  for (int i = 0; i < n_steps; ++i) {
    cp_async_wait<STAGES - 3>();   // step i + 1 has landed
    __syncthreads();               // W tile i visible; step i - 1 done by all
    load(i + STAGES - 1);
    st.mma(i % STAGES, i & 1, acc);
    // step i + 1's weights, after step i's products are issued (faster
    // than decoding first: the integer work fills the tensor cores' wait)
    if (i + 1 < n_steps) st.decode((i + 1) % STAGES, (i + 1) & 1);
    if ((i + 1) % split_steps == 0) split_end((i + 1) / split_steps - 1);
  }
  cp_async_wait<0>();
}

// grid: (ceil(N / BN), ceil(M / BM), E * (splits on separate blocks or
// 1)), zs the second factor (expert_slice), per expert:
// partial != nullptr: block z sums split z alone and writes it to
// partial[z, m, n]. Else the block walks all of K, adds each split's sum to
// its running total at the split's end, and writes bf16(total + bias).
template <class TL, bool KBLOCKED>
__global__ void __launch_bounds__(TL::THREADS, TL::MIN_BLOCKS)
msb_matmul_tc_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
                     const float* __restrict__ scales, const float* __restrict__ bias,
                     bf16* __restrict__ out, float* __restrict__ partial,
                     const int* __restrict__ counts, int zs, int M, int K, int N,
                     int k_per_split) {
  constexpr int BM = TL::BM, BN = TL::BN, MT = TL::MT, NT = TL::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  int e;
  const int z = expert_slice(x, packed, scales, out, partial, zs, M, K, N, e);
  if (counts != nullptr && counts[e] == 0) {   // the reduce zeros split sums
    if (partial == nullptr) zero_tile<BM, BN>(out, m0, n0, M, N);
    return;
  }
  const int k_begin = z * k_per_split;
  const int n_steps = ((partial != nullptr) ? k_per_split : K) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int g = lane >> 2, tq = lane & 3;

  float acc[MT][NT][4], total[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = total[i][j][e] = 0.f;

  tile_k_loop<TL, KBLOCKED>(smem, x, packed, scales, m0, n0, M, K, N, k_begin, n_steps,
                            k_per_split / BK, acc, [&](int) {   // total += the split's sum
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          total[mt][nt][e] += acc[mt][nt][e];
          acc[mt][nt][e] = 0.f;
        }
  });

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int n = n0 + wn * TL::WTN + nt * 8 + 2 * tq;
      if (n >= N) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int m = m0 + wm * TL::WTM + mt * 16 + g + 8 * hh;
        if (m >= M) continue;
        float v0 = total[mt][nt][2 * hh], v1 = total[mt][nt][2 * hh + 1];
        if (partial != nullptr) {
          *reinterpret_cast<float2*>(partial + ((size_t)z * M + m) * N + n) =
              make_float2(v0, v1);
          continue;
        }
        if (bias != nullptr) {   // as split_reduce_kernel: the bias after the splits
          v0 += bias[n];
          v1 += bias[n + 1];
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)m * N + n) = pack_bf16(v0, v1);
      }
    }
}

// Shared bytes of an expert-batch block that walks `walk` splits of each
// item: the tile's ring and W tiles, then the split sums. persist: two
// sets of walk sum tiles after the ring (item by item, alternating, while
// the ring runs on into the next item). Else (one item a cluster) the sums
// of the first walk - 1 splits after the ring, the last split's over the
// ring, free by then. ops.experts_smem computes the same.
template <class TL>
size_t experts_smem(int walk) {
  if (TL::PERSIST) return TL::SMEM + 2 * (size_t)walk * TL::SUM_BYTES;
  const size_t lead = TL::SMEM > TL::SUM_BYTES ? TL::SMEM : TL::SUM_BYTES;
  return lead + (size_t)(walk - 1) * TL::SUM_BYTES;
}

// A thread's share of TileSteps::load's copies for one product (an
// expert's slices), set up once an item, then issued a step at a time: the
// sources' offsets advance by one K step each time (x 64 elements, packed
// bytes 64 rows, codebooks 8 N floats in either layout).
template <class TL, bool KBLOCKED>
struct StepCopies {
  static constexpr int NX = TL::BM * 8, NP = BK * TL::BN / 32, NC = TL::BN * LEVELS / 4;
  static constexpr int CX = (NX + TL::THREADS - 1) / TL::THREADS;
  static constexpr int CP = (NP + TL::THREADS - 1) / TL::THREADS;
  static constexpr int CC = (NC + TL::THREADS - 1) / TL::THREADS;
  const bf16* x;
  const uint8_t* packed;
  const float* scales;
  uint32_t xo[CX], po[CP], co[CC];   // source offsets (elements) of the next step
  uint32_t in_mask;                  // bit i: copy i is in range (else zero-filled)

  // Expert slices x, packed, scales; columns n0..; the first step at k0.
  __device__ __forceinline__ void start(const bf16* xe, const uint8_t* pe, const float* se,
                                        int n0, int M, int K, int N, int k0) {
    x = xe;
    packed = pe;
    scales = se;
    in_mask = 0;
    const int tid = threadIdx.x;
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int c = tid + i * TL::THREADS, r = c / 8, j = c % 8;
      const bool in = r < M;
      xo[i] = in ? (uint32_t)(r * K + k0 + j * 8) : 0u;
      in_mask |= (uint32_t)in << i;
    }
#pragma unroll
    for (int i = 0; i < CP; ++i) {
      const int c = tid + i * TL::THREADS, r = c / (TL::BN / 32), j = c % (TL::BN / 32);
      const bool in = n0 + j * 32 < N;
      po[i] = in ? (uint32_t)((k0 + r) * (N / 2) + n0 / 2 + j * 16) : 0u;
      in_mask |= (uint32_t)in << (8 + i);
    }
#pragma unroll
    for (int i = 0; i < CC; ++i) {
      const int c = tid + i * TL::THREADS;
      bool in;
      if constexpr (KBLOCKED) {
        const int col = c / 2;
        in = n0 + col < N;
        co[i] = in ? (uint32_t)(((k0 / BK) * N + n0 + col) * LEVELS + (c % 2) * 4) : 0u;
      } else {
        const int r = c / (TL::BN / 32), j = c % (TL::BN / 32);
        in = n0 + (j / 2) * 64 < N;
        co[i] = in ? (uint32_t)(((k0 + r) * (N / 64) + n0 / 64 + j / 2) * LEVELS + (j % 2) * 4)
                   : 0u;
      }
      in_mask |= (uint32_t)in << (16 + i);
    }
  }

  // This step's copies -> stage s of the ring at smem; then one step on.
  __device__ __forceinline__ void issue(unsigned char* smem, int s, int K, int N) {
    const int tid = threadIdx.x;
    unsigned char* stage = smem + s * TL::STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < CX; ++i) {
      const int c = tid + i * TL::THREADS;
      if (CX * TL::THREADS > NX && c >= NX) break;
      const bool in = (in_mask >> i) & 1u;
      cp_async16(smem_u32(stage + ((c / 8) * TL::LDX + (c % 8) * 8) * 2), x + xo[i], in);
      xo[i] += in ? BK : 0;
    }
#pragma unroll
    for (int i = 0; i < CP; ++i) {
      const int c = tid + i * TL::THREADS;
      if (CP * TL::THREADS > NP && c >= NP) break;
      const bool in = (in_mask >> (8 + i)) & 1u;
      cp_async16(smem_u32(stage + TL::X_BYTES + c * 16), packed + po[i], in);
      po[i] += in ? (uint32_t)(BK * (N / 2)) : 0u;
    }
#pragma unroll
    for (int i = 0; i < CC; ++i) {
      const int c = tid + i * TL::THREADS;
      if (CC * TL::THREADS > NC && c >= NC) break;
      const bool in = (in_mask >> (16 + i)) & 1u;
      cp_async16(smem_u32(stage + TL::X_BYTES + TL::PK_BYTES + c * 16), scales + co[i], in);
      co[i] += in ? (uint32_t)(8 * N) : 0u;
    }
  }
};

// The experts with a routed token, in order: expert_of(r) is the index of
// the r-th of them (E past the last), found 32 experts at a time with a
// warp ballot. r must not decrease between calls; every lane of the warp
// calls it.
struct RoutedExperts {
  const int* counts;
  int E, e0 = 0, r0 = 0;   // the chunk of 32 experts from e0; routed ones before it
  __device__ __forceinline__ RoutedExperts(const int* c, int n) : counts(c), E(n) {}
  __device__ __forceinline__ int expert_of(int rank) {
    for (; e0 < E; e0 += 32) {
      const int e = e0 + (int)(threadIdx.x % 32);
      const unsigned bits = __ballot_sync(0xffffffffu, e < E && counts[e] != 0);
      const int n = __popc(bits);
      if (rank < r0 + n) return e0 + (int)__fns(bits, 0, rank - r0 + 1);
      r0 += n;
    }
    return E;
  }
};

// The expert batch at M <= 128 rows an expert. An item is one expert's
// N tile of BN columns; the routed items (experts with counts[e] > 0, N
// tiles in order) are numbered q = 0, 1, ... grid: G clusters of
// `cluster` blocks ((G * cluster, 1, 1), clusters (cluster, 1, 1)); cluster
// c takes routed items c, c + G, ... Its block of rank r holds all M rows
// and walks splits r * walk .. r * walk + walk - 1 of each (cluster * walk
// = splits, each k_per_split), decoding each step's weights once for
// every row; its cp.async ring runs on from one item into the next. Each
// split's f32 sum goes to the block's shared memory. After the item's
// cluster.sync() every block adds its share of the item's M x BN outputs
// over all splits, read through distributed shared memory, in ascending
// split order from 0 (split_reduce_kernel's additions), and writes them
// as bf16. Cluster c also writes the zeros of unrouted items c, c + G, ...
// of all E * ceil(N / BN) items, and reads nothing of those experts.
// Without TL::PERSIST, G is the item count (one item a cluster at most).
template <class TL, bool KBLOCKED>
__global__ void __launch_bounds__(TL::THREADS, TL::MIN_BLOCKS)
msb_experts_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
                   const float* __restrict__ scales, const int* __restrict__ counts,
                   bf16* __restrict__ out, int E, int M, int K, int N, int k_per_split,
                   int walk) {
  constexpr int BN = TL::BN, MT = TL::MT, NT = TL::NT, LDS = TL::LDS, STAGES = TL::STAGES;
  constexpr bool persist = TL::PERSIST;
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int G = gridDim.x / cl, c = blockIdx.x / cl;
  const int ntiles = (N + BN - 1) / BN;
  const size_t x_e = (size_t)M * K, pk_e = (size_t)K * (N / 2), out_e = (size_t)M * N;
  const size_t sc_e = (size_t)K * (N / 8);   // K * N/64 * 8 == K/64 * N * 8
  // this block's share of an item's outputs: groups [lo, hi) of 4 columns
  // of the M x BN tile, row-major
  const int groups = M * (BN / 4);
  const int lo = rank * groups / cl, hi = (rank + 1) * groups / cl;

  for (int i = c; i < E * ntiles; i += G) {   // unrouted items: zeros
    const int e = i / ntiles, n0 = (i % ntiles) * BN;
    if (counts[e] != 0) continue;
    for (int f = lo + threadIdx.x; f < hi; f += TL::THREADS) {
      const int m = f / (BN / 4), n = n0 + (f % (BN / 4)) * 4;
      if (n < N)
        *reinterpret_cast<uint2*>(out + e * out_e + (size_t)m * N + n) = make_uint2(0u, 0u);
    }
  }
  RoutedExperts routed(counts, E), routed_ld(counts, E);
  int q = c, e = routed.expert_of(c / ntiles);
  if (e >= E) return;   // no routed item: the cluster touches no peer

  const TileSteps<TL, KBLOCKED> st(smem);
  const int split_steps = k_per_split / BK, item_steps = walk * split_steps;
  const int k_first = rank * walk * k_per_split;
  // the loader's cursor (routed item q_ld of expert e_ld, its step s_ld)
  // runs STAGES - 1 steps ahead, into the cluster's next items
  int q_ld = q, e_ld = e, s_ld = 0, t_ld = 0;
  StepCopies<TL, KBLOCKED> copies;
  auto start_item = [&]() {
    copies.start(x + e_ld * x_e, packed + e_ld * pk_e, scales + e_ld * sc_e,
                 (q_ld % ntiles) * BN, M, K, N, k_first);
  };
  start_item();
  auto load_next = [&]() {
    if (e_ld < E) {
      copies.issue(smem, t_ld % STAGES, K, N);
      if (++s_ld == item_steps) {   // one item a cluster: none after it
        s_ld = 0;
        q_ld += G;
        e_ld = persist ? routed_ld.expert_of(q_ld / ntiles) : E;
        if (e_ld < E) start_item();
      }
    }
    cp_async_commit();
    ++t_ld;
  };
  const size_t lead = TL::SMEM > TL::SUM_BYTES ? TL::SMEM : TL::SUM_BYTES;
  auto sum_at = [&](unsigned char* base, int parity, int j) {   // split j's sum tile
    if constexpr (persist)
      return reinterpret_cast<float*>(base + TL::SMEM +
                                      (size_t)(parity * walk + j) * TL::SUM_BYTES);
    return reinterpret_cast<float*>(base + (j == walk - 1 ? 0 : lead + (size_t)j * TL::SUM_BYTES));
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / TL::WARPS_N, wn = warp % TL::WARPS_N;
  const int g = lane >> 2, tq = lane & 3;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
  auto store = [&](float* dst) {   // acc -> a sum tile, then acc = 0
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int m = wm * TL::WTM + mt * 16 + g + 8 * hh;
          const int n = wn * TL::WTN + nt * 8 + 2 * tq;
          *reinterpret_cast<float2*>(dst + m * LDS + n) =
              make_float2(acc[mt][nt][2 * hh], acc[mt][nt][2 * hh + 1]);
          acc[mt][nt][2 * hh] = acc[mt][nt][2 * hh + 1] = 0.f;
        }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load_next();
  cp_async_wait<STAGES - 2>();   // step 0 has landed
  __syncthreads();
  st.decode(0, 0);
  const int splits = cl * walk;
  for (int t = 0, parity = 0;; parity ^= 1) {
    const int n0 = (q % ntiles) * BN;
    const int e_next = persist ? routed.expert_of((q + G) / ntiles) : E;
    for (int s = 0, ss = 0, j = 0; s < item_steps; ++s, ++t) {   // split j, its step ss
      cp_async_wait<STAGES - 3>();   // step t + 1 has landed
      __syncthreads();               // W tile t visible; step t - 1 done by all
      load_next();
      st.mma(t % STAGES, t & 1, acc);
      if (s + 1 < item_steps || e_next < E) st.decode((t + 1) % STAGES, (t + 1) & 1);
      if (++ss == split_steps) {
        if (persist || j < walk - 1) store(sum_at(smem, parity, j));
        ss = 0;
        ++j;
      }
    }
    if constexpr (!persist) {   // the last split's sum over the drained ring
      cp_async_wait<0>();
      __syncthreads();
      store(sum_at(smem, parity, walk - 1));
    }
    cluster.sync();   // every split's sum of item q is in its block's shared memory
    bf16* o = out + e * out_e;
    for (int f = lo + threadIdx.x; f < hi; f += TL::THREADS) {
      const int m = f / (BN / 4), col = (f % (BN / 4)) * 4;
      if (n0 + col >= N) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s0 = 0; s0 < splits; s0 += 8) {   // split s lies in rank s / walk
        float4 p[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)   // the loads first, all in flight at once
          if (s0 + u < splits)
            p[u] = *reinterpret_cast<const float4*>(
                sum_at(cluster.map_shared_rank(smem, (s0 + u) / walk), parity,
                       (s0 + u) % walk) +
                m * LDS + col);
#pragma unroll
        for (int u = 0; u < 8; ++u)   // then the additions, in ascending order
          if (s0 + u < splits) {
            v.x += p[u].x;
            v.y += p[u].y;
            v.z += p[u].z;
            v.w += p[u].w;
          }
      }
      *reinterpret_cast<uint2*>(o + (size_t)m * N + n0 + col) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
    if (e_next >= E) break;
    q += G;
    e = e_next;
  }
  cp_async_wait<0>();
  cluster.sync();    // no block leaves while a peer still reads its sums
}

template <class TL, bool KB>
int launch_tc(const bf16* x, const uint8_t* packed, const float* scales, const float* bias,
              const int* counts, bf16* out, float* partial, int E, int M, int K, int N,
              int splits, int grid_splits, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(msb_matmul_tc_kernel<TL, KB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + TL::BN - 1) / TL::BN, (M + TL::BM - 1) / TL::BM, E * grid_splits);
  float* part = grid_splits > 1 ? partial : nullptr;
  msb_matmul_tc_kernel<TL, KB><<<grid, TL::THREADS, TL::SMEM, stream>>>(
      x, packed, scales, bias, out, part, counts, grid_splits, M, K, N, K / splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || grid_splits == 1) return (int)e;
  launch_reduce<bf16>(part, bias, counts, out, E, M, N, grid_splits, stream);
  return (int)cudaGetLastError();
}

template <class TL>
int launch_tc_kb(const void* x, const void* packed, const void* scales, const void* bias,
                 const int* counts, void* out, void* partial, int E, int M, int K, int N,
                 int splits, int grid_splits, int kblocked, cudaStream_t s) {
  auto* xx = static_cast<const bf16*>(x);
  auto* pk = static_cast<const uint8_t*>(packed);
  auto* sc = static_cast<const float*>(scales);
  auto* bs = static_cast<const float*>(bias);
  auto* o = static_cast<bf16*>(out);
  auto* p = static_cast<float*>(partial);
  return kblocked ? launch_tc<TL, true>(xx, pk, sc, bs, counts, o, p, E, M, K, N, splits,
                                        grid_splits, s)
                  : launch_tc<TL, false>(xx, pk, sc, bs, counts, o, p, E, M, K, N, splits,
                                         grid_splits, s);
}

template <class TL, bool KB>
int launch_experts(const bf16* x, const uint8_t* packed, const float* scales,
                   const int* counts, bf16* out, int E, int M, int K, int N, int splits,
                   int cluster, cudaStream_t stream) {
  const int walk = splits / cluster;
  const size_t smem = experts_smem<TL>(walk);
  if (M > TL::BM || smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  auto kernel = msb_experts_kernel<TL, KB>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  const long long items = (long long)E * ((N + TL::BN - 1) / TL::BN);
  cfg.gridDim = dim3((unsigned)(items * cluster), 1, 1);
  cfg.blockDim = dim3(TL::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (TL::PERSIST) {   // as many clusters as the card holds, each walking several items
    static int resident[8][16] = {};   // by cluster size and walk (smem), per instance
    int fresh = 0, *g = cluster <= 8 && walk <= 16 ? &resident[cluster - 1][walk - 1] : &fresh;
    if (*g == 0) {
      e = cudaOccupancyMaxActiveClusters(g, kernel, &cfg);
      if (e != cudaSuccess) return (int)e;
      if (*g < 1) return (int)cudaErrorInvalidConfiguration;
    }
    if (*g < items) cfg.gridDim.x = (unsigned)(*g * cluster);
  }
  e = cudaLaunchKernelEx(&cfg, kernel, x, packed, scales, counts, out, E, M, K, N, K / splits,
                         walk);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

template <class TL>
int launch_experts_kb(const void* x, const void* packed, const void* scales,
                      const int* counts, void* out, int E, int M, int K, int N, int splits,
                      int cluster, int kblocked, cudaStream_t s) {
  auto* xx = static_cast<const bf16*>(x);
  auto* pk = static_cast<const uint8_t*>(packed);
  auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<bf16*>(out);
  return kblocked ? launch_experts<TL, true>(xx, pk, sc, counts, o, E, M, K, N, splits,
                                             cluster, s)
                  : launch_experts<TL, false>(xx, pk, sc, counts, o, E, M, K, N, splits,
                                              cluster, s);
}

// The expert batch's cluster launch (bf16 x, M <= 128): the tile (bm, bn),
// `cluster` blocks along K a cluster and persistent clusters or one item a
// cluster, as ops.experts_plan chose them.
int run_experts(const void* x, const void* packed, const void* scales, const int* counts,
                void* out, int E, int M, int K, int N, int splits, int bm, int bn,
                int cluster, int persist, int kblocked, void* stream) {
  if (splits < 1 || K % (BK * splits) || N % 64 || M < 0 || M > 128 || E < 1 ||
      cluster < 1 || cluster > 8 || splits % cluster ||
      (long long)E * ((N + bn - 1) / bn) * cluster > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define EXPERT_TILE(TL)                                                                \
  if (bm == TL::BM && bn == TL::BN && persist == (int)TL::PERSIST)                     \
    return launch_experts_kb<TL>(x, packed, scales, counts, out, E, M, K, N, splits, \
                                 cluster, kblocked, s);
  EXPERT_TILE(ExpertTile16)
  EXPERT_TILE(ExpertTile32)
  EXPERT_TILE(ExpertTile64)
  EXPERT_TILE(ExpertTile128)
  EXPERT_TILE(ExpertTile128N)
#undef EXPERT_TILE
  return (int)cudaErrorInvalidValue;
}

// Both entry points: E products (E = 1 and counts == nullptr for one).
int run(const void* x, const void* packed, const void* scales, const void* bias,
        const int* counts, void* out, void* partial, int E, int M, int K, int N, int splits,
        int grid_splits, int bm, int kblocked, int x_is_bf16, void* stream) {
  if (splits < 1 || K % (BK * splits) || N % 64 || M < 0 || E < 1 ||
      (long long)E * (x_is_bf16 ? grid_splits : splits) > 65535)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!x_is_bf16) {
    auto* xx = static_cast<const float*>(x);
    auto* pk = static_cast<const uint8_t*>(packed);
    auto* sc = static_cast<const float*>(scales);
    auto* bs = static_cast<const float*>(bias);
    auto* o = static_cast<float*>(out);
    auto* p = static_cast<float*>(partial);
    if (bm == 8)
      return kblocked
                 ? launch_f32<8, true>(xx, pk, sc, bs, counts, o, p, E, M, K, N, splits, s)
                 : launch_f32<8, false>(xx, pk, sc, bs, counts, o, p, E, M, K, N, splits, s);
    if (bm == 32)
      return kblocked
                 ? launch_f32<32, true>(xx, pk, sc, bs, counts, o, p, E, M, K, N, splits, s)
                 : launch_f32<32, false>(xx, pk, sc, bs, counts, o, p, E, M, K, N, splits, s);
    return (int)cudaErrorInvalidValue;
  }
  if (bm == SmallTile::BM && grid_splits == splits)
    return launch_tc_kb<SmallTile>(x, packed, scales, bias, counts, out, partial, E, M, K, N,
                                   splits, grid_splits, kblocked, s);
  if (bm == LargeTile::BM && grid_splits == 1)
    return launch_tc_kb<LargeTile>(x, packed, scales, bias, counts, out, partial, E, M, K, N,
                                   splits, grid_splits, kblocked, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// f32 unembedding: one weight-streaming kernel for both table layouts
// ---------------------------------------------------------------------------
//
// logits[m, v] = sum_d x[m, d] * w[d, v], x f32 (M, K), out f32 (M, N),
// for the two packed layouts of an unembedding table:
//   * k-blocked (an untied unembed): packed (K, N/2), scales (K/64, N, 8);
//   * tied (the embedding, n-blocked, read as its transpose): packed
//     (N, Kp/2), scales (N, Kp/64, 8). Row v of the table is column v of
//     w, and its Kp/64 codebooks all lie on the reduction axis; Kp >= K is
//     the padded width, x's columns past K count as 0.
// Each weight is +-codebook[level] in f32, or the codebook rounded to bf16
// first (round_bf16: a tied table that dequantizes to bf16). Sums in f32.
//
// What bounds it: the table streams once per MT rows of x at 1 B a weight
// (0.5 B of codes, 0.5 B of codebooks): (K*N/2 + K/64*N*32) B / 3.35 TB/s,
// 0.057 ms for internlm2's 2048 x 92672 and 0.176 ms for gemma2's 256000 x
// 2304. At M = 8 the SIMT FMAs come close behind (8 a weight: 0.14 ms at
// gemma2's table on 67 TFLOP/s), so every other instruction a weight
// counts: the decode is one shared-memory load and two integer ops.
//
// Design (replaces msb_matmul_f32_kernel on this path, whose 64-row K
// steps each loaded x, codes and codebooks synchronously into shared
// memory, decoded an f32 tile and crossed three barriers):
//   * a block of 16 warps stages its MT rows of x once, transposed to
//     xs[d * MT + m] (one row d's MT values are one or two 16-byte loads),
//     and crosses no block barrier in its K loop;
//   * each codebook becomes a signed 16-entry decode table of one lane's
//     own in shared memory, lane-interleaved (entry e of lane l at e * 32 +
//     l, so every lookup is free of bank conflicts), indexed by the nibble
//     (sign << 3) | level itself; a lane reads only what it wrote;
//   * tied: a quad of lanes owns a table row, lane t of the quad its
//     k-blocks t, t + 4, ... (a quad's 16-byte loads cover 64 bytes of one
//     128-byte line: codes and codebooks of 4 neighbouring k-blocks); a
//     lane holds 2 rows (a warp 16), loads a k-block's 32 bytes of codes
//     and 32 of codebook per row into registers one k-block ahead, and the
//     quad's 4 sums are added by two shuffles in a fixed order. The 4
//     k-blocks a warp reads at once sit in distinct shared-memory banks of
//     x: xs pads 4 floats (1 at MT = 1) after each 64-row k-block;
//   * k-blocked: a lane owns 2 adjacent columns (a warp 64) and walks its K
//     slice row by row, every lane at the same row (x a broadcast); the
//     warp's codes, 32 bytes a row, stream through a 3-stage cp.async ring
//     of 64-row k-blocks in shared memory, its codebooks (64 contiguous
//     bytes a lane) into registers one k-block ahead;
//   * the K slices (ops.unembed_slices: a function of Kp, N and the layout
//     only) are warps of one block: after the loop slices 1.. leave their
//     sums in shared memory and slice 0 adds them in ascending order.
// Rows independent of M: every (m, v) is summed in an order fixed by (Kp,
// N): one f32 FMA chain per lane over its k-blocks in ascending d, the
// quad's chains added (t0 + t1) + (t2 + t3), the slices in ascending
// order; MT (rows of x a block, chosen from M) changes none of it.

constexpr int UN_THREADS = 512;
constexpr int UN_WARPS = UN_THREADS / 32;
constexpr int UN_SLOTS = 2;         // tied: rows a lane holds; k-blocked: columns a lane owns
constexpr int TAB = 16 * 32;        // floats of one signed decode table, all lanes
constexpr int KB_STAGES = 3;        // k-blocked: cp.async ring of 64-row k-blocks
constexpr int KB_STAGE_BYTES = BK * 32;   // one k-block of a warp's 64 columns

__host__ __device__ constexpr int x_pad(bool kblocked, int mt) {
  return kblocked ? 0 : (mt == 1 ? 1 : 4);
}

// Shared memory of a launch: the warps' decode tables, the k-blocked code
// ring, then x (MT rows, transposed, padded per k-block) or, after the K
// loop, the slices' sums. ops.unembed_smem computes the same.
size_t unembed_smem(bool kblocked, int mt, int Kp, int S) {
  const size_t tables = (size_t)UN_WARPS * UN_SLOTS * TAB * 4;
  const size_t ring = kblocked ? (size_t)UN_WARPS * KB_STAGES * KB_STAGE_BYTES : 0;
  const size_t xb = ((size_t)mt * Kp + (size_t)(Kp / BK) * x_pad(kblocked, mt)) * 4;
  const size_t red = (size_t)(S - 1) * (UN_WARPS / S) * 32 * UN_SLOTS * mt * 4;
  return tables + ring + (xb > red ? xb : red);
}

// A lane's signed decode table of one codebook: tab[e * 32] = c_e,
// tab[(8 + e) * 32] = -c_e (tab already offset by the lane).
__device__ __forceinline__ void put_table(float* tab, float4 lo, float4 hi, int round_bf16) {
  const float c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float v = round_bf16 ? __bfloat162float(__float2bfloat16_rn(c[e])) : c[e];
    tab[e * 32] = v;
    tab[(8 + e) * 32] = -v;
  }
}

template <int MT>
__device__ __forceinline__ void load_x(const float* p, float (&xv)[MT]) {
  if constexpr (MT % 4 == 0) {
#pragma unroll
    for (int i = 0; i < MT / 4; ++i) {
      const float4 t = reinterpret_cast<const float4*>(p)[i];
      xv[4 * i] = t.x;
      xv[4 * i + 1] = t.y;
      xv[4 * i + 2] = t.z;
      xv[4 * i + 3] = t.w;
    }
  } else if constexpr (MT == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    xv[0] = t.x;
    xv[1] = t.y;
  } else {
    xv[0] = p[0];
  }
}

// Rows m0 .. m0 + MT of x (M, K) into xs[d * MT + (d / 64) * PAD + m] for
// d < Kp, zero past M and K.
template <int MT, int PAD>
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ x, int m0, int M,
                                        int K, int Kp) {
  for (int i = threadIdx.x; i < MT * Kp; i += UN_THREADS) {
    const int m = i / Kp, d = i - m * Kp;
    xs[d * MT + (d / BK) * PAD + m] = (m0 + m < M && d < K) ? x[(size_t)(m0 + m) * K + d] : 0.f;
  }
}

// Slices 1 .. S-1 of a strip leave their F sums a lane in red; slice 0 adds
// them to its own in ascending order. Returns whether this warp stores.
template <int F>
__device__ __forceinline__ bool reduce_slices(float (&acc)[F], float* red, int S, int slice,
                                              int wstrip, int lane) {
  if (S == 1) return true;
  __syncthreads();   // every warp is past its K loop: x's region is free
  float* base = red + (size_t)wstrip * (S - 1) * F * 32 + lane;
  if (slice > 0) {
#pragma unroll
    for (int f = 0; f < F; ++f) base[((slice - 1) * F + f) * 32] = acc[f];
  }
  __syncthreads();
  if (slice > 0) return false;
  for (int s = 1; s < S; ++s) {
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] += base[((s - 1) * F + f) * 32];
  }
  return true;
}

// grid: (ceil(N / (16 * 16 / S)), ceil(M / MT)); warp w: slice w % S of
// strip w / S of the block's 16 / S strips of 16 rows; lane 4 q + t: rows
// strip * 16 + q + 8 r (r = 0, 1), k-blocks kb0 + t, kb0 + t + 4, ...
template <int MT>
__global__ void __launch_bounds__(UN_THREADS, 1)
unembed_tied_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                    const float* __restrict__ scales, float* __restrict__ out, int M, int K,
                    int Kp, int N, int S, int round_bf16) {
  extern __shared__ __align__(16) unsigned char un_smem[];
  float* smem = reinterpret_cast<float*>(un_smem);
  constexpr int R = UN_SLOTS, PAD = x_pad(false, MT);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q = lane / 4, t = lane % 4;
  const int slice = warp % S, wstrip = warp / S;
  const int strip = blockIdx.x * (UN_WARPS / S) + wstrip;
  const int kblocks = Kp / BK, kps = kblocks / S;
  const int kb1 = (slice + 1) * kps;
  const int m0 = blockIdx.y * MT;
  float* tab = smem + warp * R * TAB + lane;
  float* xs = smem + UN_WARPS * R * TAB;

  const uint4* pk[R];
  const float4* sc[R];
  int v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = strip * 16 + q + 8 * r;
    const size_t row = v[r] < N ? v[r] : 0;   // a row past N reads row 0, stores nothing
    pk[r] = reinterpret_cast<const uint4*>(packed + row * (Kp / 2));
    sc[r] = reinterpret_cast<const float4*>(scales + row * kblocks * LEVELS);
  }
  int kb = slice * kps + t;
  uint4 c[R][2];
  float4 s[R][2];
  if (kb < kb1) {   // the first k-block in flight while x is staged
#pragma unroll
    for (int r = 0; r < R; ++r) {
      c[r][0] = pk[r][2 * kb];
      c[r][1] = pk[r][2 * kb + 1];
      s[r][0] = sc[r][2 * kb];
      s[r][1] = sc[r][2 * kb + 1];
    }
  }
  stage_x<MT, PAD>(xs, x, m0, M, K, Kp);
  __syncthreads();

  float acc[R * MT];
#pragma unroll
  for (int f = 0; f < R * MT; ++f) acc[f] = 0.f;
  for (; kb < kb1; kb += 4) {
    uint32_t cw[R][8];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      put_table(tab + r * TAB, s[r][0], s[r][1], round_bf16);
      cw[r][0] = c[r][0].x; cw[r][1] = c[r][0].y; cw[r][2] = c[r][0].z; cw[r][3] = c[r][0].w;
      cw[r][4] = c[r][1].x; cw[r][5] = c[r][1].y; cw[r][6] = c[r][1].z; cw[r][7] = c[r][1].w;
    }
    if (kb + 4 < kb1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        c[r][0] = pk[r][2 * kb + 8];
        c[r][1] = pk[r][2 * kb + 9];
        s[r][0] = sc[r][2 * kb + 8];
        s[r][1] = sc[r][2 * kb + 9];
      }
    }
    const float* xb = xs + (size_t)kb * (BK * MT + PAD);
#pragma unroll
    for (int qq = 0; qq < 8; ++qq) {   // code word qq: the k-block's d = 8 qq .. 8 qq + 7
      float w[R][8];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) w[r][j] = tab[r * TAB + ((cw[r][qq] >> (4 * j)) & 15) * 32];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float xv[MT];
        load_x<MT>(xb + (qq * 8 + j) * MT, xv);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int m = 0; m < MT; ++m) acc[r * MT + m] = fmaf(w[r][j], xv[m], acc[r * MT + m]);
      }
    }
  }
#pragma unroll
  for (int f = 0; f < R * MT; ++f) {   // the quad's chains: (t0 + t1) + (t2 + t3)
    acc[f] += __shfl_xor_sync(0xffffffffu, acc[f], 1);
    acc[f] += __shfl_xor_sync(0xffffffffu, acc[f], 2);
  }
  if (!reduce_slices<R * MT>(acc, xs, S, slice, wstrip, lane)) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (v[r] >= N) continue;
#pragma unroll
    for (int m = 0; m < MT; ++m)   // lane t of the quad stores rows m = t mod 4
      if ((m & 3) == t && m0 + m < M) out[(size_t)(m0 + m) * N + v[r]] = acc[r * MT + m];
  }
}

// grid: (ceil(N / (64 * 16 / S)), ceil(M / MT)); warp w: slice w % S of
// strip w / S of the block's 16 / S strips of 64 columns; lane l: columns
// strip * 64 + 2 l and + 1 (one byte of codes a K row).
template <int MT>
__global__ void __launch_bounds__(UN_THREADS, 1)
unembed_kblocked_kernel(const float* __restrict__ x, const uint8_t* __restrict__ packed,
                        const float* __restrict__ scales, float* __restrict__ out, int M,
                        int K, int N, int S) {
  extern __shared__ __align__(16) unsigned char un_smem[];
  float* smem = reinterpret_cast<float*>(un_smem);
  constexpr int C = UN_SLOTS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slice = warp % S, wstrip = warp / S;
  const int strip = blockIdx.x * (UN_WARPS / S) + wstrip;
  const int kps = K / BK / S, kb0 = slice * kps;
  const int m0 = blockIdx.y * MT;
  float* tab = smem + warp * C * TAB + lane;
  uint8_t* ring = un_smem + (size_t)UN_WARPS * C * TAB * 4 +
                  (size_t)warp * KB_STAGES * KB_STAGE_BYTES;
  float* xs = reinterpret_cast<float*>(un_smem + (size_t)UN_WARPS * C * TAB * 4 +
                                       (size_t)UN_WARPS * KB_STAGES * KB_STAGE_BYTES);

  const int n = strip * 64 + 2 * lane;        // the lane's first column
  const int sn = strip * 64 < N ? strip : 0;  // a strip past N reads strip 0, stores nothing
  // the ring's copies: lane l brings 16 bytes of rows l / 2 + 16 i (i < 4)
  const uint8_t* src = packed + (size_t)(kb0 * BK + lane / 2) * (N / 2) + sn * 32 + 16 * (lane % 2);
  const size_t src_kb = (size_t)BK * (N / 2), src_i = (size_t)16 * (N / 2);
  const int dst0 = (lane / 2) * 32 + 16 * (lane % 2);
  const float4* sc = reinterpret_cast<const float4*>(
      scales + ((size_t)kb0 * N + (n < N ? n : 0)) * LEVELS);
  const size_t sc_step = (size_t)N * LEVELS / 4;   // float4s from one k-block to the next

#pragma unroll
  for (int st = 0; st < KB_STAGES - 1; ++st) {
    if (st < kps) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cp_async16(smem_u32(ring + st * KB_STAGE_BYTES + dst0 + i * 16 * 32),
                   src + st * src_kb + i * src_i, true);
    }
    cp_async_commit();
  }
  float4 s[2 * C];
#pragma unroll
  for (int i = 0; i < 2 * C; ++i) s[i] = sc[i];
  stage_x<MT, 0>(xs, x, m0, M, K, K);
  __syncthreads();

  float acc[C * MT];
#pragma unroll
  for (int f = 0; f < C * MT; ++f) acc[f] = 0.f;
  for (int i = 0; i < kps; ++i) {
    const int ld = i + KB_STAGES - 1;   // the k-block this iteration brings in
    if (ld < kps) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cp_async16(smem_u32(ring + (ld % KB_STAGES) * KB_STAGE_BYTES + dst0 + j * 16 * 32),
                   src + ld * src_kb + j * src_i, true);
    }
    cp_async_commit();
#pragma unroll
    for (int cc = 0; cc < C; ++cc) put_table(tab + cc * TAB, s[2 * cc], s[2 * cc + 1], 0);
    if (i + 1 < kps) {
#pragma unroll
      for (int u = 0; u < 2 * C; ++u) s[u] = sc[(size_t)(i + 1) * sc_step + u];
    }
    cp_async_wait<KB_STAGES - 1>();   // this lane's copies of k-block i have landed
    __syncwarp();                     // and every lane's
    const uint8_t* codes = ring + (i % KB_STAGES) * KB_STAGE_BYTES + lane;
    const float* xb = xs + (size_t)(kb0 + i) * BK * MT;
#pragma unroll 8
    for (int r = 0; r < BK; ++r) {
      const uint32_t cb = codes[r * 32];
      const float w0 = tab[(cb & 15) * 32], w1 = tab[TAB + (cb >> 4) * 32];
      float xv[MT];
      load_x<MT>(xb + r * MT, xv);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m] = fmaf(w0, xv[m], acc[m]);
        acc[MT + m] = fmaf(w1, xv[m], acc[MT + m]);
      }
    }
    __syncwarp();   // k-block i's stage is read before the next iteration refills it
  }
  cp_async_wait<0>();
  if (!reduce_slices<C * MT>(acc, xs, S, slice, wstrip, lane)) return;
  if (n >= N) return;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    if (m0 + m >= M) continue;
    *reinterpret_cast<float2*>(out + (size_t)(m0 + m) * N + n) = make_float2(acc[m], acc[MT + m]);
  }
}

template <int MT>
int launch_unembed(const float* x, const uint8_t* packed, const float* scales, float* out,
                   int M, int K, int Kp, int N, int kblocked, int round_bf16, int S,
                   cudaStream_t stream) {
  const size_t smem = unembed_smem(kblocked, MT, Kp, S);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  const int per_warp = kblocked ? 64 : 16;
  const int strips = (N + per_warp - 1) / per_warp;
  const int per_block = UN_WARPS / S;
  dim3 grid((strips + per_block - 1) / per_block, (M + MT - 1) / MT);
  cudaError_t e;
  if (kblocked) {
    e = cudaFuncSetAttribute(unembed_kblocked_kernel<MT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    unembed_kblocked_kernel<MT><<<grid, UN_THREADS, smem, stream>>>(x, packed, scales, out, M,
                                                                    K, N, S);
  } else {
    e = cudaFuncSetAttribute(unembed_tied_kernel<MT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    unembed_tied_kernel<MT><<<grid, UN_THREADS, smem, stream>>>(x, packed, scales, out, M, K,
                                                                Kp, N, S, round_bf16);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes). The caller (ops.plan) has
// chosen the tile bm and where the K splits run, checked shapes, types,
// contiguity and 16-byte alignment, and allocated out (M, N) and, when
// grid_splits > 1 (or, for f32, splits > 1), the f32 workspace partial
// (splits, M, N). bf16: bm is 16 (grid_splits == splits) or 128
// (grid_splits == 1); f32: bm is 8 or 32 and the splits always run on
// separate blocks. Requires K % (64 * splits) == 0 and N % 64 == 0; returns
// cudaErrorInvalidValue otherwise, else cudaGetLastError().
extern "C" int msb_matmul(const void* x, const void* packed, const void* scales,
                          const void* bias, void* out, void* partial, int M,
                          int K, int N, int splits, int grid_splits, int bm,
                          int kblocked, int x_is_bf16, void* stream) {
  return run(x, packed, scales, bias, nullptr, out, partial, 1, M, K, N, splits, grid_splits,
             bm, kblocked, x_is_bf16, stream);
}

// The expert batch: x (E, M, K), packed (E, K, N/2), scales (E, ...) as
// one expert's, counts (E,) int32 on the device, out (E, M, N); no bias
// (the expert FFN has none). cluster > 0 (bf16 x, M <= 128): one cluster
// launch of the tile (bm, bn), persistent clusters or not, no workspace
// (ops.experts_plan). cluster == 0: msb_matmul's kernels with its plan
// for one expert's M (f32 x, or M > 128: bm 128, grid_splits 1), partial
// (E, splits, M, N) under its rule.
extern "C" int msb_matmul_experts(const void* x, const void* packed, const void* scales,
                                  const void* counts, void* out, void* partial, int E,
                                  int M, int K, int N, int splits, int grid_splits, int bm,
                                  int bn, int cluster, int persist, int kblocked,
                                  int x_is_bf16, void* stream) {
  const int* cnt = static_cast<const int*>(counts);
  if (cluster > 0)
    return x_is_bf16 ? run_experts(x, packed, scales, cnt, out, E, M, K, N, splits, bm, bn,
                                   cluster, persist, kblocked, stream)
                     : (int)cudaErrorInvalidValue;
  return run(x, packed, scales, nullptr, cnt, out, partial, E, M, K, N, splits, grid_splits,
             bm, kblocked, x_is_bf16, stream);
}

// The unembedding: out (M, N) f32 = x (M, K) f32 against a table in either
// layout (kblocked: packed (K, N/2), scales (K/64, N, 8), Kp == K; tied:
// packed (N, Kp/2), scales (N, Kp/64, 8), K <= Kp). mt rows of x a block
// (1, 2, 4 or 8) and slices K splits (a divisor of 16 and of Kp/64): ops
// .unembed_plan. Returns cudaErrorInvalidValue for what it does not take,
// else cudaGetLastError().
extern "C" int msb_unembed(const void* x, const void* packed, const void* scales, void* out,
                           int M, int K, int Kp, int N, int kblocked, int round_bf16, int mt,
                           int slices, void* stream) {
  if (M < 0 || K < 1 || K > Kp || Kp % BK || N < 1 || slices < 1 || UN_WARPS % slices ||
      (Kp / BK) % slices || (kblocked && (K != Kp || N % 64 || round_bf16)))
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  auto* xx = static_cast<const float*>(x);
  auto* pk = static_cast<const uint8_t*>(packed);
  auto* sc = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mt) {
    case 1: return launch_unembed<1>(xx, pk, sc, o, M, K, Kp, N, kblocked, round_bf16, slices, s);
    case 2: return launch_unembed<2>(xx, pk, sc, o, M, K, Kp, N, kblocked, round_bf16, slices, s);
    case 4: return launch_unembed<4>(xx, pk, sc, o, M, K, Kp, N, kblocked, round_bf16, slices, s);
    case 8: return launch_unembed<8>(xx, pk, sc, o, M, K, Kp, N, kblocked, round_bf16, slices, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
