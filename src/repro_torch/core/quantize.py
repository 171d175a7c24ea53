"""MSB quantized-tensor formats and the quantize/dequantize API.

Port of ``repro.core.quantize``: block-wise and per-tensor MSB, the
nearest-scale refine, double quantization of the scale table and the
storage accounting. The byte formats match the reference exactly:

* ``QTensor``: ``codes`` int8 in the weight's shape, ``code = sign *
  (level + 1)`` (0 for exact zeros); ``scales`` ``(..., last // block, g)``
  — one codebook row of ``g = 2^(bits-1)`` positive scales per block — or
  ``(1, g)`` per tensor (``block == -1``; ``(L, 1, g)`` for stacked layers).
* ``PackedQTensor``: two 4-bit codes per byte in matmul orientation
  ``(..., K, N_pad // 2)``, nibble ``(sign << 3) | level``, element ``2i``
  in the low nibble; scales n-blocked ``(..., K, N_pad // 64, 8)`` or
  k-blocked ``(K // 64, N_pad, 8)`` (the transposed unembedding). Exact
  zeros pack as ``+alpha_0``, as in the reference.

Leaves are plain dataclasses holding torch tensors; ``map_tensors`` walks a
params tree of dicts, tensors and these leaves.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import grouping, reference

PACK_BLOCK = 64      # MSB block size — matches the msb_matmul kernel
PACK_LEVELS = 8      # 2^(4-1) codebook entries per block


@dataclasses.dataclass(frozen=True)
class QTensor:
    """MSB-quantized tensor: int8 codes + per-block codebooks."""
    codes: torch.Tensor       # int8, logical shape of w
    scales: torch.Tensor      # (..., n_blocks_in_row, n_levels) f32
    bits: int                 # target bit-width b
    block: int                # block size (64) or -1 for per-tensor
    dtype: object             # dequantized dtype
    shard: Optional[str] = None

    @property
    def shape(self):
        return tuple(self.codes.shape)

    @property
    def n_levels(self):
        return self.scales.shape[-1]

    def dequantize(self):
        return dequantize(self)


@dataclasses.dataclass(frozen=True)
class PackedQTensor:
    """Kernel-layout MSB tensor: 4-bit codes two per byte + 3-D codebooks
    (see the module docstring for the two scale layouts). ``n`` is the
    logical width before the last dim was padded to a multiple of 64;
    padded columns carry zero scales and dequantize to exact 0."""
    packed: torch.Tensor      # uint8 (..., K, N_pad // 2)
    scales: torch.Tensor
    bits: int
    block: int
    dtype: object
    n: int
    kblocked: bool = False
    shard: Optional[str] = None

    @property
    def shape(self):
        return tuple(self.packed.shape[:-1]) + (self.n,)

    @property
    def n_pad(self):
        return self.packed.shape[-1] * 2

    def dequantize(self):
        return packed_dequantize(self)


def map_tensors(fn, tree):
    """Apply ``fn`` to every tensor of a params tree (nested dicts of
    tensors, ``QTensor`` and ``PackedQTensor`` leaves); returns a new tree."""
    if isinstance(tree, dict):
        return {k: map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, codes=fn(tree.codes),
                                   scales=fn(tree.scales))
    if isinstance(tree, PackedQTensor):
        return dataclasses.replace(tree, packed=fn(tree.packed),
                                   scales=fn(tree.scales))
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return tree


# Blocks per nearest-scale refine: its (blocks, bs, g) distance tensor is
# 16 KB per 64-element 4-bit block.
REFINE_CHUNK = 32768


def _solve(blocks, g, solver, lam, iters):
    """(levels (nb, bs) int32, scales (nb, g) f32) on the blocks' device.
    ``dp``/``kmeans``/``wdp`` solve there; the paper's CPU solvers run the
    numpy reference per block in float64 on the host."""
    if solver in ("dp", "kmeans", "wdp"):
        return grouping.solve_blocks(blocks, g, method=solver, lam=lam,
                                     iters=iters)
    if solver in ("wgm", "gg", "dg", "wgm_lo"):
        blocks_np = blocks.detach().cpu().numpy().astype(np.float64)
        levels = np.zeros(blocks_np.shape, dtype=np.int32)
        scales = np.zeros((blocks_np.shape[0], g), dtype=np.float32)
        for i, blk in enumerate(blocks_np):
            if solver == "gg":
                b, order = reference.greedy_grouping(blk, g, lam=lam)
            elif solver == "dg":
                b, order, _ = reference.dynamic_grouping(blk, g, lam=lam)
            elif solver == "wgm_lo":
                b, order = reference.wgm_local_opt(blk, g, lam=lam)
            else:
                w = max(1, blk.size // 256) if blk.size > 4096 else 1
                b, order = reference.windowed_greedy_merging(blk, g, window=w,
                                                             lam=lam)
            _, lv, sc = reference.reconstruct(blk, b, order, n_levels=g)
            levels[i] = lv
            scales[i, : len(sc)] = sc
        return (torch.from_numpy(levels).to(blocks.device),
                torch.from_numpy(scales).to(blocks.device))
    raise ValueError(f"unknown solver: {solver}")


def _nearest_refine(blocks, levels, scales):
    """Re-encode each weight to the *nearest* codebook scale (the first on
    a tie). Empty groups carry scale 0 and are excluded unless the weight
    is 0. A no-op at the DP optimum; improves the heuristic solvers.
    Chunked over blocks to bound the (blocks, bs, g) distance tensor."""
    out = torch.empty_like(levels)
    for i in range(0, blocks.shape[0], REFINE_CHUNK):
        mags = torch.abs(blocks[i:i + REFINE_CHUNK])
        sc = scales[i:i + REFINE_CHUNK]
        d = torch.abs(mags[:, :, None] - sc[:, None, :])
        valid = (sc > 0)[:, None, :] | (mags[:, :, None] == 0)
        d = torch.where(valid, d, torch.full_like(d, float("inf")))
        out[i:i + REFINE_CHUNK] = torch.argmin(d, dim=-1).to(levels.dtype)
    return out


def quantize_blockwise(w, bits=4, block=64, solver="dp", lam=0.0, iters=30,
                       scale_dtype=torch.float32, refine=False):
    """Block-wise MSB quantization along the last axis (64-element groups
    per row), solved on ``w``'s device. Last axis must divide by ``block``.
    ``iters`` reaches the kmeans solver; ``refine`` re-encodes each weight
    to its nearest codebook scale (no-op for the exact DP).
    """
    if w.shape[-1] % block:
        raise ValueError(f"last dim {w.shape[-1]} not divisible by block "
                         f"{block}")
    g = 2 ** (bits - 1)
    blocks = w.reshape(-1, block).to(torch.float32)
    levels, scales = _solve(blocks, g, solver, lam, iters)
    if refine:
        levels = _nearest_refine(blocks, levels, scales)
    signs = torch.sign(blocks).to(torch.int8)
    codes = (signs * (levels.to(torch.int8) + 1)).reshape(w.shape)
    scales = scales.reshape(*w.shape[:-1], w.shape[-1] // block, g)
    return QTensor(codes, scales.to(scale_dtype), bits, block, w.dtype)


def quantize_pertensor(w, bits=6, solver="wdp", lam=0.0, iters=50,
                       scale_dtype=torch.float32):
    """6-bit (default) per-tensor MSB quantization: one codebook for the
    whole of ``w``, solved on its device; scales come out ``(1, g)``."""
    g = 2 ** (bits - 1)
    flat = w.reshape(1, -1).to(torch.float32)
    levels, scales = _solve(flat, g, solver, lam, iters)
    signs = torch.sign(flat).to(torch.int8)
    codes = (signs * (levels.to(torch.int8) + 1)).reshape(w.shape)
    return QTensor(codes, scales.to(scale_dtype), bits, -1, w.dtype)


def dequantize(q: QTensor):
    """w_hat = sign(code) * scales[block, |code| - 1]; exact 0 for code 0.

    Works for any scales layout (..., g): each scale row covers
    codes.numel() / n_rows consecutive codes (64 block-wise, a whole matrix
    per-tensor, a layer slice for stacked per-tensor params)."""
    g = q.scales.shape[-1]
    rows = q.scales.numel() // g
    blocks = q.codes.reshape(rows, -1)
    lv = torch.abs(blocks.to(torch.int64))
    scales2d = q.scales.reshape(rows, g).to(torch.float32)
    mag = torch.gather(scales2d, 1, torch.clamp(lv - 1, min=0))
    mag = torch.where(lv > 0, mag, torch.zeros_like(mag))
    out = torch.sign(blocks).to(torch.float32) * mag
    return out.reshape(q.codes.shape).to(q.dtype)


# ---------------------------------------------------------------------------
# int4 packing
# ---------------------------------------------------------------------------

def pack_codes_int4(codes):
    """Pack 4-bit MSB codes two per byte: nibble ``(sign_bit << 3) |
    level``; element 2i -> low nibble, 2i+1 -> high nibble. Exact zeros
    pack as level 0, sign + (they come back as +alpha_0)."""
    flat = codes.reshape(-1).to(torch.int32)
    if flat.shape[0] % 2:
        raise ValueError("packing requires an even element count")
    lv = torch.clamp(torch.abs(flat) - 1, min=0)
    sign_bit = (flat < 0).to(torch.int32)
    nib = (sign_bit << 3) | lv
    lo, hi = nib[0::2], nib[1::2]
    return ((hi << 4) | lo).to(torch.uint8)


def unpack_codes_int4(packed, shape):
    p = packed.to(torch.int32)
    nib = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(-1)
    lv = (nib & 0x7).to(torch.int8) + 1
    sign = torch.where(((nib >> 3) & 1) > 0, -1, 1).to(torch.int8)
    return (sign * lv).reshape(shape)


def _pad_last(a, to):
    pad = (-a.shape[-1]) % to
    if not pad:
        return a
    return torch.nn.functional.pad(a, (0, pad))


def pack_qtensor(q: QTensor, *, transpose=False) -> PackedQTensor:
    """QTensor -> kernel storage layout, once at load time.

    ``transpose=True`` packs a 2-D ``(V, D)`` table as its transpose
    ``(D, V)`` with k-blocked scales (unembedding orientation). Requires
    4-bit block-64 quantization; N not divisible by 64 is padded with
    zero-scale columns."""
    if q.bits != 4 or q.block != PACK_BLOCK:
        raise ValueError(f"packing needs 4-bit block-{PACK_BLOCK} "
                         f"quantization, got {q.bits}-bit block {q.block}")
    codes, scales = q.codes, q.scales
    if transpose:
        if codes.dim() != 2:
            raise ValueError("transpose packing is for 2-D tables")
        v = codes.shape[0]
        codes = _pad_last(codes.t().contiguous(), PACK_BLOCK)    # (D, V_pad)
        n = v
        scales = scales.transpose(0, 1)                  # (D//64, V, 8)
        pad = codes.shape[-1] - v
        if pad:
            scales = torch.nn.functional.pad(scales, (0, 0, 0, pad))
    else:
        n = codes.shape[-1]
        codes = _pad_last(codes, PACK_BLOCK)
        pad_blocks = (codes.shape[-1] - n) // PACK_BLOCK
        if pad_blocks:
            scales = torch.nn.functional.pad(scales, (0, 0, 0, pad_blocks))
    n_pad = codes.shape[-1]
    packed = pack_codes_int4(codes).reshape(*codes.shape[:-1], n_pad // 2)
    return PackedQTensor(packed, scales.contiguous(), q.bits, q.block,
                         q.dtype, n, kblocked=transpose)


def _unpack_nibbles(packed):
    """uint8 (..., half) -> (level int64, sign f32), both (..., 2*half)."""
    p = packed.to(torch.int32)
    nib = torch.stack([p & 0xF, (p >> 4) & 0xF], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)
    level = (nib & 0x7).to(torch.int64)
    sign = (1 - 2 * ((nib >> 3) & 1)).to(torch.float32)
    return level, sign


def packed_dequantize(pq: PackedQTensor):
    """Dense weights in matmul orientation ``(..., K, n)``, with the same
    f32 gather math as ``dequantize``."""
    level, sign = _unpack_nibbles(pq.packed)        # (..., K, N_pad)
    n_pad = level.shape[-1]
    sc = pq.scales.to(torch.float32)
    if pq.kblocked:
        k = level.shape[-2]
        lv = level.reshape(*level.shape[:-2], k // PACK_BLOCK, PACK_BLOCK,
                           n_pad)
        lvb = lv.transpose(-1, -2)                  # (..., K//64, N_pad, 64)
        magb = torch.gather(sc, -1, lvb)
        mag = magb.transpose(-1, -2).reshape(level.shape)
    else:
        lv = level.reshape(*level.shape[:-1], n_pad // PACK_BLOCK,
                           PACK_BLOCK)
        mag = torch.gather(sc, -1, lv).reshape(level.shape)
    w = sign * mag
    return w[..., :pq.n].to(pq.dtype)


def packed_gather(pq: PackedQTensor, idx):
    """Rows ``idx`` of a natural-orientation packed table, dequantized —
    only the gathered rows are unpacked (the embedding lookup)."""
    if pq.kblocked:
        raise ValueError("packed_gather needs natural (n-blocked) layout")
    idx = idx.to(torch.int64)
    rows = pq.packed[idx]                            # (..., N_pad//2)
    srow = pq.scales[idx].to(torch.float32)          # (..., N_pad//64, 8)
    level, sign = _unpack_nibbles(rows)
    n_pad = level.shape[-1]
    lv = level.reshape(*level.shape[:-1], n_pad // PACK_BLOCK, PACK_BLOCK)
    mag = torch.gather(srow, -1, lv).reshape(level.shape)
    return (sign * mag)[..., :pq.n].to(pq.dtype)


# ---------------------------------------------------------------------------
# KV-page codec (serving path; DESIGN.md Sec. 15)
#
# Port of ``repro.core.quantize``'s KV codec: MSB block-wise quantization of
# *committed* KV-cache pages. One (page_size, head_dim) payload per KV head
# splits into groups of at most KV_BLOCK elements covering whole token rows,
# each with its own codebook (4-bit: an 8-entry codebook from the exact DP;
# 8-bit: one absmax with sign-magnitude int8 codes). Codes and scales are
# byte-identical to the reference's on tie-free inputs.
# ---------------------------------------------------------------------------

KV_BLOCK = 128       # max elements per KV quantization group
# Blocks per DP solve in the 4-bit commit: at a 128-element group each
# block's (n+1)^2 f32 cost tensor is 66.6 KB and about six such tensors are
# alive at once, so 4096 blocks bound a solve at ~1.6 GB.
KV_DP_CHUNK = 4096


def _kv_tokens_per_block(page_size, head_dim):
    """Token rows per group: whole-hd rows, <= KV_BLOCK elements, dividing
    the page."""
    tpb = max(1, min(int(page_size), KV_BLOCK // int(head_dim)))
    while page_size % tpb:
        tpb -= 1
    return tpb


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """Shape/byte schema of a quantized KV page pool. ``kv_heads`` is the
    head count of the pool (grouping is per head)."""
    bits: int            # 8 or 4 (16 = unquantized native pools, no spec)
    page_size: int
    kv_heads: int
    head_dim: int

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError(f"kv_bits must be 4 or 8, got {self.bits}")
        if self.bits == 4 and self.head_dim % 2:
            raise ValueError("4-bit KV packing needs an even head_dim")

    @property
    def tokens_per_block(self):
        return _kv_tokens_per_block(self.page_size, self.head_dim)

    @property
    def block(self):
        return self.tokens_per_block * self.head_dim

    @property
    def n_blocks(self):
        return self.page_size // self.tokens_per_block

    @property
    def n_levels(self):
        return 2 ** (self.bits - 1) if self.bits == 4 else 1

    @property
    def code_dtype(self):
        return torch.uint8 if self.bits == 4 else torch.int8

    @property
    def codes_tail(self):
        """Trailing dims of the codes leaf for one page."""
        hd = self.head_dim // 2 if self.bits == 4 else self.head_dim
        return (self.page_size, self.kv_heads, hd)

    @property
    def scales_tail(self):
        return (self.kv_heads, self.n_blocks, self.n_levels)

    @property
    def scale_dtype(self):
        # 4-bit keeps 16-bit codebook entries; the 8-bit absmax is one f32
        # per group
        return torch.bfloat16 if self.bits == 4 else torch.float32

    def page_bytes(self):
        """Allocated bytes per page per K-or-V tensor (one layer period)."""
        codes = math.prod(self.codes_tail)
        scales = (math.prod(self.scales_tail)
                  * torch.empty(0, dtype=self.scale_dtype).element_size())
        return codes + scales


def kv_native_page_bytes(page_size, kv_heads, head_dim, dtype):
    """Pool bytes per page per K-or-V tensor at ``kv_bits=16`` (native)."""
    return (int(page_size) * int(kv_heads) * int(head_dim)
            * torch.empty(0, dtype=dtype).element_size())


def _kv_to_blocks(x, tpb):
    """(..., ps, kv, hd) -> (..., kv, n_blocks, tpb*hd)."""
    *lead, ps, kv, hd = x.shape
    y = x.reshape(*lead, ps // tpb, tpb, kv, hd)
    y = torch.movedim(y, -2, -4)                 # (..., kv, nb, tpb, hd)
    return y.reshape(*lead, kv, ps // tpb, tpb * hd)


def _kv_from_blocks(y, tpb, head_dim):
    """(..., kv, n_blocks, tpb*hd) -> (..., ps, kv, hd)."""
    *lead, kv, nb, _ = y.shape
    y = y.reshape(*lead, kv, nb, tpb, head_dim)
    y = torch.movedim(y, -4, -2)                 # (..., nb, tpb, kv, hd)
    return y.reshape(*lead, nb * tpb, kv, head_dim)


def kv_quantize_pages(x, bits):
    """Quantize KV pages. x: (..., page_size, KV, head_dim) f32/bf16.

    Returns ``(codes, scales)``:
      * 4-bit: codes uint8 (..., ps, KV, hd//2) — two nibbles per byte,
        ``(sign << 3) | level`` with element 2i in the low nibble; scales
        bf16 (..., KV, n_blocks, 8), the per-group DP codebook (solved in
        f32, rounded to bf16 after the solve).
      * 8-bit: codes int8 (..., ps, KV, hd) ``round(x * 127 / absmax)``;
        scales f32 (..., KV, n_blocks, 1) holding the group absmax.

    Both come back contiguous. Deterministic: the same page bytes give the
    same code bytes.
    """
    *lead, ps, kv, hd = x.shape
    tpb = _kv_tokens_per_block(ps, hd)
    nb, blk = ps // tpb, tpb * hd
    blocks = _kv_to_blocks(x.to(torch.float32), tpb)     # (..., kv, nb, blk)
    if bits == 8:
        amax = torch.amax(torch.abs(blocks), dim=-1, keepdim=True)
        q = torch.clamp(torch.round(
            blocks * (127.0 / torch.clamp(amax, min=1e-30))), -127.0, 127.0)
        codes = _kv_from_blocks(q, tpb, hd).to(torch.int8)
        return codes.contiguous(), amax.contiguous()
    if bits != 4:
        raise ValueError(f"kv_bits must be 4 or 8, got {bits}")
    g = 8
    levels, scales = grouping.solve_blocks(blocks.reshape(-1, blk), g,
                                           method="dp", chunk=KV_DP_CHUNK)
    levels = levels.reshape(blocks.shape)
    scales = scales.reshape(*lead, kv, nb, g).to(torch.bfloat16)
    nib = torch.where(blocks < 0, levels | 8, levels)   # sign<<3 | level
    nib = _kv_from_blocks(nib, tpb, hd)                 # (..., ps, kv, hd)
    pair = nib.reshape(*nib.shape[:-1], hd // 2, 2)
    codes = ((pair[..., 1] << 4) | pair[..., 0]).to(torch.uint8)
    return codes.contiguous(), scales.contiguous()



def kv_dequantize_pages(codes, scales, bits, dtype):
    """Inverse of ``kv_quantize_pages`` -> (..., ps, KV, hd) in ``dtype``."""
    if bits == 8:
        *_, ps, kv, hd = codes.shape
        tpb = _kv_tokens_per_block(ps, hd)
        blocks = _kv_to_blocks(codes.to(torch.float32), tpb)
        out = blocks * (scales.to(torch.float32) / 127.0)
        return _kv_from_blocks(out, tpb, hd).to(dtype)
    if bits != 4:
        raise ValueError(f"kv_bits must be 4 or 8, got {bits}")
    *lead, ps, kv, hdc = codes.shape
    hd = hdc * 2
    tpb = _kv_tokens_per_block(ps, hd)
    p32 = codes.to(torch.int32)
    nib = torch.stack([p32 & 0xF, (p32 >> 4) & 0xF],
                      dim=-1).reshape(*lead, ps, kv, hd)
    nb_ = _kv_to_blocks(nib, tpb)                       # (..., kv, nb, blk)
    level = (nb_ & 0x7).to(torch.int64)
    sign = (1 - 2 * ((nb_ >> 3) & 1)).to(torch.float32)
    mag = torch.gather(scales.to(torch.float32), -1, level)
    return _kv_from_blocks(sign * mag, tpb, hd).to(dtype)


# ---------------------------------------------------------------------------
# Tensor-parallel padding (DESIGN.md Sec. 10)
#
# Sharding a quantized matmul dim across ranks needs every rank's slice to
# hold whole 64-element MSB blocks (N) or whole rows (K). When the stored
# width does not divide, the storage is widened with exact-zero columns or
# rows (zero scales for packed codes, code 0 for int8 codes), which add
# nothing to any matmul: the padded tree computes the same function as the
# original on every path, sharded or not.
# ---------------------------------------------------------------------------

def _pad_axis(a, axis, to):
    cur = a.shape[axis]
    if cur == to:
        return a
    shape = list(a.shape)
    shape[axis] = to
    out = a.new_zeros(shape)
    out.narrow(axis, 0, cur).copy_(a)
    return out


def tp_pad_packed_n(pq: PackedQTensor, n_to: int) -> PackedQTensor:
    """Widen a PackedQTensor's stored N to ``n_to`` with zero-scale columns;
    ``n`` is rebound to ``n_to``. The padded columns dequantize to exact 0
    (extra all-zero features: harmless for an MLP hidden dim, masked for a
    vocab dim), and a K-padded row-parallel partner lines up with them."""
    if n_to % pq.block:
        raise ValueError(f"n_to={n_to} must be a multiple of {pq.block}")
    if pq.n_pad > n_to:
        raise ValueError(f"cannot shrink storage {pq.n_pad} -> {n_to}")
    packed = _pad_axis(pq.packed, pq.packed.dim() - 1, n_to // 2)
    sd = pq.scales.dim()
    scales = _pad_axis(pq.scales, sd - 2,
                       n_to if pq.kblocked else n_to // PACK_BLOCK)
    return dataclasses.replace(pq, packed=packed, scales=scales, n=n_to)


def tp_pad_packed_k(pq: PackedQTensor, k_to: int) -> PackedQTensor:
    """Widen a PackedQTensor's K (row) dim to ``k_to`` with zero-scale
    rows."""
    if pq.kblocked:
        raise ValueError("K-padding needs the natural n-blocked layout")
    if pq.packed.shape[-2] > k_to:
        raise ValueError(f"cannot shrink K {pq.packed.shape[-2]} -> {k_to}")
    return dataclasses.replace(
        pq, packed=_pad_axis(pq.packed, pq.packed.dim() - 2, k_to),
        scales=_pad_axis(pq.scales, pq.scales.dim() - 3, k_to))


def tp_pad_q_n(q: QTensor, n_to: int) -> QTensor:
    """Widen a block-wise QTensor's last (output) dim with zero-code
    columns."""
    if n_to % q.block:
        raise ValueError(f"n_to={n_to} must be a multiple of block {q.block}")
    return dataclasses.replace(
        q, codes=_pad_axis(q.codes, q.codes.dim() - 1, n_to),
        scales=_pad_axis(q.scales, q.scales.dim() - 2, n_to // q.block))


def tp_pad_q_k(q: QTensor, k_to: int) -> QTensor:
    """Widen a block-wise QTensor's second-to-last (row) dim with zero
    rows."""
    return dataclasses.replace(
        q, codes=_pad_axis(q.codes, q.codes.dim() - 2, k_to),
        scales=_pad_axis(q.scales, q.scales.dim() - 3, k_to))


# ---------------------------------------------------------------------------
# Double quantization (paper Appendix G)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DQScales:
    """Scales quantized once more with MSB at 6 bits over 2048-blocks."""
    q: QTensor
    shape: tuple

    def dequantize(self):
        return self.q.dequantize().reshape(self.shape)


def double_quantize(q: QTensor, bits=6, block=2048, solver="kmeans"):
    """Quantize the scale table itself (recursive MSB), per Appendix G: the
    flattened table, zero-padded to a multiple of ``block``, is quantized
    block-wise and dequantized back; the result carries the round-tripped
    scales in the table's shape.

    Storage: 4 + 8*6.25/64 ~ 4.78 bits/weight for the default setting.
    """
    scales = q.scales.reshape(-1)
    pad = (-scales.shape[0]) % block
    padded = torch.cat([scales, scales.new_zeros(pad)])
    sq = quantize_blockwise(padded.reshape(-1, block), bits=bits,
                            block=block, solver=solver)
    return dataclasses.replace(
        q, scales=sq.dequantize().reshape(-1)[: scales.shape[0]]
        .reshape(q.scales.shape))


# ---------------------------------------------------------------------------
# Storage accounting (paper Sec. 4.1)
# ---------------------------------------------------------------------------

def storage_bits_per_weight(q, double_quant=False,
                            scale_bits=16, dq_bits=6, dq_block=2048):
    """Effective bits/weight incl. codebook metadata.

    4-bit block-64, bf16 scales: 4 + 8*16/64 = 6.00 (paper).  With DQ:
    4 + 8*(6 + 32*16/2048)/64 = 4.78 (paper App. G). Per-tensor: ~b bits.

    For a ``PackedQTensor`` the answer is the *real allocated footprint*
    (uint8 codes + scale table, incl. any N-padding) over the logical
    element count — what device memory actually holds, not the formula.
    """
    if isinstance(q, PackedQTensor):
        n = float(math.prod(q.shape))
        scale_bits = q.scales.element_size() * 8
        return (q.packed.numel() * 8 + q.scales.numel() * scale_bits) / n
    n = float(math.prod(q.shape))
    if q.block == -1:
        return q.bits + q.n_levels * scale_bits / n
    per_scale = ((dq_bits + 32 * scale_bits / dq_block) if double_quant
                 else scale_bits)
    return q.bits + q.n_levels * per_scale / q.block
