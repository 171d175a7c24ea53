"""MSB block-wise quantization and its 4-bit storage format, in plain PyTorch.

Frozen copy of src/repro_torch/core/{objective,grouping,quantize}.py at
commit 82f904d (the exact DP over sorted magnitudes, paper Alg. 1, with
the cumulative sums in XLA's association order; the codes, the int4
packing and its dequantization). The benchmark holds the program's
quantized weights against what this file works out again from the same
raw weights, so it imports nothing of the program.

Codes: ``sign * (level + 1)``; scales ``(..., last // 64, 8)`` f32, one
codebook of 8 positive scales per 64-element block. Packed: two codes a
byte, nibble ``(sign << 3) | level``, element 2i in the low nibble; a
natural (n-blocked) leaf keeps its orientation, the untied unembedding
packs transposed with k-blocked scales. Exact zeros pack as ``+alpha_0``.
"""
from __future__ import annotations

import torch

BLOCK = 64
LEVELS = 8
_SCAN = 16


def _sequential_cumsum(v):
    acc = torch.empty_like(v)
    run = torch.zeros_like(v[..., 0])
    for k in range(v.shape[-1]):
        run = run + v[..., k]
        acc[..., k] = run
    return acc


def _cumsum(v):
    """Sequential within blocks of 16, each block offset by the running sum
    of the block totals taken the same way (XLA's CPU order)."""
    n = v.shape[-1]
    if n <= _SCAN:
        return _sequential_cumsum(v)
    n_blk = -(-n // _SCAN)
    vb = torch.nn.functional.pad(v, (0, n_blk * _SCAN - n)).reshape(
        *v.shape[:-1], n_blk, _SCAN)
    acc = _sequential_cumsum(vb)
    carry = _cumsum(acc[..., -1])[..., :-1]
    acc[..., 1:, :] += carry[..., None]
    return acc.reshape(*v.shape[:-1], n_blk * _SCAN)[..., :n]


def _prefix_sums(v):
    z = torch.zeros(*v.shape[:-1], 1, dtype=v.dtype, device=v.device)
    return torch.cat([z, _cumsum(v)], -1), torch.cat([z, _cumsum(v * v)], -1)


def _interval_costs(v):
    """C[b, i, j]: squared error of the sorted interval [i, j) around its
    mean; +inf where j <= i. (B, n) -> (B, n + 1, n + 1)."""
    s1, s2 = _prefix_sums(v)
    cnt = torch.arange(v.shape[-1] + 1, device=v.device).to(v.dtype)
    m = cnt[None, :] - cnt[:, None]
    d1 = s1[:, None, :] - s1[:, :, None]
    d2 = s2[:, None, :] - s2[:, :, None]
    c = d2 - d1 * d1 / torch.clamp(m, min=1.0)
    return torch.where(m >= 1.0, c, torch.full_like(c, float("inf")))


def dp_boundaries(v, g):
    """The exact DP: boundaries (B, g + 1) of ``min(g, n)`` groups over the
    sorted magnitudes ``v`` (B, n); the first minimum wins a tie."""
    bsz, n = v.shape
    C = _interval_costs(v)
    D = C[:, 0, :]
    args = [torch.zeros_like(D, dtype=torch.int64)]
    for _ in range(1, g):
        D, A = torch.min(D[:, :, None] + C, dim=1)
        args.append(A)
    args = torch.stack(args, 1)
    k_star = torch.full((bsz,), min(g, n), dtype=torch.int64, device=v.device)
    rows = torch.arange(bsz, device=v.device)
    step = torch.arange(g, device=v.device)
    table = torch.clamp(k_star[:, None] - 1 - step, min=0)
    steps = table.t().contiguous()
    j = torch.full((bsz,), n, dtype=torch.int64, device=v.device)
    walk = []
    for t in range(g):
        j = args[rows, steps[t], j]
        walk.append(j)
    walk = torch.stack(walk, 1)
    inner = torch.where(step < k_star[:, None], torch.gather(walk, 1, table),
                        torch.full_like(walk, n))
    bounds = torch.cat([inner, inner.new_full((bsz, 1), n)], 1)
    bounds[:, 0] = 0
    return bounds


def _solve(blocks, g):
    """(levels (B, bs) int32 in element order, scales (B, g) f32)."""
    a = blocks.to(torch.float32)
    v, order = torch.sort(torch.abs(a), dim=-1, stable=True)
    bounds = dp_boundaries(v, g)
    n = v.shape[-1]
    pos = torch.arange(n, device=v.device).expand(v.shape[0], n)
    lv_sorted = torch.searchsorted(bounds[:, 1:-1].contiguous(),
                                   pos.contiguous(), right=True,
                                   out_int32=True)
    s1, _ = _prefix_sums(v)
    cnt = (bounds[:, 1:] - bounds[:, :-1]).to(v.dtype)
    sums = torch.gather(s1, 1, bounds[:, 1:]) - torch.gather(s1, 1,
                                                             bounds[:, :-1])
    scales = torch.where(cnt > 0, sums / torch.clamp(cnt, min=1.0),
                         torch.zeros_like(sums))
    levels = torch.empty_like(lv_sorted).scatter_(1, order, lv_sorted)
    return levels, scales


def quantize(w, bits=4, block=BLOCK, chunk=32768):
    """Block-wise MSB of ``w`` along its last dim: (codes int8 in w's
    shape, scales (..., last // block, g) f32)."""
    g = 2 ** (bits - 1)
    blocks = w.reshape(-1, block).to(torch.float32)
    lv, sc = [], []
    for i in range(0, blocks.shape[0], chunk):
        a, b = _solve(blocks[i:i + chunk], g)
        lv.append(a)
        sc.append(b)
    levels, scales = torch.cat(lv), torch.cat(sc)
    codes = (torch.sign(blocks).to(torch.int8)
             * (levels.to(torch.int8) + 1)).reshape(w.shape)
    return codes, scales.reshape(*w.shape[:-1], w.shape[-1] // block, g)


def _pad_last(a, to):
    pad = (-a.shape[-1]) % to
    return torch.nn.functional.pad(a, (0, pad)) if pad else a


def pack(codes, scales, transpose=False):
    """(packed uint8 (..., K, N_pad // 2), scales, n) in kernel layout;
    ``transpose`` packs a (V, D) table as (D, V_pad) with k-blocked
    scales (D // 64, V_pad, 8)."""
    if transpose:
        v = codes.shape[0]
        codes = _pad_last(codes.t().contiguous(), BLOCK)
        n = v
        scales = scales.transpose(0, 1)
        pad = codes.shape[-1] - v
        if pad:
            scales = torch.nn.functional.pad(scales, (0, 0, 0, pad))
    else:
        n = codes.shape[-1]
        codes = _pad_last(codes, BLOCK)
        pad_blocks = (codes.shape[-1] - n) // BLOCK
        if pad_blocks:
            scales = torch.nn.functional.pad(scales, (0, 0, 0, pad_blocks))
    flat = codes.reshape(-1).to(torch.int32)
    nib = ((flat < 0).to(torch.int32) << 3) | torch.clamp(
        torch.abs(flat) - 1, min=0)
    packed = ((nib[1::2] << 4) | nib[0::2]).to(torch.uint8).reshape(
        *codes.shape[:-1], codes.shape[-1] // 2)
    return packed, scales.contiguous(), n


def unpack(packed, scales, n, kblocked=False):
    """Dense f32 weights in matmul orientation (..., K, n) of a packed
    leaf: sign * scales[block, level]."""
    p = packed.to(torch.int32)
    nib = torch.stack([p & 0xF, (p >> 4) & 0xF], -1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)
    level = (nib & 0x7).to(torch.int64)
    sign = (1 - 2 * ((nib >> 3) & 1)).to(torch.float32)
    n_pad = level.shape[-1]
    sc = scales.to(torch.float32)
    if kblocked:
        k = level.shape[-2]
        lv = level.reshape(*level.shape[:-2], k // BLOCK, BLOCK, n_pad)
        mag = torch.gather(sc, -1, lv.transpose(-1, -2)).transpose(
            -1, -2).reshape(level.shape)
    else:
        lv = level.reshape(*level.shape[:-1], n_pad // BLOCK, BLOCK)
        mag = torch.gather(sc, -1, lv).reshape(level.shape)
    return (sign * mag)[..., :n]
