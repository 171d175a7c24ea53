"""Plain PyTorch version of the msb_matmul kernel (the CPU path, and what
the kernel is held against on the card). Port of
``repro.kernels.msb_matmul.ref``: the nibble decode and per-block scale
gather are the storage format's own ``packed_dequantize``."""
from __future__ import annotations

import torch

from ...core.quantize import (PACK_BLOCK, PACK_LEVELS, PackedQTensor,
                              _unpack_nibbles, packed_dequantize)

BLOCK, LEVELS = PACK_BLOCK, PACK_LEVELS     # the reference's names


def unpack_ref(packed, n):
    """uint8 (K, N/2) -> (level (K, n) int32, sign (K, n) f32)."""
    level, sign = _unpack_nibbles(packed)
    return level[:, :n].to(torch.int32), sign[:, :n]


def dequant_ref(packed, scales, kblocked=False):
    """uint8 (K, N/2) + codebooks -> (K, N) f32 weights.

    scales: (K, N/64, 8) n-blocked, or (K/64, N, 8) k-blocked."""
    n = packed.shape[-1] * 2
    pq = PackedQTensor(packed, scales, 4, PACK_BLOCK, torch.float32, n,
                       kblocked=kblocked)
    return packed_dequantize(pq)


def msb_matmul_ref(x, packed, scales, bias=None, kblocked=False):
    """y = x @ dequant(W) (+ bias): weights rounded to x's type, products
    summed in f32, output in x's type. x (M, K); returns (M, N)."""
    w = dequant_ref(packed, scales, kblocked=kblocked).to(x.dtype)
    y = x.to(torch.float32) @ w.to(torch.float32)
    if bias is not None:
        y = y + bias.reshape(1, -1).to(torch.float32)
    return y.to(x.dtype)


def msb_matmul_experts_ref(x, packed, scales, counts, kblocked=False):
    """The expert batch: ``msb_matmul_ref`` of each expert's x (E, M, K)
    and weights (E, K, N/2), then zeros where ``counts`` (E,) is 0 (the
    reference's zero branch). Returns (E, M, N)."""
    y = torch.stack([msb_matmul_ref(x[e], packed[e], scales[e],
                                    kblocked=kblocked)
                     for e in range(x.shape[0])])
    return torch.where((counts > 0)[:, None, None], y, torch.zeros_like(y))


def msb_unembed_ref(x, pq: PackedQTensor):
    """The unembedding's logits in f32, x (M, D): a k-blocked table
    through ``msb_matmul_ref`` (weights in f32), sliced to its ``n``
    outputs; a tied n-blocked table as ``x @ dequant(table).t()``, its
    weights rounded to the table's dtype as ``dequantize`` gives them."""
    x = x.to(torch.float32)
    if pq.kblocked:
        return msb_matmul_ref(x.contiguous(), pq.packed, pq.scales,
                              kblocked=True)[:, :pq.n]
    return x @ packed_dequantize(pq).to(torch.float32).t()
