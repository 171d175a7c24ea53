"""Gradient compression with error feedback (port of
``repro.train.compression``).

``ef_compress`` / ``ef_decompress`` are the pure int8 codec: q =
round(g / s) with a per-block-256 absmax scale, and the quantization
residual carried to the next step so the compression error telescopes.
The reference's ``psum_compressed`` all-reduces the codes across a mesh
axis; it needs a collective and belongs to ROADMAP item 11.
"""
from __future__ import annotations

import torch


def ef_compress(grad, residual, block=256):
    """(grad + residual) -> (int8 codes (n_blocks, block), f32 scales
    (n_blocks,), new residual shaped like grad)."""
    g = grad.to(torch.float32) + residual
    flat = g.reshape(-1)
    pad = (-flat.shape[0]) % block
    fp = torch.cat([flat, flat.new_zeros((pad,))]).reshape(-1, block)
    scale = torch.amax(torch.abs(fp), dim=1) * (1.0 / 127.0)  # as XLA's
    q = torch.round(fp / torch.clamp(scale, min=1e-20)[:, None])
    q = torch.clamp(q, -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale[:, None]
    new_residual = (fp - deq).reshape(-1)[: flat.shape[0]].reshape(g.shape)
    return q, scale, new_residual


def ef_decompress(q, scale, shape):
    deq = q.to(torch.float32) * scale[:, None]
    n = 1
    for s in shape:
        n *= s
    return deq.reshape(-1)[:n].reshape(shape)
