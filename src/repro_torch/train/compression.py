"""Gradient compression with error feedback (port of
``repro.train.compression``).

``ef_compress`` / ``ef_decompress`` are the pure int8 codec: q =
round(g / s) with a per-block-256 absmax scale, and the quantization
residual carried to the next step so the compression error telescopes.
``psum_compressed`` all-reduces the codes across the ranks of a mesh
axis (the reference's pod-axis reduce under ``shard_map``): the scales'
max over the ranks, the codes renormalized to it, summed in int32, and
rescaled to the mean.
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


def psum_compressed(grad, residual, axis, block=256, *, ctx):
    """Error-feedback int8 all-reduce over the ranks along ``axis`` (a
    mesh axis name or tuple) of ``ctx``, a rank's ``ParallelContext``:
    (the mean of every rank's grad as the codes carry it, this rank's new
    residual). int8 codes are summed in int32 (exact for <= 2^23
    summands), after renormalizing each rank's codes to the max scale over
    the ranks, and rescaled by it: one shared scale a block, so the wire
    holds one byte an element."""
    from ..parallel import sharding as shd
    q, scale, new_residual = ef_compress(grad, residual, block)
    smax = shd.raw_pmax(ctx, scale, axis)
    ratio = scale / torch.clamp(smax, min=1e-20)
    qr = torch.round(q.to(torch.float32) * ratio[:, None]).to(torch.int32)
    tot = shd.raw_psum(ctx, qr, axis)
    avg = (tot.to(torch.float32) * smax[:, None]) / float(ctx.size(axis))
    size = 1
    for s in grad.shape:
        size *= s
    return avg.reshape(-1)[:size].reshape(grad.shape), new_residual
