"""MSB optimization objective (paper Sec. 3.2): the prefix sums the solver
evaluates interval costs from. Port of ``repro.core.objective.prefix_sums``.
"""
from __future__ import annotations

import torch


_SCAN_BLOCK = 16


def _cumsum(v):
    """Cumulative sum along the last dim in a fixed association order:
    sequential within blocks of 16, block totals carried sequentially —
    the order XLA's CPU cumsum uses, so the solver's scales come out
    bit-identical to the reference's (``torch.cumsum`` sums in another
    order). Loops run over the 16 block positions, then over the blocks,
    vectorized over everything else (every block at once in the first)."""
    n = v.shape[-1]
    n_blk = -(-n // _SCAN_BLOCK)
    vb = torch.nn.functional.pad(v, (0, n_blk * _SCAN_BLOCK - n)).reshape(
        *v.shape[:-1], n_blk, _SCAN_BLOCK)
    acc = torch.empty_like(vb)
    run = torch.zeros_like(vb[..., 0])
    for k in range(_SCAN_BLOCK):
        run = run + vb[..., k]
        acc[..., k] = run
    carry = torch.zeros_like(run[..., 0])
    for b in range(n_blk):
        acc[..., b, :] += carry[..., None]
        carry = carry + run[..., b]
    return acc.reshape(*v.shape[:-1], n_blk * _SCAN_BLOCK)[..., :n]


def prefix_sums(sorted_mags):
    """Inclusive-exclusive prefix sums along the last dim:
    ``s1[..., i] = sum(v[..., :i])``, ``s2[..., i] = sum(v[..., :i]**2)``.

    Returns tensors one longer than ``v`` along the last dim (``s[..., 0]
    == 0``), so interval sums over ``[i, j)`` are ``s[..., j] - s[..., i]``.
    Batched over leading dims (the JAX version is vmapped instead).
    """
    v = sorted_mags
    z = torch.zeros(*v.shape[:-1], 1, dtype=v.dtype, device=v.device)
    s1 = torch.cat([z, _cumsum(v)], dim=-1)
    s2 = torch.cat([z, _cumsum(v * v)], dim=-1)
    return s1, s2
