"""Exact MSB dynamic-grouping DP (paper Alg. 1), batched over blocks.

Port of the ``"dp"`` method of ``repro.core.grouping``. The JAX version
vmaps a per-block solver; here every function takes a leading batch dim of
blocks and runs as dense tensor ops on whatever device the weights are on
(on the card this is plain PyTorch: the solver was never a Pallas kernel).

All functions operate on *sorted magnitudes* ``v`` of shape ``(B, n)`` and
boundary indices ``b`` of shape ``(B, g + 1)`` with ``b[:, 0] = 0`` and
``b[:, g] = n``; group ``z`` covers sorted positions ``[b[z], b[z+1])``.
Ties resolve as in the reference: a stable sort of the magnitudes and a
first-minimum argmin in the DP (``torch.min`` returns the first index).
"""
from __future__ import annotations

import torch

from .objective import prefix_sums


def _cost_matrix(v, lam=0.0):
    """C[b, i, j] = sse of sorted interval [i, j) (+ lam/(j-i)); +inf for
    i >= j. v: (B, n) -> (B, n+1, n+1)."""
    n = v.shape[-1]
    s1, s2 = prefix_sums(v)
    idx = torch.arange(n + 1, device=v.device)
    m = (idx[None, :] - idx[:, None]).to(v.dtype)
    d1 = s1[:, None, :] - s1[:, :, None]
    d2 = s2[:, None, :] - s2[:, :, None]
    msafe = torch.clamp(m, min=1.0)
    c = d2 - d1 * d1 / msafe
    if lam:
        c = c + lam / msafe
    return torch.where(m >= 1.0, c, torch.full_like(c, float("inf")))


def dp_boundaries(v, g, lam=0.0):
    """Exact DP over sorted magnitudes ``v`` (B, n) into exactly
    ``min(g, n)`` groups. Returns (boundaries (B, g+1) int64, cost (B,))."""
    bsz, n = v.shape
    C = _cost_matrix(v, lam)
    D = C[:, 0, :]                                # k = 1: (B, n+1)
    args = [torch.zeros(bsz, n + 1, dtype=torch.int64, device=v.device)]
    for _ in range(1, g):
        D, A = torch.min(D[:, :, None] + C, dim=1)    # first-min argmin
        args.append(A)
    k_star = min(g, n)
    cost = D[:, n]                                # cost with g groups
    # backtrack k = k_star..1: b[k-1] = A_k[b[k]]
    bounds = torch.full((bsz, g + 1), n, dtype=torch.int64, device=v.device)
    j = bounds[:, :1].clone()
    for k in range(k_star, 0, -1):
        j = torch.gather(args[k - 1], 1, j)
        bounds[:, k - 1] = j[:, 0]
    bounds[:, 0] = 0
    return bounds, cost


def boundaries_to_levels(bounds, n):
    """Level id per sorted position: #{z in 1..g-1 : b[z] <= p}. (B, n)."""
    pos = torch.arange(n, device=bounds.device).expand(bounds.shape[0], n)
    inner = bounds[:, 1:-1].contiguous()
    return torch.searchsorted(inner, pos.contiguous(), right=True).to(
        torch.int32)


def scales_from_boundaries(v, bounds):
    """alpha_z = mean(|group z|); 0 for empty groups. (B, g)."""
    s1, _ = prefix_sums(v)
    cnt = (bounds[:, 1:] - bounds[:, :-1]).to(v.dtype)
    sums = torch.gather(s1, 1, bounds[:, 1:]) - torch.gather(s1, 1,
                                                             bounds[:, :-1])
    return torch.where(cnt > 0, sums / torch.clamp(cnt, min=1.0),
                       torch.zeros_like(sums))


def _solve_block_single(blocks, g, method="dp", lam=0.0):
    """Solve a batch of blocks (B, bs). Named after the reference's
    per-block solver, of which this is the batched form."""
    if method != "dp":
        raise NotImplementedError(
            f"solver {method!r}: the port has only the exact 'dp' solver "
            "(ROADMAP item 7 brings kmeans/wdp and the reference solvers)")
    a = blocks.to(torch.float32)
    mags = torch.abs(a)
    v, order = torch.sort(mags, dim=-1, stable=True)
    bounds, _ = dp_boundaries(v, g, lam=lam)
    levels_sorted = boundaries_to_levels(bounds, v.shape[-1])
    scales = scales_from_boundaries(v, bounds)
    levels = torch.empty_like(levels_sorted).scatter_(1, order,
                                                      levels_sorted)
    return levels, scales


def solve_blocks(blocks, g, method="dp", lam=0.0, chunk=32768):
    """Solve every row of ``blocks`` (n_blocks, block_size).

    ``chunk`` bounds the peak memory of the (chunk, n+1, n+1) DP cost
    tensors (~17 KB per 64-element block, several alive at once). Returns
    (levels (n_blocks, bs) int32, scales (n_blocks, g) f32) on the blocks'
    device.
    """
    nb = blocks.shape[0]
    levels, scales = [], []
    for i in range(0, nb, chunk):
        lv, sc = _solve_block_single(blocks[i:i + chunk], g, method, lam)
        levels.append(lv)
        scales.append(sc)
    if not levels:
        return (torch.zeros(0, blocks.shape[1], dtype=torch.int32,
                            device=blocks.device),
                torch.zeros(0, g, dtype=torch.float32, device=blocks.device))
    return torch.cat(levels), torch.cat(scales)
