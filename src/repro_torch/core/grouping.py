"""MSB dynamic-grouping solvers, batched over blocks.

Port of ``repro.core.grouping``. The JAX version vmaps a per-block solver;
here every function takes a leading batch dim of rows and runs as dense
tensor ops on whatever device the weights are on (on the card this is
plain PyTorch: the solvers were never a Pallas kernel).

* ``dp_boundaries``       — the exact DP (paper Alg. 1) as a dense masked
                            min-plus reduction; with ``choose_k`` the
                            regularized objective picks k* <= g per row
                            (Eq. 2).
* ``kmeans1d_boundaries`` — Lloyd sweeps over sorted magnitudes from an
                            equal-range and an equal-mass init, keeping the
                            lower cost.
* ``windowed_dp_boundaries`` — the exact DP over equal-count windows, then
                            Lloyd polish at element granularity.

All functions operate on *sorted magnitudes* ``v`` of shape ``(B, n)`` and
boundary indices ``b`` of shape ``(B, g + 1)`` with ``b[:, 0] = 0`` and
``b[:, g] = n``; group ``z`` covers sorted positions ``[b[z], b[z+1])``;
empty trailing groups repeat ``n``. Ties resolve as in the reference: a
stable sort of the magnitudes and a first-minimum argmin (``torch.min``
returns the first index).
"""
from __future__ import annotations

import torch

from .objective import _cumsum, prefix_sums


def _cost_matrix(v, lam=0.0):
    """C[b, i, j] = sse of sorted interval [i, j) (+ lam/(j-i)); +inf for
    i >= j. v: (B, n) -> (B, n+1, n+1)."""
    s1, s2 = prefix_sums(v)
    idx = torch.arange(v.shape[-1] + 1, device=v.device)
    return _interval_matrix(idx.to(v.dtype), s1, s2, lam)


def _interval_matrix(cnt, s1, s2, lam):
    """Interval costs from cumulative counts ``cnt`` (n+1,) and sums
    ``s1``/``s2`` (B, n+1): (B, n+1, n+1), +inf where the count is < 1."""
    m = cnt[None, :] - cnt[:, None]
    d1 = s1[:, None, :] - s1[:, :, None]
    d2 = s2[:, None, :] - s2[:, :, None]
    msafe = torch.clamp(m, min=1.0)
    c = d2 - d1 * d1 / msafe
    if lam:
        c = c + lam / msafe
    return torch.where(m >= 1.0, c, torch.full_like(c, float("inf")))


def _min_plus(C, g):
    """The DP over a cost matrix C (B, m+1, m+1): D_k[j] = min cost of the
    first j items in exactly k groups. Returns the split tables (B, g, m+1)
    (``A[:, k-1, j]`` = start of the last group) and D_k[m] (B, g)."""
    D = C[:, 0, :]                                # k = 1
    args = [torch.zeros_like(D, dtype=torch.int64)]
    finals = [D[:, -1]]
    for _ in range(1, g):
        D, A = torch.min(D[:, :, None] + C, dim=1)    # first-min argmin
        args.append(A)
        finals.append(D[:, -1])
    return torch.stack(args, 1), torch.stack(finals, 1)


def _backtrack(args, k_star, end):
    """Boundaries (B, g+1) from split tables (B, g, end+1) and each row's
    group count ``k_star`` (B,): walk k = k*..1 setting b[k-1] = A_k[b[k]].
    Every row takes g steps, as in the reference's scan; a row whose k*
    is reached reads the all-zero table A_1 and its later steps are never
    used, so rows with fewer groups keep ``end`` in their trailing
    boundaries."""
    bsz, g, _ = args.shape
    rows = torch.arange(bsz, device=args.device)
    step = torch.arange(g, device=args.device)
    table = torch.clamp(k_star[:, None] - 1 - step, min=0)    # (B, g)
    steps = table.t().contiguous()
    j = torch.full((bsz,), end, dtype=torch.int64, device=args.device)
    walk = []                           # walk[t] = b[k* - 1 - t]
    for t in range(g):
        j = args[rows, steps[t], j]
        walk.append(j)
    walk = torch.stack(walk, 1)
    inner = torch.where(step < k_star[:, None], torch.gather(walk, 1, table),
                        torch.full_like(walk, end))
    bounds = torch.cat([inner, inner.new_full((bsz, 1), end)], dim=1)
    bounds[:, 0] = 0
    return bounds


def dp_boundaries(v, g, lam=0.0, choose_k=False):
    """Exact DP over sorted magnitudes ``v`` (B, n) (paper Alg. 1).

    Returns (boundaries (B, g+1) int64, cost (B,)). With ``choose_k`` the
    regularized objective picks k* <= g per row (Eq. 2; the first minimum
    wins); otherwise exactly ``min(g, n)`` groups are used."""
    bsz, n = v.shape
    args, finals = _min_plus(_cost_matrix(v, lam), g)
    if choose_k:
        k_star = torch.argmin(finals, dim=1) + 1
    else:
        k_star = torch.full((bsz,), min(g, n), dtype=torch.int64,
                            device=v.device)
    cost = torch.gather(finals, 1, (k_star - 1)[:, None])[:, 0]
    return _backtrack(args, k_star, n), cost


def _lloyd_step(v, s1, bf):
    """One Lloyd sweep from full boundaries ``bf`` (B, g+1): group means
    (an empty group takes the value at its left boundary), made monotone
    by a running max, then the inner boundaries at the midpoints
    (searchsorted, side left). Returns the inner boundaries (B, g-1)."""
    n = v.shape[-1]
    cnt = (bf[:, 1:] - bf[:, :-1]).to(v.dtype)
    sums = torch.gather(s1, 1, bf[:, 1:]) - torch.gather(s1, 1, bf[:, :-1])
    c = sums / torch.clamp(cnt, min=1.0)
    fallback = torch.gather(v, 1, torch.clamp(bf[:, :-1], 0, n - 1))
    c = torch.where(cnt > 0, c, fallback)
    c = torch.cummax(c, dim=1).values
    mids = 0.5 * (c[:, :-1] + c[:, 1:])
    return torch.searchsorted(v, mids.contiguous())


def _full(inner, n):
    """Inner boundaries (B, g-1) -> full (B, g+1) with 0 and n."""
    bsz = inner.shape[0]
    return torch.cat([inner.new_zeros(bsz, 1), inner,
                      inner.new_full((bsz, 1), n)], dim=1)


def kmeans1d_boundaries(v, g, iters=30):
    """Lloyd iterations on sorted magnitudes ``v`` (B, n), from an
    equal-range (paper Alg. 4) and an equal-mass (quantile) init, keeping
    the lower-objective solution per row (the equal-range one on a tie).
    Returns boundaries (B, g+1) int64."""
    bsz, n = v.shape
    s1, s2 = prefix_sums(v)
    lo, hi = v[:, :1], v[:, -1:]

    def lloyd(inner):
        for _ in range(iters):
            inner = _lloyd_step(v, s1, _full(inner, n))
        return _full(inner, n)

    def cost(b):
        cnt = (b[:, 1:] - b[:, :-1]).to(v.dtype)
        d1 = torch.gather(s1, 1, b[:, 1:]) - torch.gather(s1, 1, b[:, :-1])
        d2 = torch.gather(s2, 1, b[:, 1:]) - torch.gather(s2, 1, b[:, :-1])
        zero = torch.zeros_like(d1)
        sse = d2 - torch.where(cnt > 0, d1 * d1 / torch.clamp(cnt, min=1.0),
                               zero)
        return torch.sum(torch.where(cnt > 0, sse, zero), dim=1)

    steps = torch.arange(1, g, dtype=v.dtype, device=v.device)
    edges = lo + (hi - lo) * steps / g
    b_range = lloyd(torch.searchsorted(v, edges.contiguous()))
    b_mass = lloyd((torch.arange(1, g, device=v.device) * n // g).expand(
        bsz, g - 1))
    keep = (cost(b_range) <= cost(b_mass))[:, None]
    return torch.where(keep, b_range, b_mass)


def windowed_dp_boundaries(v, g, n_windows=1024, lam=0.0, refine_iters=8):
    """Windowed exact DP (per-tensor solver): aggregate the sorted
    magnitudes ``v`` (B, n) into ``W = min(n_windows, n)`` equal-count
    windows (the last padded with ``v[-1]`` under a mask), run the
    *weighted* exact DP over window statistics, then polish boundaries with
    ``refine_iters`` Lloyd sweeps at element granularity. Returns
    boundaries (B, g+1) int64."""
    bsz, n = v.shape
    w = min(n_windows, n)
    k = -(-n // w)
    pad = w * k - n
    vp = torch.cat([v, v[:, -1:].expand(bsz, pad)], dim=1)
    mask = (torch.arange(w * k, device=v.device) < n).to(v.dtype).reshape(
        w, k)
    vw = vp.reshape(bsz, w, k)
    cnt = torch.sum(mask, dim=1)
    s = torch.sum(vw * mask, dim=2)
    q = torch.sum(vw * vw * mask, dim=2)
    z = v.new_zeros(1)
    C = torch.cat([z, _cumsum(cnt)])
    S = torch.cat([v.new_zeros(bsz, 1), _cumsum(s)], dim=1)
    Q = torch.cat([v.new_zeros(bsz, 1), _cumsum(q)], dim=1)
    args, _ = _min_plus(_interval_matrix(C, S, Q, lam), g)
    k_star = torch.full((bsz,), min(g, w), dtype=torch.int64,
                        device=v.device)
    bounds = torch.clamp(_backtrack(args, k_star, w) * k, max=n)
    if refine_iters:
        s1, _ = prefix_sums(v)
        for _ in range(refine_iters):
            bounds = _full(_lloyd_step(v, s1, bounds), n)
    return bounds


def boundaries_to_levels(bounds, n):
    """Level id per sorted position: #{z in 1..g-1 : b[z] <= p}. (B, n)."""
    pos = torch.arange(n, device=bounds.device).expand(bounds.shape[0], n)
    inner = bounds[:, 1:-1].contiguous()
    return torch.searchsorted(inner, pos.contiguous(), right=True,
                              out_int32=True)


def scales_from_boundaries(v, bounds):
    """alpha_z = mean(|group z|); 0 for empty groups. (B, g)."""
    s1, _ = prefix_sums(v)
    cnt = (bounds[:, 1:] - bounds[:, :-1]).to(v.dtype)
    sums = torch.gather(s1, 1, bounds[:, 1:]) - torch.gather(s1, 1,
                                                             bounds[:, :-1])
    return torch.where(cnt > 0, sums / torch.clamp(cnt, min=1.0),
                       torch.zeros_like(sums))


def _solve_block_single(blocks, g, method="dp", lam=0.0, iters=30,
                        choose_k=False):
    """Solve a batch of rows (B, bs); returns (levels (B, bs) int32 in the
    original element order, scales (B, g) f32). Named after the
    reference's per-block solver, of which this is the batched form."""
    a = blocks.to(torch.float32)
    v, order = torch.sort(torch.abs(a), dim=-1, stable=True)
    if method == "dp":
        bounds, _ = dp_boundaries(v, g, lam=lam, choose_k=choose_k)
    elif method == "kmeans":
        bounds = kmeans1d_boundaries(v, g, iters=iters)
    elif method == "wdp":
        bounds = windowed_dp_boundaries(v, g, lam=lam)
    else:
        raise ValueError(f"unknown solver method: {method}")
    levels_sorted = boundaries_to_levels(bounds, v.shape[-1])
    scales = scales_from_boundaries(v, bounds)
    levels = torch.empty_like(levels_sorted).scatter_(1, order,
                                                      levels_sorted)
    return levels, scales


def solve_flat(a_flat, g, method="dp", lam=0.0, choose_k=False, iters=30):
    """Solve MSB grouping for one flat vector of weights on its device.

    Returns (levels (n,) int32, scales (g,) f32) in the *original* element
    order; dequant = sign(a) * scales[levels]. Any ``lam`` works, the
    explicit ones included (the reference's jitted form refuses them)."""
    levels, scales = _solve_block_single(a_flat.reshape(1, -1), g, method,
                                         lam, iters, choose_k)
    return levels[0], scales[0]


def solve_blocks(blocks, g, method="dp", lam=0.0, iters=30, chunk=32768):
    """Solve every row of ``blocks`` (n_blocks, block_size).

    ``chunk`` bounds the peak memory of the (chunk, n+1, n+1) DP cost
    tensors (~17 KB per 64-element block, several alive at once).
    ``iters`` reaches the kmeans solver only. Returns (levels (n_blocks,
    bs) int32, scales (n_blocks, g) f32) on the blocks' device.
    """
    nb = blocks.shape[0]
    levels, scales = [], []
    for i in range(0, nb, chunk):
        lv, sc = _solve_block_single(blocks[i:i + chunk], g, method, lam,
                                     iters)
        levels.append(lv)
        scales.append(sc)
    if not levels:
        return (torch.zeros(0, blocks.shape[1], dtype=torch.int32,
                            device=blocks.device),
                torch.zeros(0, g, dtype=torch.float32, device=blocks.device))
    return torch.cat(levels), torch.cat(scales)
