"""Paper-faithful NumPy reference solvers (Algorithms 1-4).

A copy of ``repro.core.reference`` (numpy only): the paper's CPU solvers
run on the host by design, in float64, and give bit-identical levels and
scales to the reference's.

These follow the paper's pseudocode (Sec 3.3 + Appendix B) line-by-line,
including the heap + ignore-array bookkeeping of Algorithms 2/3 and the
equal-range binning + stochastic local boundary search of Algorithm 4. They
run on CPU — the paper's own deployment mode ("CPU based solver") — and serve
as (a) oracles for property tests, (b) the paper-faithful baseline rows in
the benchmark tables, (c) an offline quantization path.

All solvers return ``(boundaries, order)`` where ``order`` is the argsort of
magnitudes and ``boundaries`` (length g+1, b[0]=0, b[-1]=n) delimits groups of
the *sorted* magnitudes. ``levels_from_boundaries`` converts back to per-
element level ids in the original layout.
"""
from __future__ import annotations

import heapq
import numpy as np


def _prep(a):
    v = np.abs(np.asarray(a, dtype=np.float64).ravel())
    order = np.argsort(v, kind="stable")
    return v[order], order


def _interval_sse(s1, s2, i, j):
    m = j - i
    if m <= 0:
        return 0.0
    d1 = s1[j] - s1[i]
    return (s2[j] - s2[i]) - d1 * d1 / m


def _psums(v):
    s1 = np.concatenate([[0.0], np.cumsum(v)])
    s2 = np.concatenate([[0.0], np.cumsum(v * v)])
    return s1, s2


# ---------------------------------------------------------------------------
# Algorithm 1: Dynamic Grouping (exact DP oracle)
# ---------------------------------------------------------------------------

def dynamic_grouping(a, max_groups, lam=0.0, choose_k=False):
    """Exact DP (Alg. 1). O(g * n^2); use only on small instances.

    With ``choose_k`` the number of groups g* <= max_groups is chosen by the
    lam-regularized objective (paper Eq. 2); otherwise exactly ``max_groups``
    groups are used (the fixed-codebook b-bit setting of Sec 4.1).
    """
    v, order = _prep(a)
    n = v.size
    g = min(max_groups, n)
    s1, s2 = _psums(v)
    INF = np.inf
    dp = np.full((g + 1, n + 1), INF)
    arg = np.zeros((g + 1, n + 1), dtype=np.int64)
    dp[0, 0] = 0.0
    for k in range(1, g + 1):
        for j in range(k, n + 1):
            best, bi = INF, k - 1
            for i in range(k - 1, j):
                c = dp[k - 1, i] + _interval_sse(s1, s2, i, j) + (lam / (j - i) if lam else 0.0)
                if c < best:
                    best, bi = c, i
            dp[k, j] = best
            arg[k, j] = bi
    if choose_k:
        k_star = int(np.argmin(dp[1:, n])) + 1
    else:
        k_star = g
    # backtrack
    bounds = [n]
    j = n
    for k in range(k_star, 0, -1):
        j = int(arg[k, j])
        bounds.append(j)
    boundaries = np.array(bounds[::-1], dtype=np.int64)
    return boundaries, order, float(dp[k_star, n])


# ---------------------------------------------------------------------------
# Heap-merge machinery shared by Algorithms 2 and 3
# ---------------------------------------------------------------------------

def _greedy_merge(v, s1, s2, starts, ends, target_groups, lam=0.0):
    """Greedy adjacent merging with a min-heap + ignore (lazy-invalidation)
    bookkeeping, exactly the structure of Alg. 2/3 pseudocode.

    Heap entries are (delta_cost, start, mid, end): merging groups
    [start, mid) and [mid, end). Stale entries are lazily skipped via a
    version map keyed on the boundary ``mid``.
    """
    n_groups = len(starts)
    # doubly-linked list over group boundaries
    left = {s: None for s in starts}
    right = {}
    for idx in range(n_groups - 1):
        right[starts[idx]] = starts[idx + 1]
        left[starts[idx + 1]] = starts[idx]
    right[starts[-1]] = None
    end_of = dict(zip(starts, ends))

    def cost(i, j):
        c = _interval_sse(s1, s2, i, j)
        if lam:
            c += lam / (j - i)
        return c

    def merge_delta(a_start, b_start):
        b_end = end_of[b_start]
        return (cost(a_start, b_end)
                - cost(a_start, end_of[a_start])
                - cost(b_start, b_end))

    heap = []
    alive = set(starts)
    for s in starts:
        r = right[s]
        if r is not None:
            heapq.heappush(heap, (merge_delta(s, r), s, r))

    cur_groups = n_groups
    while cur_groups > target_groups and heap:
        delta, a_s, b_s = heapq.heappop(heap)
        # lazy invalidation: entry stale if either group vanished or the
        # adjacency changed ("ignore array" of the pseudocode)
        if a_s not in alive or b_s not in alive or right.get(a_s) != b_s:
            continue
        # merge b into a
        end_of[a_s] = end_of[b_s]
        alive.discard(b_s)
        nr = right[b_s]
        right[a_s] = nr
        if nr is not None:
            left[nr] = a_s
        cur_groups -= 1
        # push two new neighbouring merges (updates); old ones invalidated lazily
        l = left.get(a_s)
        if l is not None:
            heapq.heappush(heap, (merge_delta(l, a_s), l, a_s))
        if nr is not None:
            heapq.heappush(heap, (merge_delta(a_s, nr), a_s, nr))

    bounds = sorted(alive) + [len(v)]
    return np.array(bounds, dtype=np.int64)


# ---------------------------------------------------------------------------
# Algorithm 2: Greedy Grouping (singleton init)
# ---------------------------------------------------------------------------

def greedy_grouping(a, max_groups, lam=0.0):
    v, order = _prep(a)
    s1, s2 = _psums(v)
    starts = list(range(v.size))
    ends = [s + 1 for s in starts]
    boundaries = _greedy_merge(v, s1, s2, starts, ends, max_groups, lam)
    return boundaries, order


# ---------------------------------------------------------------------------
# Algorithm 3: Windowed Greedy Merging (window-k init)
# ---------------------------------------------------------------------------

def windowed_greedy_merging(a, max_groups, window, lam=0.0):
    v, order = _prep(a)
    s1, s2 = _psums(v)
    n = v.size
    starts = list(range(0, n, window))
    ends = [min(s + window, n) for s in starts]
    if len(starts) <= max_groups:
        # degenerate case noted in Appendix D: window >= n collapses to XNOR
        boundaries = np.array(starts + [n], dtype=np.int64)
        return boundaries, order
    boundaries = _greedy_merge(v, s1, s2, starts, ends, max_groups, lam)
    return boundaries, order


# ---------------------------------------------------------------------------
# Algorithm 4: Local Optimizing Windowed Greedy Merging
# ---------------------------------------------------------------------------

def wgm_local_opt(a, max_groups, n_bins=256, local_range=8, max_iters=12,
                  tol=0.0, lam=0.0, seed=0):
    """Equal-range binning init + greedy merge + stochastic local search."""
    v, order = _prep(a)
    n = v.size
    s1, s2 = _psums(v)
    lo, hi = v[0], v[-1]
    if hi <= lo:
        return np.array([0, n], dtype=np.int64), order
    # equal-range binning over [w_min, w_max]
    delta = (hi - lo) / n_bins
    idx = np.minimum(n_bins - 1, np.floor((v - lo) / delta).astype(np.int64))
    # bin start positions (v sorted -> bins are contiguous); drop empty bins
    change = np.flatnonzero(np.diff(idx)) + 1
    starts = np.concatenate([[0], change]).tolist()
    ends = starts[1:] + [n]
    if len(starts) > max_groups:
        boundaries = _greedy_merge(v, s1, s2, starts, ends, max_groups, lam)
    else:
        boundaries = np.array(starts + [n], dtype=np.int64)

    # stochastic local boundary search (accept only improving moves)
    rng = np.random.default_rng(seed)
    b = boundaries.copy()

    def seg_cost(i, j):
        c = _interval_sse(s1, s2, i, j)
        if lam and j > i:
            c += lam / (j - i)
        return c

    no_improve = 0
    it = 0
    while it < max_iters and no_improve < 2 * max(1, len(b) - 2):
        improved = False
        for z in range(1, len(b) - 1):
            cur = b[z]
            lo_z, hi_z = b[z - 1] + 1, b[z + 1] - 1
            if hi_z < lo_z:
                continue
            cand = int(rng.integers(max(lo_z, cur - local_range),
                                    min(hi_z, cur + local_range) + 1))
            if cand == cur:
                continue
            before = seg_cost(b[z - 1], cur) + seg_cost(cur, b[z + 1])
            after = seg_cost(b[z - 1], cand) + seg_cost(cand, b[z + 1])
            if after < before - tol:
                b[z] = cand
                improved = True
        no_improve = 0 if improved else no_improve + 1
        it += 1
    return b, order


# ---------------------------------------------------------------------------
# Shared decode helpers
# ---------------------------------------------------------------------------

def levels_from_boundaries(n, boundaries):
    """Per-sorted-position group id (level) from boundary indices."""
    levels = np.zeros(n, dtype=np.int64)
    for z in range(len(boundaries) - 1):
        levels[boundaries[z]:boundaries[z + 1]] = z
    return levels


def reconstruct(a, boundaries, order, n_levels=None):
    """Dequantized tensor + (codes, scales) from a solver solution.

    scales[z] = mean(|group z|) (optimal alpha). Zero elements reconstruct to
    exactly 0 via sign() == 0 (paper's zero-loss special group).
    """
    a = np.asarray(a, dtype=np.float64)
    flat = a.ravel()
    v = np.abs(flat)[order]
    n = flat.size
    g = len(boundaries) - 1
    n_levels = n_levels or g
    levels_sorted = levels_from_boundaries(n, boundaries)
    scales = np.zeros(n_levels, dtype=np.float64)
    for z in range(g):
        i, j = boundaries[z], boundaries[z + 1]
        if j > i:
            scales[z] = v[i:j].mean()
    levels = np.empty(n, dtype=np.int64)
    levels[order] = levels_sorted
    signs = np.sign(flat)
    w_hat = (signs * scales[levels]).reshape(a.shape)
    return w_hat, levels.reshape(a.shape), scales
