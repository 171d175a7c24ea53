"""MSB optimization objective (paper Sec. 3.2, Appendix A).

Port of ``repro.core.objective``. The MSB objective for a grouping
``G = {A_i}`` of a weight tensor ``A``:

    cost(G) = sum_i ( |A_i| * Var(|A_i|) + lam / |A_i| )        (un-normalized)
    cost(G) = sum_i ( |A_i|/|A| * Var(|A_i|) + lam / |A_i| )    (normalized, Sec 3.4)

where ``|A_i| * Var(|A_i|) == ||A_i - alpha_i* B_i*||_2^2`` with the optimal
scale ``alpha_i* = mean(|A_i|)`` and sign matrix ``B_i* = sign(A_i)``
(Appendix A identity). The solvers evaluate these interval costs over the
*sorted magnitudes* in O(1) from prefix sums. ``lambda_bounds`` and
``lambda_from_tilde`` stay in numpy, as in the reference, so the bounds
come out bit-equal.
"""
from __future__ import annotations

import numpy as np
import torch


_SCAN_BLOCK = 16


def _sequential_cumsum(v):
    """Cumulative sum along the last dim, one element after another."""
    acc = torch.empty_like(v)
    run = torch.zeros_like(v[..., 0])
    for k in range(v.shape[-1]):
        run = run + v[..., k]
        acc[..., k] = run
    return acc


def _cumsum(v):
    """Cumulative sum along the last dim in the association order of XLA's
    CPU cumsum, so the solvers' scales come out bit-identical to the
    reference's (``torch.cumsum`` sums in another order): sequential
    within blocks of 16, and each block offset by the cumulative sum of the
    block totals before it, taken the same way, recursively. Loops run over
    the block positions; everything else is vectorized."""
    n = v.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential_cumsum(v)
    n_blk = -(-n // _SCAN_BLOCK)
    vb = torch.nn.functional.pad(v, (0, n_blk * _SCAN_BLOCK - n)).reshape(
        *v.shape[:-1], n_blk, _SCAN_BLOCK)
    acc = _sequential_cumsum(vb)
    carry = _cumsum(acc[..., -1])[..., :-1]         # totals before block b
    acc[..., 1:, :] += carry[..., None]
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


def _at(s, idx):
    """``s[..., idx]`` for an int index or an index tensor whose leading
    dims match ``s``'s (or that is 1-D, for an unbatched ``s``)."""
    if not isinstance(idx, torch.Tensor):
        return s[..., idx]
    idx = idx.to(device=s.device, dtype=torch.int64)
    if s.dim() == 1:
        return s[idx]
    return torch.gather(s, -1, idx)


def xnor_closed_form(a):
    """XNOR-Net closed form (Eq. 1): alpha* = ||A||_1/|A|, B* = sign(A)."""
    return torch.mean(torch.abs(a)), torch.sign(a)


def group_sse(a):
    """||A - alpha* B*||^2 for a single group = |A| * Var(|A|)."""
    mag = torch.abs(a)
    return torch.sum((mag - torch.mean(mag)) ** 2)


def interval_cost(i, j, s1, s2, lam=0.0, n_total=None):
    """Cost of grouping sorted positions [i, j) into one group.

    sse = (s2[j]-s2[i]) - (s1[j]-s1[i])^2 / (j-i)   == |A_i| Var(|A_i|)
    plus the regularization term lam/(j-i); if ``n_total`` is given the sse
    is normalized by it (Sec 3.4 form). ``i``/``j`` are ints or index
    tensors (batched over ``s1``'s leading dims).
    """
    m = j - i
    m = m.to(s1.dtype) if isinstance(m, torch.Tensor) else float(m)
    d1 = _at(s1, j) - _at(s1, i)
    d2 = _at(s2, j) - _at(s2, i)
    msafe = torch.clamp(torch.as_tensor(m, dtype=s1.dtype,
                                        device=s1.device), min=1.0)
    sse = d2 - d1 * d1 / msafe
    if n_total is not None:
        sse = sse / n_total
    return sse + lam / msafe


def grouping_cost(sorted_mags, boundaries, lam=0.0, normalized=False):
    """Total MSB objective for contiguous groups given boundary indices.

    ``boundaries`` has length g+1 along its last dim with b[0]=0, b[g]=n;
    group z covers [b[z], b[z+1]). Empty groups contribute zero. With 1-D
    boundaries the whole of ``sorted_mags`` is one vector, as in the
    reference; with (..., g+1) boundaries the magnitudes are batched over
    the same leading dims. The magnitudes are sorted here.
    """
    b = torch.as_tensor(boundaries).to(torch.int64)
    x = torch.as_tensor(sorted_mags)
    b = b.to(x.device)
    v = torch.sort(torch.abs(x.reshape(*b.shape[:-1], -1)), dim=-1,
                   stable=True).values
    s1, s2 = prefix_sums(v)
    i, j = b[..., :-1], b[..., 1:]
    m = (j - i).to(v.dtype)
    d1 = _at(s1, j) - _at(s1, i)
    d2 = _at(s2, j) - _at(s2, i)
    msafe = torch.clamp(m, min=1.0)
    zero = torch.zeros_like(d1)
    sse = d2 - torch.where(m > 0, d1 * d1 / msafe, zero)
    total = sse / v.shape[-1] if normalized else sse
    reg = torch.where(m > 0, lam / msafe, zero)
    return torch.sum(torch.where(m > 0, total + reg, zero), dim=-1)


def _numpy(a):
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.float()
        return a.numpy()
    return np.asarray(a)


def lambda_bounds(a):
    """(lambda_min, lambda_max) estimates from Appendix C, Eq. (10).

    lambda_min ~ (|a_(1)| - |a_(2)|)^2 / (3n)  (two smallest sorted magnitudes)
    lambda_max ~ n (mu_1 - mu_2)^2 / 12        (half-split group means)
    """
    v = np.sort(np.abs(np.ravel(_numpy(a))))
    n = v.size
    lam_min = (v[0] - v[1]) ** 2 / (3.0 * n) if n >= 2 else 0.0
    k = n // 2
    mu1 = float(v[:k].mean()) if k else 0.0
    mu2 = float(v[k:].mean()) if n - k else 0.0
    lam_max = n * (mu1 - mu2) ** 2 / 12.0
    return float(lam_min), float(lam_max)


def lambda_from_tilde(a, lam_tilde):
    """Monotone reparameterization lambda = Lambda(lam_tilde) in [0, 1]."""
    lo, hi = lambda_bounds(a)
    return lo + float(lam_tilde) * (hi - lo)


def reconstruction_mse(w, w_hat):
    """Frobenius MSE proxy used throughout the paper's tables."""
    w = torch.as_tensor(w).to(torch.float32)
    w_hat = torch.as_tensor(w_hat).to(device=w.device, dtype=torch.float32)
    return torch.sum((w - w_hat) ** 2)
