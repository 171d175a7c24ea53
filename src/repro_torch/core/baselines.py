"""Baseline weight-only PTQ methods the paper compares against (Sec. 4.1.2).

Port of ``repro.core.baselines``; every method runs on the weights' device.

* RTN  — round-to-nearest with symmetric absmax scaling (per-block/tensor)
* BnB  — blockwise NF4 (normal-float quantile codebook + absmax), the
         bitsandbytes 4-bit format
* HQQ  — calibration-free half-quadratic zero-point optimization
* GPTQ — calibration-based second-order sequential rounding (mini
         implementation with synthetic calibration activations, float64)
* XNOR — one mean-magnitude scale per tensor or per block

All return the dequantized f32 tensor (the paper's simulated-quantization
protocol) so benchmark tables compare reconstruction quality directly.
"""
from __future__ import annotations

from math import erf, sqrt

import numpy as np
import torch


def _rows(w, block):
    """f32 weights as rows: one row per tensor (``block=-1``) or per block."""
    x = w.to(torch.float32)
    return x.reshape(1, -1) if block == -1 else x.reshape(-1, block)


# ---------------------------------------------------------------------------
# RTN
# ---------------------------------------------------------------------------

def rtn_quantize(w, bits=4, block=64, symmetric=True):
    """Round-to-nearest. block=-1 -> per-tensor."""
    x = _rows(w, block)
    one = torch.ones((), device=x.device)
    if symmetric:
        qmax = 2.0 ** (bits - 1) - 1
        scale = torch.amax(torch.abs(x), dim=1, keepdim=True) / qmax
        scale = torch.where(scale == 0, one, scale)
        q = torch.clamp(torch.round(x / scale), -qmax - 1, qmax)
        out = q * scale
    else:
        qmax = 2.0 ** bits - 1
        lo = torch.amin(x, dim=1, keepdim=True)
        hi = torch.amax(x, dim=1, keepdim=True)
        scale = torch.where(hi > lo, (hi - lo) / qmax, one)
        q = torch.clamp(torch.round((x - lo) / scale), 0, qmax)
        out = q * scale + lo
    return out.reshape(w.shape)


# ---------------------------------------------------------------------------
# BnB-style NF4 (and NF-k generalization via normal quantiles)
# ---------------------------------------------------------------------------

# bitsandbytes NF4 codebook (Dettmers et al., QLoRA App. E)
_NF4 = np.array([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
    0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
    0.7229568362236023, 1.0], dtype=np.float32)


def _normal_float_codebook(bits):
    """NF-``bits`` codebook as a float32 numpy array (NF4: the table)."""
    if bits == 4:
        return _NF4
    # general NF-k: quantiles of N(0,1) normalized to [-1, 1]

    def ppf(p):  # inverse CDF via bisection (offline, tiny)
        lo_, hi_ = -10.0, 10.0
        for _ in range(80):
            mid = 0.5 * (lo_ + hi_)
            if 0.5 * (1 + erf(mid / sqrt(2))) < p:
                lo_ = mid
            else:
                hi_ = mid
        return 0.5 * (lo_ + hi_)

    n = 2 ** bits
    offset = 0.9677083  # bnb convention
    neg = [ppf(offset * (1 - i / (n // 2)) + (1 - offset) * 0.5)
           for i in range(n // 2)]
    pos = [ppf(0.5 + (0.5 * offset) * (i / (n - n // 2 - 1)))
           for i in range(n - n // 2)]
    cb = np.array(sorted(set([x / max(abs(min(neg)), abs(max(pos)))
                              for x in neg + pos])))
    if cb.size < n:
        cb = np.concatenate([cb, [1.0] * (n - cb.size)])
    return cb[:n].astype(np.float32)


def nf4_quantize(w, bits=4, block=64):
    """Blockwise normal-float quantization (absmax scale per block)."""
    x = _rows(w, block)
    cb = torch.from_numpy(_normal_float_codebook(bits)).to(x.device)
    amax = torch.amax(torch.abs(x), dim=1, keepdim=True)
    amax = torch.where(amax == 0, torch.ones((), device=x.device), amax)
    xn = x / amax
    idx = torch.argmin(torch.abs(xn[..., None] - cb), dim=-1)
    return (cb[idx] * amax).reshape(w.shape)


# ---------------------------------------------------------------------------
# HQQ (Badri & Shaji 2023) — half-quadratic zero-point optimization
# ---------------------------------------------------------------------------

def hqq_quantize(w, bits=4, block=64, iters=20, lp_norm=0.7, beta=10.0,
                 kappa=1.01):
    """Calibration-free HQQ: argmin_{z} ||W - s(Q - z)||_p via half-quadratic
    splitting with a generalized soft-threshold prox (official formulation,
    axis-grouped). block=-1 -> per-tensor.
    """
    x = _rows(w, block)
    qmax = 2.0 ** bits - 1
    lo = torch.amin(x, dim=1, keepdim=True)
    hi = torch.amax(x, dim=1, keepdim=True)
    scale = torch.where(hi > lo, (hi - lo) / qmax,
                        torch.ones((), device=x.device))
    zero = -lo / scale

    def shrink(e, b_):
        return torch.sign(e) * torch.clamp(
            torch.abs(e) - (lp_norm / b_) * torch.abs(e) ** (lp_norm - 1),
            min=0.0)

    b_ = beta
    for _ in range(iters):
        q = torch.clamp(torch.round(x / scale + zero), 0, qmax)
        wq = scale * (q - zero)
        e = shrink(x - wq, b_)
        zero = torch.mean(q - (x - e) / scale, dim=1, keepdim=True)
        b_ *= kappa
    q = torch.clamp(torch.round(x / scale + zero), 0, qmax)
    return (scale * (q - zero)).reshape(w.shape)


# ---------------------------------------------------------------------------
# mini-GPTQ (Frantar et al. 2022) — calibration-based, for baseline tables
# ---------------------------------------------------------------------------

def gptq_quantize(w, bits=4, block=64, n_calib=128, percdamp=0.01, seed=0,
                  calib=None):
    """Sequential column-wise quantization with Hessian error compensation,
    in float64 on ``w``'s device.

    W: (out, in). Calibration activations X: (n_calib, in) — synthetic
    N(0,1) by default, drawn with numpy's ``default_rng(seed)`` as in the
    reference, so X is the same. Quantization grid = symmetric RTN per
    ``block`` along the input dim, matching the default GPTQ setup.
    """
    dev = w.device
    W = w.to(torch.float64).clone()
    out_dim, in_dim = W.shape
    if calib is None:
        calib = np.random.default_rng(seed).standard_normal((n_calib, in_dim))
    X = torch.as_tensor(np.asarray(calib, np.float64), device=dev)
    H = 2.0 * X.T @ X
    damp = percdamp * torch.mean(torch.diagonal(H)) + 1e-8
    H.diagonal().add_(damp)
    # H^{-1} upper-Cholesky as in the reference implementation
    Hinv = torch.linalg.cholesky(torch.linalg.inv(H), upper=True)

    qmax = 2.0 ** (bits - 1) - 1
    Q = torch.zeros_like(W)
    Err = torch.zeros_like(W)
    nblk = in_dim if block == -1 else block
    for b0 in range(0, in_dim, nblk):
        b1 = min(b0 + nblk, in_dim)
        Wb = W[:, b0:b1].clone()
        scale = torch.amax(torch.abs(Wb), dim=1, keepdim=True) / qmax
        scale[scale == 0] = 1.0
        for j in range(b0, b1):
            c = j - b0
            d = Hinv[j, j]
            col = Wb[:, c]
            q = torch.clamp(torch.round(col / scale[:, 0]), -qmax - 1,
                            qmax) * scale[:, 0]
            err = (col - q) / d
            Q[:, j] = q
            if j + 1 < b1:
                Wb[:, c + 1:] -= torch.outer(err, Hinv[j, j + 1:b1])
            Err[:, j] = err
        if b1 < in_dim:
            W[:, b1:] -= Err[:, b0:b1] @ Hinv[b0:b1, b1:]
    return Q.to(torch.float32)


# ---------------------------------------------------------------------------
# XNOR baselines used in the paper's Appendix D figures
# ---------------------------------------------------------------------------

def xnor_quantize(w):
    """1 scale for the whole tensor (Rastegari et al. 2016)."""
    x = w.to(torch.float32)
    return torch.mean(torch.abs(x)) * torch.sign(x)


def blocked_xnor_quantize(w, block=64):
    x = w.to(torch.float32).reshape(-1, block)
    alpha = torch.mean(torch.abs(x), dim=1, keepdim=True)
    return (alpha * torch.sign(x)).reshape(w.shape)
