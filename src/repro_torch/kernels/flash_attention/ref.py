"""Plain PyTorch versions of the flash-attention forward kernel.

Port of ``repro.kernels.flash_attention.ref``. Layout is head-major, as the
kernel's: q (B, H, Sq, d), k/v (B, KV, Skv, d), GQA by ``h // rep`` (no
repeated K/V copy). Keys count from position 0 and query row i
sits at ``q_offset + i`` (0 unless a context-parallel rank passes its
rows' first position); causal is ``kpos <= qpos``, window ``kpos > qpos -
window``; masked scores
are ``_NEG_INF`` (finite, so an all-masked row never makes a NaN) and
masked probabilities exactly 0.

``flash_attention_ref`` is the chunked online-softmax forward the kernel
runs (64-key tiles, ``p`` rounded to V's type before the PV product, f32
sums); ``flash_attention_segmented_ref`` is the masked full softmax with
segment ids, where cross-segment weights are exactly 0 and a row whose q
segment is -1 (a pad) outputs exactly 0.
"""
from __future__ import annotations

import torch

_NEG_INF = -2.0e38
_BLOCK_KV = 64          # the kernel's key tile


def _grouped(q, kv):
    b, h, sq, d = q.shape
    return q.reshape(b, kv, h // kv, sq, d)


def _scores(qg, kc, scale, softcap):
    """f32 scores of grouped q (B, KV, rep, Sq, d) against k (B, KV, c, d):
    the dot in f32, then the scale, then the softcap."""
    s = torch.einsum("bkrqd,bkcd->bkrqc", qg.to(torch.float32),
                     kc.to(torch.float32)) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    return s


def _mask(qpos, kpos, causal, window):
    m = torch.ones(qpos.shape[0], kpos.shape[0], dtype=torch.bool,
                   device=qpos.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        m &= kpos[None, :] > qpos[:, None] - window
    return m


def _lse(m, l, shape):
    """Each row's log-sum-exp (B, H, Sq) f32 from its max and sum, with
    the sum clamped at 1e-30 as the reference's ``l_safe``."""
    return (m + torch.log(torch.clamp(l, min=1e-30))).reshape(shape)


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None, with_lse=False, q_offset=0):
    """q: (B, H, Sq, d); k/v: (B, KV, Skv, d). Returns (B, H, Sq, d) in q's
    type, and with ``with_lse`` also each row's log-sum-exp (B, H, Sq) f32.
    Any Sq and Skv: the last key tile is masked, not padded."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else d ** -0.5)
    qg = _grouped(q, kv)
    qpos = torch.arange(q_offset, q_offset + sq, device=q.device)
    acc = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    m_i = torch.full(qg.shape[:-1], _NEG_INF, dtype=torch.float32,
                     device=q.device)
    l_i = torch.zeros_like(m_i)
    for k0 in range(0, skv, _BLOCK_KV):
        kc, vc = k[:, :, k0:k0 + _BLOCK_KV], v[:, :, k0:k0 + _BLOCK_KV]
        kpos = torch.arange(k0, k0 + kc.shape[2], device=q.device)
        mask = _mask(qpos, kpos, causal, window)
        s = torch.where(mask, _scores(qg, kc, scale, softcap),
                        torch.tensor(_NEG_INF, device=q.device))
        m_new = torch.maximum(m_i, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]),
                        torch.zeros((), device=q.device))
        corr = torch.exp(m_i - m_new)
        l_i = l_i * corr + p.sum(dim=-1)
        pv = torch.einsum("bkrqc,bkcd->bkrqd",
                          p.to(v.dtype).to(torch.float32),
                          vc.to(torch.float32))
        acc = acc * corr[..., None] + pv
        m_i = m_new
    out = acc / torch.clamp(l_i, min=1e-30)[..., None]
    out = out.reshape(b, h, sq, d).to(q.dtype)
    return (out, _lse(m_i, l_i, (b, h, sq))) if with_lse else out


def flash_attention_segmented_ref(q, k, v, q_segs, kv_segs, *, causal=True,
                                  window=0, softcap=0.0, scale=None,
                                  with_lse=False, q_offset=0):
    """Masked full softmax with segment ids. q: (B, H, Sq, d); k/v: (B, KV,
    Skv, d); q_segs/kv_segs: (B, Sq)/(B, Skv) int32 (-1 = pad). A key is
    visible when it is in the query's segment, the query is not a pad, and
    the causal and window masks allow it. Returns (B, H, Sq, d)."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    scale = float(scale if scale is not None else d ** -0.5)
    qg = _grouped(q, kv)
    s = _scores(qg, k, scale, softcap)           # (B, KV, rep, Sq, Skv)
    qs = q_segs.to(torch.int32)[:, None, None, :, None]
    ks = kv_segs.to(torch.int32)[:, None, None, None, :]
    mask = (qs == ks) & (qs >= 0)
    mask = mask & _mask(torch.arange(q_offset, q_offset + sq,
                                     device=q.device),
                        torch.arange(skv, device=q.device), causal, window)
    s = torch.where(mask, s, torch.tensor(_NEG_INF, device=q.device))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkrqc,bkcd->bkrqd", p, v.to(torch.float32))
    out = out / torch.clamp(l, min=1e-30)
    out = out.reshape(b, h, sq, d).to(q.dtype)
    return (out, _lse(m[..., 0], l[..., 0], (b, h, sq))) if with_lse else out
