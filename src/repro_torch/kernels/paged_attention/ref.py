"""Plain PyTorch versions of the paged-attention decode kernels.

Port of ``repro.kernels.paged_attention.ref`` and of the gather attention
it wraps (``repro.models.attention.paged_attention`` / ``_attend_gathered``
/ ``paged_attention_quant``): the pages are gathered (and, for quantized
pools, dequantized to the hot pools' type) into a (B, S_max, KV, d) copy
and attended with a masked softmax. One deliberate difference from the
reference: a row with ``kv_len == 0`` (a pad row, all keys masked) returns
exactly 0, as the kernels do, where the reference returns the mean of V.
A sliding window reaches the decode versions as a per-row first visible
position ``kv_start`` (``max(0, q_pos + 1 - window)``, the reference's
``kpos > q_pos - window``); a row with no visible key is 0 as well.
"""
from __future__ import annotations

import torch

from ...core.quantize import kv_dequantize_pages

_NEG_INF = -2.0e38


def attend_gathered(q, k, v, q_pos, kv_lens, *, window=0, softcap=0.0,
                    scale=None, kv_start=None):
    """Masked softmax attention over materialized per-sequence K/V.

    q: (B, T, H, d); k/v: (B, S, KV, d) with absolute position ``kpos = s``;
    q_pos (B, T) (-1 = pad); kv_lens (B,). Key s is visible to a query at
    q_pos when ``s <= q_pos``, ``s < kv_lens`` and (with ``window > 0``)
    ``s > q_pos - window``, and (with ``kv_start`` (B,)) ``s >=
    kv_start``. Scores and sums in f32; out in q's type."""
    b, t, h, d = q.shape
    kv = k.shape[2]
    rep = h // kv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    kpos = torch.arange(k.shape[1], device=q.device)
    qh = q.reshape(b, t, kv, rep, d).to(k.dtype)
    s = torch.einsum("btkrd,bskd->btkrs", qh.to(torch.float32),
                     k.to(torch.float32)) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    q_pos = q_pos.to(torch.int64)
    valid = kpos[None, None, :] <= q_pos[:, :, None]
    valid &= kpos[None, None, :] < kv_lens.to(torch.int64)[:, None, None]
    if window > 0:
        valid &= kpos[None, None, :] > q_pos[:, :, None] - window
    if kv_start is not None:
        valid &= kpos[None, None, :] >= kv_start.to(torch.int64)[:, None,
                                                                  None]
    s = torch.where(valid[:, :, None, None, :], s,
                    torch.full_like(s, _NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1)
    out = torch.einsum("btkrs,bskd->btkrd", p.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    out = out / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, t, h, d).to(q.dtype)


def _visible(out, kv_lens, kv_start):
    """``out`` with the rows that see no key (``kv_len <= kv_start``; pad
    rows have kv_len 0) set to exactly 0."""
    start = (torch.zeros_like(kv_lens) if kv_start is None
             else kv_start.to(kv_lens.dtype))
    return torch.where((kv_lens > start)[:, None, None], out,
                       torch.zeros_like(out))


def paged_attention_decode_ref(q, k_pool, v_pool, block_tables, kv_lens, *,
                               kv_start=None, softcap=0.0, scale=None):
    """q: (B, H, d), one query token per row at position ``kv_len - 1``;
    pools (n_pages, ps, KV, d); block_tables (B, max_pages); kv_lens (B,);
    kv_start (B,) each row's first visible position (``None``: 0). Returns
    (B, H, d); rows with ``kv_len <= kv_start`` are 0."""
    bt = block_tables.to(torch.int64)
    b = q.shape[0]
    k = k_pool[bt].reshape(b, -1, k_pool.shape[2], k_pool.shape[3])
    v = v_pool[bt].reshape(k.shape)
    q_pos = (kv_lens.to(torch.int64) - 1).reshape(-1, 1)
    out = attend_gathered(q[:, None], k, v, q_pos, kv_lens, softcap=softcap,
                          scale=scale, kv_start=kv_start)[:, 0]
    return _visible(out, kv_lens, kv_start)


def quant_gather(codes, scales, hot, block_tables, n_full, hot_rows, kv_bits):
    """Gathered K or V of quantized pools, in the hot pools' type:
    (B, max_pages * ps, KV, d). Page j of row b is dequantized from the
    codes pool when ``j < n_full[b]`` and read from hot row ``hot_rows[b]``
    when ``j == n_full[b]`` (later pages are dequantized too; the mask
    hides them). Port of the gather in the reference's
    ``paged_attention_quant``."""
    bt = block_tables.to(torch.int64)
    b, mp = bt.shape
    ps, kv, d = hot.shape[1:]
    deq = kv_dequantize_pages(codes[bt], scales[bt], kv_bits,
                              hot.dtype).reshape(b, mp * ps, kv, d)
    kpos = torch.arange(mp * ps, device=hot.device)
    in_hot = ((kpos[None, :] // ps) == n_full.to(torch.int64)[:, None])
    hot_kv = hot[hot_rows.to(torch.int64)][:, kpos % ps]
    return torch.where(in_hot[..., None, None], hot_kv, deq)


def paged_attention_decode_quant_ref(q, k_codes, k_scales, v_codes, v_scales,
                                     k_hot, v_hot, block_tables, kv_lens,
                                     hot_rows, *, kv_bits, n_full=None,
                                     kv_start=None, softcap=0.0, scale=None):
    """Plain version of the fused-dequant decode kernel. q: (B, H, d), one
    query token per row at position ``kv_len - 1``; codes/scales/hot pools
    as ``models.attention`` lays them out; ``hot_rows`` (B,) = slot + 1
    (0 = scratch); ``n_full`` (B,) committed pages per row, default
    ``kv_lens // page_size`` (packed prefill passes its segment's
    frontier); ``kv_start`` as in ``paged_attention_decode_ref``. Returns
    (B, H, d); rows with ``kv_len <= kv_start`` are 0."""
    ps = k_hot.shape[1]
    if n_full is None:
        n_full = kv_lens // ps
    k = quant_gather(k_codes, k_scales, k_hot, block_tables, n_full,
                     hot_rows, kv_bits)
    v = quant_gather(v_codes, v_scales, v_hot, block_tables, n_full,
                     hot_rows, kv_bits)
    q_pos = (kv_lens.to(torch.int64) - 1).reshape(-1, 1)
    out = attend_gathered(q[:, None], k, v, q_pos, kv_lens, softcap=softcap,
                          scale=scale, kv_start=kv_start)[:, 0]
    return _visible(out, kv_lens, kv_start)
