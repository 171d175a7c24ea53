"""Paged attention over a global K/V page pool (kv16 pools).

Port of the paged part of ``repro.models.attention``. Pools are
``(n_pages, page_size, KV, d)``; position i of sequence b lives at
``(block_tables[b, i // page_size], i % page_size)``; page 0 is the
allocator's scratch page, where pad tokens (``q_pos == -1``) write.

Unlike the reference's pure functions, the writes here update the pools
*in place* and return the same tensors.

Attention always goes through the ``paged_attention_decode`` wrapper: every
query token becomes a one-token row with its own block-table row and
``kv_len = min(q_pos + 1, kv_lens)`` (0 for pads). That is exactly the
reference mask ``kpos <= q_pos && kpos < kv_lens`` — including intra-chunk
causality in prefill — so on a CUDA tensor both decode and packed prefill
run on the kernel, and on a CPU tensor on its plain version (whose core,
the reference's ``_attend_gathered``, is ``kernels/paged_attention/ref.py``
``attend_gathered``). Pad rows differ from the reference on purpose: they
come out 0, where the reference returns the mean of V; pad logits are
discarded and pad K/V land on page 0.
"""
from __future__ import annotations

import torch

from ..kernels.paged_attention.ops import paged_attention_decode


def paged_attention(q, k_pool, v_pool, block_tables, q_pos, kv_lens, *,
                    window=0, softcap=0.0, scale=None):
    """q: (B, T, H, d) — T query tokens per sequence; pools (n_pages, ps,
    KV, d); block_tables (B, max_pages) int32; q_pos (B, T) absolute
    positions (-1 = pad); kv_lens (B,) cache length including this chunk.
    Returns (B, T, H, d)."""
    if window > 0:
        raise NotImplementedError(
            "sliding-window paged attention: ROADMAP item 10 (gemma2) adds "
            "a window to the kernel")
    b, t, h, d = q.shape
    bt = block_tables.to(torch.int32).repeat_interleave(t, dim=0)
    q_pos = q_pos.to(torch.int32)
    lens = torch.minimum(q_pos + 1, kv_lens.to(torch.int32)[:, None])
    lens = torch.where(q_pos >= 0, lens, torch.zeros_like(lens))
    out = paged_attention_decode(q.reshape(b * t, h, d).contiguous(), k_pool,
                                 v_pool, bt.contiguous(),
                                 lens.reshape(-1).contiguous(),
                                 softcap=softcap, scale=scale)
    return out.reshape(b, t, h, d)


def _scatter_rows(k_pool, v_pool, k_new, v_new, flat):
    n_pages, ps, kv, d = k_pool.shape
    k_pool.view(n_pages * ps, kv, d)[flat] = k_new.reshape(-1, kv, d).to(
        k_pool.dtype)
    v_pool.view(n_pages * ps, kv, d)[flat] = v_new.reshape(-1, kv, d).to(
        v_pool.dtype)
    return k_pool, v_pool


def paged_write(k_pool, v_pool, k_new, v_new, block_tables, q_pos):
    """Scatter new K/V rows into the pools, in place, via block tables.

    k_new/v_new: (B, T, KV, d); q_pos (B, T) (-1 = pad). Pad rows write to
    scratch page 0, so duplicate pad writes are harmless."""
    ps = k_pool.shape[1]
    q_pos = q_pos.to(torch.int64)
    pos = torch.clamp(q_pos, min=0)
    page = torch.gather(block_tables.to(torch.int64), 1, pos // ps)
    flat = torch.where(q_pos >= 0, page * ps + pos % ps,
                       torch.zeros_like(pos)).reshape(-1)
    return _scatter_rows(k_pool, v_pool, k_new, v_new, flat)


def paged_write_packed(k_pool, v_pool, k_new, v_new, block_tables, seg_ids,
                       q_pos):
    """Packed variant, in place: k_new/v_new (1, T, KV, d); seg_ids/q_pos
    (1, T) (-1 = pad); block_tables (S, max_pages). Token i writes page
    ``block_tables[seg_ids[i], q_pos[i] // ps]``; pads write page 0."""
    ps = k_pool.shape[1]
    seg = torch.clamp(seg_ids[0].to(torch.int64), min=0)
    pos = torch.clamp(q_pos[0].to(torch.int64), min=0)
    page = block_tables.to(torch.int64)[seg, pos // ps]
    valid = (seg_ids[0] >= 0) & (q_pos[0] >= 0)
    flat = torch.where(valid, page * ps + pos % ps, torch.zeros_like(pos))
    return _scatter_rows(k_pool, v_pool, k_new, v_new, flat)


def paged_attention_packed(q, k_pool, v_pool, block_tables, seg_ids, q_pos,
                           kv_lens, *, window=0, softcap=0.0, scale=None):
    """Packed ragged attention: q (1, T, H, d); block_tables (S, max_pages);
    seg_ids/q_pos (1, T); kv_lens (S,). Token i attends over its own
    segment's row ``block_tables[seg_ids[i]]``, so cross-segment attention
    is zero by construction. Returns (1, T, H, d)."""
    seg = torch.clamp(seg_ids[0].to(torch.int64), min=0)
    valid = seg_ids[0] >= 0
    bt_tok = block_tables[seg]                            # (T, max_pages)
    lens_tok = torch.where(valid, kv_lens.to(torch.int32)[seg],
                           torch.zeros_like(seg, dtype=torch.int32))
    out = paged_attention(q[0][:, None], k_pool, v_pool, bt_tok,
                          q_pos[0][:, None], lens_tok, window=window,
                          softcap=softcap, scale=scale)
    return out[:, 0][None]
