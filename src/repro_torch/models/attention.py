"""Attention of the port's model: the static path's chunked flash attention
and ring-buffer decode attention, and paged attention over a global K/V
page pool (kv16 and quantized pools).

Port of ``repro.models.attention``. ``flash_attention`` takes the model's
(B, S, H, d) layout and hands head-major views (no copy) to the
``flash_attention_fwd`` wrapper: kernel D on a CUDA tensor, which masks its
own ragged edge so nothing is padded, and the plain version on a CPU
tensor. ``decode_attention`` is plain torch, as the reference computes it
outside any kernel.

Paged pools are ``(n_pages, page_size, KV, d)``; position i of sequence b
lives at ``(block_tables[b, i // page_size], i % page_size)``; page 0 is the
allocator's scratch page, where pad tokens (``q_pos == -1``) write.

Unlike the reference's pure functions, the paged writes here update the pools
*in place* and return the same tensors (the quantized writes return the
same ``cache`` dict).

Paged attention always goes through the ``paged_attention_decode``
wrapper: every query token becomes a one-token row with its own
block-table row and ``kv_len = min(q_pos + 1, kv_lens)`` (0 for pads).
That is exactly the reference mask ``kpos <= q_pos && kpos < kv_lens`` —
including intra-chunk causality in prefill — so on a CUDA tensor both
decode and packed prefill run on the kernel, and on a CPU tensor on its
plain version (whose core, the reference's ``_attend_gathered``, is
``kernels/paged_attention/ref.py`` ``attend_gathered``). A sliding window
(gemma2's local layers) adds the reference's ``kpos > q_pos - window`` as
each token's first visible position ``max(0, q_pos + 1 - window)``,
computed on the device from ``q_pos`` (``_window_starts``), so no host
value enters a captured graph. Pad rows differ from the reference on
purpose: they come out 0, where the reference returns the mean of V; pad
logits are discarded and pad K/V land on page 0. Except where an MoE
expert can overflow (``mean_pads``, decided per dispatch shape by
``transformer._pads_reach_tokens``): routing gives every token of a
dispatch, pads included, a share of each expert's capacity, so a pad's
hidden state can then move a real token's; there a query that sees no key
(``q_pos < 0``) takes the reference's output, the mean of V over every
position of its block-table row (``_mean_for_pads``).
"""
from __future__ import annotations

import torch

from ..core.quantize import kv_quantize_pages
from ..kernels.flash_attention.ops import flash_attention_fwd
from ..kernels.paged_attention.ops import (paged_attention_decode,
                                           paged_attention_decode_quant)
from ..kernels.paged_attention.ref import quant_gather
from ..parallel import sharding as shd

_NEG_INF = -2.0e38


def _visible(q0, q1, k0, k1, causal, window, device):
    """(q1 - q0, k1 - k0) bool: the keys each query may see (positions
    from 0 on both sides), or None when the causal or window mask hides
    the whole chunk pair."""
    if causal and k0 > q1 - 1:
        return None
    if window > 0 and k1 - 1 <= q0 - window:
        return None
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    m = torch.ones((q1 - q0, k1 - k0), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0,
                        softcap=0.0, scale=None, chunk=512, q_offset=0):
    """Gradients (dq, dk, dv) of attention, in head-major layout: q, out,
    dout (B, H, Sq, d), k/v (B, KV, Skv, d), lse (B, H, Sq) f32 the
    forward's per-row log-sum-exp. Port of the reference's ``_flash_bwd``
    (``repro.models.attention``): the FlashAttention-2 recompute over
    ``chunk`` x ``chunk`` query/key pairs, in f32, with ``delta = sum(dout
    * out)``, GQA without a repeated K/V copy, the causal and window masks,
    the softcap's ``1 - tanh^2`` factor, and any Sq and Skv (ragged edges
    are masked where the reference pads, which adds exact zeros there).
    Chunk pairs the mask hides wholly are skipped, and masked weights are
    exactly 0. Query row i sits at position ``q_offset + i`` for the masks
    (the reference's ``q_offset``; a context-parallel rank's rows). Plain
    torch on every device: the reference's backward is jnp, not a Pallas
    kernel. Returns grads in the inputs' types."""
    b, h, sq, d = q.shape
    kv, skv = k.shape[1], k.shape[2]
    rep = h // kv
    scale = float(scale if scale is not None else d ** -0.5)
    f32 = torch.float32
    qg = q.reshape(b, kv, rep, sq, d)
    dog = dout.reshape(b, kv, rep, sq, d).to(f32)
    delta = torch.sum(dog * out.reshape(b, kv, rep, sq, d).to(f32), dim=-1)
    lseg = lse.reshape(b, kv, rep, sq)
    dq = torch.zeros((b, kv, rep, sq, d), dtype=f32, device=q.device)
    dk = torch.zeros((b, kv, skv, d), dtype=f32, device=q.device)
    dv = torch.zeros((b, kv, skv, d), dtype=f32, device=q.device)
    for q0 in range(0, sq, chunk):
        q1 = min(q0 + chunk, sq)
        qc = qg[:, :, :, q0:q1].to(f32)
        doc = dog[:, :, :, q0:q1]
        lsec = lseg[:, :, :, q0:q1, None]
        deltac = delta[:, :, :, q0:q1, None]
        for k0 in range(0, skv, chunk):
            k1 = min(k0 + chunk, skv)
            m = _visible(q_offset + q0, q_offset + q1, k0, k1, causal,
                         window, q.device)
            if m is None:
                continue
            kc = k[:, :, k0:k1].to(f32)
            vc = v[:, :, k0:k1].to(f32)
            s_raw = torch.einsum("bkrqd,bkcd->bkrqc", qc, kc) * scale
            s = (softcap * torch.tanh(s_raw / softcap) if softcap > 0
                 else s_raw)
            p = torch.where(m, torch.exp(s - lsec), 0.0)
            dp = torch.einsum("bkrqd,bkcd->bkrqc", doc, vc)
            ds = p * (dp - deltac)
            if softcap > 0:
                ds = ds * (1.0 - torch.tanh(s_raw / softcap) ** 2)
            dq[:, :, :, q0:q1] += scale * torch.einsum(
                "bkrqc,bkcd->bkrqd", ds, kc)
            dk[:, :, k0:k1] += scale * torch.einsum(
                "bkrqc,bkrqd->bkcd", ds, qc)
            dv[:, :, k0:k1] += torch.einsum("bkrqc,bkrqd->bkcd", p, doc)
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class _Flash(torch.autograd.Function):
    """Kernel D (or its plain version on a CPU tensor) with the per-row
    log-sum-exp saved, and ``flash_attention_bwd`` as its backward: the
    reference's ``jax.custom_vjp`` pair ``_flash_fwd`` / ``_flash_bwd``.
    Head-major (B, H, S, d) inputs."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale, q_offset):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                  softcap=softcap, scale=scale, lse=lse,
                                  q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale, q_offset=q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, q_offset=0):
    """Attention over a whole sequence. q: (B, Sq, H, d), k/v: (B, Skv, KV,
    d) -> (B, Sq, H, d), any Sq and Skv. Kernel D on a CUDA tensor (head-
    major strided views, no padding or transposed copy), its plain version
    on a CPU tensor. Where grad mode is on and q, k or v requires grad, it
    runs under the autograd Function ``_Flash`` on either device (forward
    with the log-sum-exp, backward ``flash_attention_bwd``); otherwise
    (serving) it calls the forward alone, without the log-sum-exp. Query
    row i sits at position ``q_offset + i`` for the causal and window masks
    (context parallelism: a rank's rows against the gathered K/V,
    ``layers._cp_attention``). The reference's chunk sizes are not taken:
    the kernel tiles by 64 and masks the ragged edge itself."""
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = _Flash.apply(qh, kh, vh, causal, int(window), float(softcap),
                           scale, int(q_offset))
    else:
        out = flash_attention_fwd(qh, kh, vh, causal=causal, window=window,
                                  softcap=softcap, scale=scale,
                                  q_offset=int(q_offset))
    return out.transpose(1, 2)


def decode_attention(q, k_cache, v_cache, positions, cur_pos, *, window=0,
                     softcap=0.0, scale=None, combine=None, dsum=None):
    """Single-token attention against a ring-buffer cache. q: (B, 1, H, d);
    caches (B, S, KV, d); positions (B, S) int32 position of each cache
    entry (-1 = empty); cur_pos (B,). Entry s is visible when ``0 <=
    positions[b, s] <= cur_pos[b]`` (and inside the window). Products of
    cache-type values summed in f32 — here by upcasting to f32, which is
    exact — and ``p`` rounded to the cache's type before the PV product, as
    the reference computes it.

    ``combine`` = (a rank's ``ParallelContext``, mesh axes): the caches
    and positions are this rank's block of a sequence cut over those axes
    (a ``kv_seq`` ring), and the flash-decode combine the reference
    leaves to XLA runs here: the row maxima are maxed over the group
    first, so every rank weighs its block by the global ``M`` (``p``
    rounded as above), then the sums of ``p`` and of ``p V`` are summed
    over the group in rank order. A block with no visible entry gives
    ``p = exp(-2e38 - M) = 0``, never a NaN; where no rank sees one, ``M``
    is the mask value on every rank and each entry weighs 1, as in the
    reference.

    ``dsum`` = (a rank's ``ParallelContext``, mesh axes): q and the caches
    hold this rank's slice of d, cut over those axes (a ``head_dim``
    cut); the partial scores are summed over the group in rank order
    before the scale, so every rank weighs the same ``p``, and the
    output is the rank's slice of d (``scale`` must then be given: the
    local d is not the head's)."""
    if dsum is not None and scale is None:
        raise ValueError("decode_attention: a head_dim cut (dsum) needs the "
                         "head's scale: the local d is a slice of it")
    b, _, kv, d = k_cache.shape
    h = q.shape[2]
    rep = h // kv
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    f32 = torch.float32
    qh = q.reshape(b, kv, rep, d).to(k_cache.dtype).to(f32)
    sc = torch.einsum("bkrd,bskd->bkrs", qh, k_cache.to(f32))
    if dsum is not None:
        sc = shd.raw_psum(dsum[0], sc, dsum[1])
    sc = sc * scale
    if softcap > 0:
        sc = softcap * torch.tanh(sc / softcap)
    cur = cur_pos.to(positions.dtype)[:, None]
    valid = (positions <= cur) & (positions >= 0)
    if window > 0:
        valid &= positions > cur - window
    sc = torch.where(valid[:, None, None, :], sc,
                     torch.tensor(_NEG_INF, device=sc.device))
    m = sc.amax(dim=-1, keepdim=True)
    if combine is not None:
        m = shd.raw_pmax(combine[0], m, combine[1])
    p = torch.exp(sc - m)
    l = p.sum(dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", p.to(v_cache.dtype).to(f32),
                       v_cache.to(f32))
    if combine is not None:
        lo = shd.raw_psum(combine[0], torch.cat([l[..., None], out], -1),
                          combine[1])
        l, out = lo[..., 0], lo[..., 1:]
    out = out / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, 1, h, d).to(q.dtype)


def _rows_per_token(block_tables, t):
    """(B, max_pages) -> (B * t, max_pages) int32: each row once per query
    token, with shapes alone (no host sync)."""
    b, mp = block_tables.shape
    return block_tables.to(torch.int32)[:, None].expand(b, t, mp).reshape(
        b * t, mp)


def _window_starts(q_pos, window):
    """(B*T,) int32 first visible key position of each query token:
    ``max(0, q_pos + 1 - window)``, all 0 without a window (``window`` a
    Python int, constant per layer) and for pads."""
    q_pos = q_pos.reshape(-1).to(torch.int32)
    if window <= 0:
        return torch.zeros_like(q_pos)
    return torch.clamp(q_pos + (1 - int(window)), min=0)


def _mean_for_pads(out, q_pos, v_rows):
    """``out`` (B, T, H, d) with each query that sees no key (``q_pos <
    0``) replaced by the reference's output for it: its masked softmax
    weighs every gathered position alike, so it is the f32 mean of V over
    its block-table row. ``v_rows`` (R, S, KV, d), the gathered V of each
    of the B rows, or of one row every pad shares (R = 1)."""
    h, d = out.shape[2:]
    mean = v_rows.to(torch.float32).mean(dim=1)               # (R, KV, d)
    kv = mean.shape[1]
    mean = mean[:, :, None].expand(-1, kv, h // kv, d).reshape(-1, 1, h, d)
    return torch.where((q_pos < 0)[..., None, None], mean.to(out.dtype), out)


def paged_attention(q, k_pool, v_pool, block_tables, q_pos, kv_lens, *,
                    window=0, softcap=0.0, scale=None, mean_pads=False):
    """q: (B, T, H, d) — T query tokens per sequence; pools (n_pages, ps,
    KV, d); block_tables (B, max_pages) int32; q_pos (B, T) absolute
    positions (-1 = pad); kv_lens (B,) cache length including this chunk;
    ``window`` > 0 hides keys at or below ``q_pos - window``;
    ``mean_pads``: pads take the reference's mean of V over their row.
    Returns (B, T, H, d)."""
    b, t, h, d = q.shape
    bt = _rows_per_token(block_tables, t)
    q_pos = q_pos.to(torch.int32)
    lens = torch.minimum(q_pos + 1, kv_lens.to(torch.int32)[:, None])
    lens = torch.where(q_pos >= 0, lens, torch.zeros_like(lens))
    out = paged_attention_decode(q.reshape(b * t, h, d).contiguous(), k_pool,
                                 v_pool, bt.contiguous(),
                                 lens.reshape(-1).contiguous(),
                                 kv_start=_window_starts(q_pos, window),
                                 softcap=softcap, scale=scale)
    out = out.reshape(b, t, h, d)
    if mean_pads:
        out = _mean_for_pads(out, q_pos, v_pool[block_tables.long()].reshape(
            b, -1, *v_pool.shape[2:]))
    return out


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
                           kv_lens, *, window=0, softcap=0.0, scale=None,
                           mean_pads=False):
    """Packed ragged attention: q (1, T, H, d); block_tables (S, max_pages);
    seg_ids/q_pos (1, T); kv_lens (S,). Token i attends over its own
    segment's row ``block_tables[seg_ids[i]]``, so cross-segment attention
    is zero by construction; ``mean_pads``: pads take the mean of V over
    segment 0's row, the row the reference gathers for them. Returns (1,
    T, H, d)."""
    seg = torch.clamp(seg_ids[0].to(torch.int64), min=0)
    valid = seg_ids[0] >= 0
    bt_tok = block_tables[seg]                            # (T, max_pages)
    lens_tok = torch.where(valid, kv_lens.to(torch.int32)[seg],
                           torch.zeros_like(seg, dtype=torch.int32))
    out = paged_attention(q[0][:, None], k_pool, v_pool, bt_tok,
                          q_pos[0][:, None], lens_tok, window=window,
                          softcap=softcap, scale=scale)
    if mean_pads:
        out = _mean_for_pads(out, q_pos[0][:, None], v_pool[
            block_tables[:1].long()].reshape(1, -1, *v_pool.shape[2:]))
    return out[:, 0][None]


# ---------------------------------------------------------------------------
# Quantized page pools (kv_bits 8|4; DESIGN.md Sec. 15)
#
# Dual-pool layout per layer period:
#   k_codes/v_codes   (n_pages, ps, KV, hd or hd//2)  packed committed pages
#   k_scales/v_scales (n_pages, KV, n_blocks, G)      per-page codebooks
#   k_hot/v_hot       (max_seqs+1, ps, KV, hd)        full-precision partial
#                                                     pages, row slot + 1
# Writes land in the row's hot row; every page a dispatch *completes* is
# quantized in the same dispatch and scattered into the packed pools (page
# 0 and hot row 0 are the scratch of pad rows). Attention reads committed
# pages through the fused-dequant kernel and the frontier page from the
# hot row. Both writes and reads are per token, so the unpacked (B, T)
# batch and the packed (1, T) row share one implementation.
# ---------------------------------------------------------------------------


def _write_quant(cache, k_src, v_src, tok_row, tok_pos, block_tables,
                 kv_lens, slots, base, n_valid, row_len, kv_bits):
    """Hot write + commit-time quantization, in place, over a flat token
    list. k_src/v_src (N, KV, hd) roped K/V; tok_row/tok_pos (N,) each
    token's batch row and absolute position (-1 = pad); per row (R,):
    kv_lens (length incl. this dispatch), slots (-1 = pad row), base (flat
    index of the row's first token), n_valid (its token count); row_len
    the most tokens a row can carry (T).

    A row completes at most ``n_valid // ps + 1`` pages, so at most
    ``N // ps + R`` of the ``R * (T // ps + 1)`` candidate pages the
    reference quantizes are real commits; a stable sort on the device
    moves the completed ones first and only that many are quantized (no
    host sync, same committed bytes)."""
    k_hot, v_hot = cache["k_hot"], cache["v_hot"]
    n_hot, ps, kv, hd = k_hot.shape
    n_tok = k_src.shape[0]
    r, mp = block_tables.shape
    dtype = k_hot.dtype
    dev = k_hot.device
    kv_lens = kv_lens.to(torch.int64)
    row = torch.where(slots >= 0, slots.to(torch.int64) + 1,
                      torch.zeros_like(slots, dtype=torch.int64))

    # -- which pages this dispatch completes (candidates as the reference)
    start = kv_lens - n_valid                  # first position of the chunk
    n_cand = row_len // ps + 1
    jp = start[:, None] // ps + torch.arange(n_cand, device=dev)[None, :]
    completed = ((jp + 1) * ps <= kv_lens[:, None]) & (n_valid[:, None] > 0)
    sel = torch.arange(r * n_cand, device=dev)
    n_sel = min(r * n_cand, n_tok // ps + r)
    if n_sel < r * n_cand:
        sel = torch.argsort((~completed).reshape(-1).to(torch.int8),
                            stable=True)[:n_sel]
    sel_row = sel // n_cand
    sel_jp = jp.reshape(-1)[sel]
    sel_done = completed.reshape(-1)[sel]

    # -- page content: positions >= start from this dispatch, earlier ones
    # from the *old* hot row (read before the hot write below overwrites it)
    gp = sel_jp[:, None] * ps + torch.arange(ps, device=dev)[None, :]
    s0 = start[sel_row][:, None]
    from_new = (gp >= s0)[..., None, None]
    tidx = torch.clamp(base[sel_row].to(torch.int64)[:, None] + gp - s0, 0,
                       n_tok - 1)
    old_rows = row[sel_row]
    k_content = torch.where(from_new, k_src[tidx].to(dtype), k_hot[old_rows])
    v_content = torch.where(from_new, v_src[tidx].to(dtype), v_hot[old_rows])

    # -- hot write: only positions on the row's final page
    valid = tok_row >= 0
    trow = torch.clamp(tok_row.to(torch.int64), min=0)
    pos = torch.clamp(tok_pos.to(torch.int64), min=0)
    in_final = valid & (tok_pos >= 0) & (pos // ps == kv_lens[trow] // ps)
    flat = torch.where(in_final, row[trow] * ps + pos % ps,
                       torch.zeros_like(pos))
    k_hot.view(n_hot * ps, kv, hd)[flat] = k_src.to(dtype)
    v_hot.view(n_hot * ps, kv, hd)[flat] = v_src.to(dtype)

    # -- commit-quantize (K and V in one solve) and scatter
    m = sel.shape[0]
    codes, scales = kv_quantize_pages(torch.cat([k_content, v_content]),
                                      kv_bits)
    pidx = torch.where(sel_done,
                       block_tables.to(torch.int64)[
                           sel_row, torch.clamp(sel_jp, 0, mp - 1)],
                       torch.zeros_like(sel_jp))
    cache["k_codes"][pidx] = codes[:m]
    cache["v_codes"][pidx] = codes[m:]
    cache["k_scales"][pidx] = scales[:m].to(cache["k_scales"].dtype)
    cache["v_scales"][pidx] = scales[m:].to(cache["v_scales"].dtype)
    return cache


def paged_write_quant(cache, k_new, v_new, block_tables, q_pos, kv_lens,
                      slots, kv_bits):
    """Hot-page write + commit-time quantization (quantize-on-commit), in
    place. cache: dict(k_codes, v_codes, k_scales, v_scales, k_hot, v_hot)
    of one layer period; k_new/v_new (B, T, KV, hd) roped; q_pos (B, T)
    (-1 = pad, valid tokens first); kv_lens (B,) length incl. this chunk;
    slots (B,) engine slot ids (-1 = pad row). Returns ``cache``."""
    b, t = q_pos.shape
    kv, hd = k_new.shape[2:]
    dev = q_pos.device
    valid = q_pos >= 0
    tok_row = torch.where(valid, torch.arange(b, device=dev)[:, None],
                          torch.full_like(q_pos, -1, dtype=torch.int64))
    return _write_quant(
        cache, k_new.reshape(b * t, kv, hd), v_new.reshape(b * t, kv, hd),
        tok_row.reshape(-1), q_pos.reshape(-1), block_tables, kv_lens, slots,
        torch.arange(b, device=dev) * t, valid.sum(dim=1), t, kv_bits)


def paged_write_quant_packed(cache, k_new, v_new, block_tables, seg_ids,
                             q_pos, kv_lens, slots, seg_off, kv_bits):
    """Packed variant, in place: k_new/v_new (1, T, KV, hd); seg_ids/q_pos
    (1, T) (-1 = pad); block_tables (S, max_pages); kv_lens/slots/seg_off
    (S,) — ``seg_off`` is each segment's first index in the packed row."""
    s = block_tables.shape[0]
    valid = (seg_ids[0] >= 0) & (q_pos[0] >= 0)
    tok_row = torch.where(valid, seg_ids[0].to(torch.int64),
                          torch.full_like(seg_ids[0], -1, dtype=torch.int64))
    n_valid = torch.zeros(s, dtype=torch.int64, device=q_pos.device)
    n_valid.index_add_(0, torch.clamp(tok_row, min=0), valid.to(torch.int64))
    return _write_quant(cache, k_new[0], v_new[0], tok_row, q_pos[0],
                        block_tables, kv_lens, slots, seg_off, n_valid,
                        q_pos.shape[1], kv_bits)


def paged_attention_quant(q, cache, block_tables, q_pos, kv_lens, slots,
                          kv_bits, *, window=0, softcap=0.0, scale=None,
                          mean_pads=False):
    """Attention over quantized pools + the hot partial page, through the
    ``paged_attention_decode_quant`` wrapper, one row per query token.
    q: (B, T, H, d); q_pos (B, T); kv_lens (B,) incl. this chunk; slots
    (B,). Each token's causal bound ``min(q_pos + 1, kv_lens)`` and its
    row's frontier page ``kv_lens // ps`` go to the kernel separately: in
    a prefill chunk, pages before the frontier that this dispatch completed
    are read from their fresh codes, as the reference reads them.
    ``mean_pads``: pads take the mean of V over their row as the reference
    gathers it (dequantized, the frontier page from the hot row). Returns
    (B, T, H, d)."""
    b, t, h, d = q.shape
    ps = cache["k_hot"].shape[1]
    q_pos = q_pos.to(torch.int32)
    kv_lens = kv_lens.to(torch.int32)
    lens = torch.minimum(q_pos + 1, kv_lens[:, None])
    lens = torch.where(q_pos >= 0, lens, torch.zeros_like(lens))
    n_full = (kv_lens // ps)[:, None].expand(b, t)
    rows = torch.where(slots >= 0, slots + 1, torch.zeros_like(slots))
    rows = rows.to(torch.int32)[:, None].expand(b, t)
    bt = _rows_per_token(block_tables, t)
    out = paged_attention_decode_quant(
        q.reshape(b * t, h, d).contiguous(), cache["k_codes"],
        cache["k_scales"], cache["v_codes"], cache["v_scales"],
        cache["k_hot"], cache["v_hot"], bt.contiguous(),
        lens.reshape(-1).contiguous(), rows.reshape(-1).contiguous(),
        kv_bits=kv_bits, n_full=n_full.reshape(-1).contiguous(),
        kv_start=_window_starts(q_pos, window), softcap=softcap, scale=scale)
    out = out.reshape(b, t, h, d)
    if mean_pads:
        out = _mean_for_pads(out, q_pos, quant_gather(
            cache["v_codes"], cache["v_scales"], cache["v_hot"],
            block_tables, n_full[:, 0], rows[:, 0], kv_bits))
    return out


def paged_attention_quant_packed(q, cache, block_tables, seg_ids, q_pos,
                                 kv_lens, slots, kv_bits, *, window=0,
                                 softcap=0.0, scale=None, mean_pads=False):
    """Packed attention over quantized pools: per-token segment views of
    block tables, lengths and slots, then ``paged_attention_quant``.
    q (1, T, H, d); seg_ids/q_pos (1, T); ``mean_pads``: pads take the
    mean of V over segment 0's row with the frontier page 0 from scratch
    hot row 0, as the reference gathers it for them. Returns (1, T, H,
    d)."""
    seg = torch.clamp(seg_ids[0].to(torch.int64), min=0)
    valid = seg_ids[0] >= 0
    lens_tok = torch.where(valid, kv_lens.to(torch.int32)[seg],
                           torch.zeros_like(seg, dtype=torch.int32))
    slots_tok = torch.where(valid, slots.to(torch.int32)[seg],
                            torch.full_like(seg, -1, dtype=torch.int32))
    out = paged_attention_quant(q[0][:, None], cache, block_tables[seg],
                                q_pos[0][:, None], lens_tok, slots_tok,
                                kv_bits, window=window, softcap=softcap,
                                scale=scale)
    if mean_pads:
        zero = torch.zeros(1, dtype=torch.int32, device=q.device)
        out = _mean_for_pads(out, q_pos[0][:, None], quant_gather(
            cache["v_codes"], cache["v_scales"], cache["v_hot"],
            block_tables[:1], zero, zero, kv_bits))
    return out[:, 0][None]
