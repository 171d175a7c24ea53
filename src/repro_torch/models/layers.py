"""Transformer building blocks (plain functions, params as dicts).

Port of ``repro.models.layers``: norms and RoPE in f32, projections
through ``dense`` (the msb_matmul kernel for packed weights, qwen's qkv
bias fused into it), ``attention_layer``'s static branches (whole-sequence
flash attention for prefill and the loss, causal or not, self- or
cross-attention; ring-buffer decode; cross-attention decode over the
static encoder K/V) and its paged branches over kv16 and quantized
(kv_bits 8|4) pools, and the chunked cross-entropy (rematerialized per
chunk under autograd).

Under a ``parallel.TPShard`` (one rank of a tensor-parallel mesh,
DESIGN.md Sec. 10) the functions run on the rank's shard: a row-parallel
(K-sharded) projection sums its partial products over the ranks
(``dense``), column-sharded QKV projections give the rank's heads, a
head-sharded paged pool over replicated projections takes the rank's
slice of the computed heads, and the heads are gathered before a
replicated output projection.

Under a ``parallel.ParallelContext`` (training on a process mesh) a block
runs through ``Spmd``, a rank's view of the context: the params are the
rank's blocks of every leaf (``resolve_spec``), gathered where the work
needs them whole; the residual stream is held ``S / tp`` rows long
between blocks when ``S % tp == 0`` (Megatron-SP, the reference's
``("batch", "sp", None)`` constraint); attention shards its heads over
``model`` where ``_qkv_axes`` says so (column-parallel QKV, row-parallel
output, a psum), else runs context-parallel (``_cp_attention``: K/V
gathered, kernel D with the rank's ``q_offset``) where ``use_cp`` holds,
else the ``model`` ranks duplicate it.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from ..core.quantize import PackedQTensor, QTensor
from ..kernels.msb_matmul.ops import packed_matmul
from ..parallel import sharding as shd
from ..parallel.sharding import ParallelContext, TPShard
from .attention import (decode_attention, flash_attention,
                        paged_attention, paged_attention_packed,
                        paged_attention_quant, paged_attention_quant_packed,
                        paged_write, paged_write_packed, paged_write_quant,
                        paged_write_quant_packed)


def rms_norm(x, scale, eps=1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def rope(x, positions, theta=10000.0):
    """Rotary embeddings. x: (..., S, H, d); positions (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def dense(x, w, b=None, tp=None):
    """y = x @ w (+ b), dispatching on the weight representation: packed
    weights run the msb_matmul kernel (bias fused), QTensors dequantize,
    plain tensors multiply as they are. ``tp`` (a ``TPShard``): a K- (row-)
    sharded quantized weight gives partial products, summed over the ranks
    before the bias is added; an N- (column-) sharded one needs nothing,
    the caller works on the rank's slice of features."""
    psum = tp if tp is not None and getattr(w, "shard", None) == "k" \
        else None
    if isinstance(w, PackedQTensor):
        return packed_matmul(x, w, bias=b, psum=psum)
    if isinstance(w, QTensor):
        w = w.dequantize()
    y = torch.matmul(x, w.to(x.dtype))
    if psum is not None:
        y = psum.psum(y)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def tp_of(parallel):
    """The ``TPShard`` of a ``parallel=`` argument with more than one rank,
    else None: None for no parallelism, and for a ``ParallelContext`` (or
    a block's ``Spmd`` view of one), whose GSPMD path the model functions
    take themselves. Anything else is refused."""
    if parallel is None or isinstance(parallel, (ParallelContext, Spmd)):
        return None
    if not isinstance(parallel, TPShard):
        raise TypeError(f"parallel=: expected a TPShard or a "
                        f"ParallelContext, got {type(parallel).__name__}")
    return parallel if parallel.size > 1 else None


def heads_split(cfg, tp):
    """Whether a rank's paged pools hold ``n_kv_heads / tp.size`` heads:
    both head counts divide the mesh (the reference's ``heads_ok``). With
    replicated attention projections every rank then attends its slice of
    the computed heads."""
    return (tp is not None and cfg.n_heads % tp.size == 0
            and cfg.n_kv_heads % tp.size == 0)


def _attn_out_proj(out, wo, tp, full_h):
    """Output projection (B, T, h_local, d) -> (B, T, D). A row-sharded
    ``wo`` takes the rank's heads and ``dense`` sums the partial products;
    a replicated ``wo`` after head-sliced attention first gathers the heads
    (rank-major, the global head order)."""
    b, t = out.shape[:2]
    if (tp is not None and out.shape[2] != full_h
            and getattr(wo, "shard", None) != "k"):
        out = tp.all_gather(out, dim=2)
    return dense(out.reshape(b, t, -1), wo, tp=tp)


def attention_layer(p, x, cfg, positions=None, *, window=0, cache=None,
                    cur_pos=None, xattn_kv=None, causal=True, cross=False,
                    decode_positions=None, paged=None, mean_pads=False,
                    parallel=None):
    """Self- or cross-attention. Returns (out, new_cache). RoPE on q and k
    where ``cfg.use_rope`` (not jamba, whisper), never in cross-attention.

    Prefill and loss: ``cache`` None -> flash attention over the sequence
    at ``positions`` (S,) or (B, S), causal when ``causal`` (not whisper's
    encoder); the new cache is the (roped) {"k", "v"} (B, S, KV, d). With
    ``xattn_kv`` (B, S_enc, D) it is cross-attention: K/V from the encoder
    rows, not causal (Sq != Skv), and the new cache is their {"k", "v"}.
    Ring decode: ``cache`` = {"k", "v"} ring buffers (B, S_max, KV, d),
    written in place at slot ``cur_pos[0] % S_max`` (the reference's one
    shared slot) and attended under ``decode_positions`` (B, S_max), the
    position table the model keeps; returns the same dict. Cross-attention
    decode (``cross=True``): ``cache`` holds the static encoder K/V, every
    row visible (``decode_attention`` at ``cur_pos`` S - 1 over positions
    0..S-1, as the reference computes it), returned as it is.
    Paged serving: ``paged`` = dict(block_tables, q_pos, kv_lens
    [, seg_ids][, slots, seg_off, kv_bits]); ``cache`` = this layer's
    pools, written in place: {"k", "v"} at kv16, or the quantized dual
    pools {"k_codes", "v_codes", "k_scales", "v_scales", "k_hot", "v_hot"}
    (hot-row write, commit-time quantization, fused-dequant attention).
    With ``seg_ids`` the (1, T) row is a packed ragged prefill: per-token
    segment ids route every write and read to the token's own block-table
    row. ``window`` > 0 (a Python int; gemma2's local layers) hides keys at
    or below ``q_pos - window`` on every path. ``mean_pads`` (paged): pads
    take the reference's mean of V over their row, for dispatches where a
    pad can move a real token (``transformer._pads_reach_tokens``).
    ``parallel`` (a ``TPShard``): column-sharded QKV projections give this
    rank's heads (the static caches then hold them too); replicated ones
    over a head-sharded paged pool (``heads_split``) are sliced to them;
    see the module docstring."""
    tp = tp_of(parallel)
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    b = x.shape[0]
    w_sharded = tp is not None and getattr(p["wq"], "shard", None) == "n"
    h_l, kv_l = (h // tp.size, kv // tp.size) if w_sharded else (h, kv)
    q = dense(x, p["wq"], p.get("bq"), tp=tp).reshape(b, -1, h_l, hd)
    softcap = cfg.attn_softcap
    scale = hd ** -0.5 if cfg.query_scale == 0 else cfg.query_scale
    if cross and cache is not None:
        s = cache["k"].shape[1]
        pos_tab = torch.arange(s, dtype=torch.int32, device=x.device)[
            None].expand(b, s)
        out = decode_attention(q, cache["k"], cache["v"], pos_tab,
                               torch.full((b,), s - 1, dtype=torch.int32,
                                          device=x.device),
                               softcap=softcap, scale=scale)
        return _attn_out_proj(out, p["wo"], tp, h), cache
    kv_src = x if xattn_kv is None else xattn_kv
    k = dense(kv_src, p["wk"], p.get("bk"), tp=tp).reshape(b, -1, kv_l, hd)
    v = dense(kv_src, p["wv"], p.get("bv"), tp=tp).reshape(b, -1, kv_l, hd)
    if paged is None:
        return _static_attention(p, q, k, v, cfg, positions, cache, cur_pos,
                                 decode_positions, window, softcap, scale,
                                 causal and xattn_kv is None,
                                 xattn_kv is None and cfg.use_rope, tp)
    if not w_sharded and heads_split(cfg, tp):
        # replicated projections over a head-sharded pool: every rank
        # computed all heads and keeps its contiguous slice
        r, h_l, kv_l = tp.rank, h // tp.size, kv // tp.size
        q = q[:, :, r * h_l:(r + 1) * h_l].contiguous()
        k = k[:, :, r * kv_l:(r + 1) * kv_l].contiguous()
        v = v[:, :, r * kv_l:(r + 1) * kv_l].contiguous()
    q_pos = paged["q_pos"]
    if cfg.use_rope:
        safe_pos = torch.clamp(q_pos, min=0)
        q = rope(q, safe_pos, cfg.rope_theta)
        k = rope(k, safe_pos, cfg.rope_theta)
    seg_ids = paged.get("seg_ids")
    t = q.shape[1]
    kw = dict(window=window, softcap=softcap, scale=scale,
              mean_pads=mean_pads)
    if "k_codes" in cache:
        kv_bits = paged["kv_bits"]
        if seg_ids is not None:
            cache = paged_write_quant_packed(
                cache, k, v, paged["block_tables"], seg_ids, q_pos,
                paged["kv_lens"], paged["slots"], paged["seg_off"], kv_bits)
            out = paged_attention_quant_packed(
                q, cache, paged["block_tables"], seg_ids, q_pos,
                paged["kv_lens"], paged["slots"], kv_bits, **kw)
        else:
            cache = paged_write_quant(
                cache, k, v, paged["block_tables"], q_pos, paged["kv_lens"],
                paged["slots"], kv_bits)
            out = paged_attention_quant(
                q, cache, paged["block_tables"], q_pos, paged["kv_lens"],
                paged["slots"], kv_bits, **kw)
        return _attn_out_proj(out, p["wo"], tp, h), cache
    if seg_ids is not None:
        k_pool, v_pool = paged_write_packed(
            cache["k"], cache["v"], k, v, paged["block_tables"], seg_ids,
            q_pos)
        out = paged_attention_packed(
            q, k_pool, v_pool, paged["block_tables"], seg_ids, q_pos,
            paged["kv_lens"], **kw)
    else:
        k_pool, v_pool = paged_write(cache["k"], cache["v"], k, v,
                                     paged["block_tables"], q_pos)
        out = paged_attention(q, k_pool, v_pool, paged["block_tables"],
                              q_pos, paged["kv_lens"], **kw)
    return (_attn_out_proj(out, p["wo"], tp, h),
            {"k": k_pool, "v": v_pool})


def _static_attention(p, q, k, v, cfg, positions, cache, cur_pos,
                      decode_positions, window, softcap, scale, causal,
                      use_rope, tp):
    if cache is None:
        if use_rope:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        out = flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap, scale=scale)
        new_cache = {"k": k, "v": v}
    else:
        if use_rope:
            q = rope(q, cur_pos[:, None], cfg.rope_theta)
            k = rope(k, cur_pos[:, None], cfg.rope_theta)
        slot = (cur_pos[:1] % cache["k"].shape[1]).to(torch.int64)
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        out = decode_attention(q, cache["k"], cache["v"], decode_positions,
                               cur_pos, window=window, softcap=softcap,
                               scale=scale)
        new_cache = cache
    return _attn_out_proj(out, p["wo"], tp, cfg.n_heads), new_cache


def mlp_layer(p, x, tp=None):
    """SwiGLU MLP. Under a ``TPShard``, wg/wi are column-sharded (the
    rank's slice of the hidden width, padded to whole MSB blocks a rank)
    and wo row-sharded (``dense`` sums the partial products)."""
    gate = torch.nn.functional.silu(
        dense(x, p["wg"], tp=tp).to(torch.float32)).to(x.dtype)
    up = dense(x, p["wi"], tp=tp)
    return dense(gate * up, p["wo"], tp=tp)


def grad_on(*tensors):
    """Whether autograd records through these tensors (grad mode on and
    one of them requires grad): where remat pays."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tensors if isinstance(t, torch.Tensor))


def remat(fn, *args, on=True):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``on``: its
    activations are recomputed in the backward instead of kept, as the
    reference's ``jax.checkpoint`` does; the numbers do not change."""
    if not on:
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False, preserve_rng_state=False)


def _chunk_xent(hc, w, lc, mc, softcap, keep, z_loss, tp):
    logits = hc.to(torch.float32) @ w.t()
    if tp is not None:
        logits = tp.all_gather(logits, dim=-1)
    if softcap > 0:
        logits = softcap * torch.tanh(logits / softcap)
    if keep is not None:
        logits = torch.where(keep, logits,
                             torch.tensor(-1e30, device=logits.device))
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc[..., None])[..., 0]
    return torch.sum((lse - gold) * mc + z_loss * lse ** 2 * mc)


def chunked_softmax_xent(hidden, unembed_vd, labels, mask, chunk=512,
                         softcap=0.0, z_loss=1e-4, vocab_real=None, tp=None):
    """Mean cross-entropy (plus the z-loss) over masked positions, one
    chunk of positions at a time so the (B, S, V) logits never exist
    whole. Differentiable: under autograd each chunk is rematerialized
    (the reference's ``@jax.checkpoint`` ``chunk_loss``), so the backward
    holds one chunk's f32 logits at a time. hidden (B, S, D), labels/mask
    (B, S), unembed_vd (V_padded, D); padded vocab rows are masked to
    -1e30. ``tp`` (a ``TPShard``): ``unembed_vd`` is this rank's vocab
    shard, and each chunk's logits are gathered over the ranks before the
    softmax (not differentiable)."""
    tot, cnt = xent_sums(hidden, unembed_vd, labels, mask, chunk, softcap,
                         z_loss, vocab_real, tp)
    return tot / torch.clamp(cnt, min=1.0)


def xent_sums(hidden, unembed_vd, labels, mask, chunk=512, softcap=0.0,
              z_loss=1e-4, vocab_real=None, tp=None):
    """(sum over masked positions of the cross-entropy plus z-loss, their
    count): ``chunked_softmax_xent`` before its division. A rank of a
    sharded batch adds its sums to the other ranks' before dividing."""
    s = hidden.shape[1]
    vp = unembed_vd.shape[0] * (1 if tp is None else tp.size)
    c = min(chunk, s)
    while s % c:
        c -= 1
    w = unembed_vd.to(torch.float32)
    on = grad_on(hidden, w)
    keep = None
    if vocab_real is not None and vocab_real < vp:
        keep = torch.arange(vp, device=hidden.device) < vocab_real
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s, c):
        mc = mask[:, i:i + c].to(torch.float32)
        tot = tot + remat(_chunk_xent, hidden[:, i:i + c], w,
                          labels[:, i:i + c].to(torch.int64), mc, softcap,
                          keep, z_loss, tp, on=on)
        cnt = cnt + torch.sum(mc)
    return tot, cnt


# ---------------------------------------------------------------------------
# GSPMD-style training on a process mesh
# ---------------------------------------------------------------------------

class Spmd:
    """A rank's view of a ``ParallelContext`` for one stack: ``ctx`` (the
    rank's context), ``seq`` the stack's global sequence length, ``sp``
    whether the residual stream is held ``seq / tp`` rows long (Megatron-
    SP: ``resolve_spec(("batch", "sp", None))`` shards it), ``specs`` the
    params' spec tree (``resolve_spec`` of every leaf, a layer leaf's
    with its periods dim). The residual stream is the rank's batch rows
    and, with ``sp``, its rows of the sequence."""

    def __init__(self, ctx, seq, specs=None, batch=None):
        self.ctx = ctx
        self.seq = int(seq)
        self.tp = ctx.tp_size
        self.axis = ctx.tp_axis
        spec = shd.resolve_spec(("batch", "sp", None), (ctx.dp_size, seq, 1),
                                ctx)
        self.sp = len(spec) > 1 and spec[1] is not None
        self.specs = specs
        self.serving = batch is not None
        # serving: the global batch, which the data axes cut only where it
        # divides (else every data rank holds it whole and does the same
        # work); the loss always cuts it
        bspec = (shd.resolve_spec(("batch",), (batch,), ctx)
                 if batch is not None else (tuple(ctx.dp_axes),))
        self.bspec = bspec[0] if bspec and ctx.dp_size > 1 else None

    def gbatch(self, b):
        """The global batch of a stream of ``b`` local rows."""
        return b * self.ctx.size(shd._axes(self.bspec))

    @property
    def rows(self):
        """The slice of the sequence this rank's stream holds."""
        if not self.sp:
            return slice(0, self.seq)
        n = self.seq // self.tp
        r = self.ctx.index(self.axis)
        return slice(r * n, (r + 1) * n)

    # -- the stream's layouts ---------------------------------------------
    def full(self, x, dup):
        """The whole sequence of the stream ``x`` (dim 1): gathered over
        ``model`` when held in rows, for the same work on every rank
        (``dup``) or for the rank's own share (heads, channels)."""
        if self.sp:
            return shd.all_gather(x, self.ctx, self.axis, 1, dup=dup)
        return x if dup else shd.pvary(x, self.ctx, self.axis)

    def from_partial(self, y):
        """The stream from a row-parallel output (whole sequence, a
        partial sum on each rank): reduce-scattered to rows under SP,
        else psum'd."""
        if self.sp:
            return shd.reduce_scatter(y, self.ctx, self.axis, 1)
        return shd.psum(y, self.ctx, self.axis)

    def from_full_dup(self, y):
        """The stream from the whole sequence every rank computed alike:
        the rank's rows under SP."""
        if self.sp:
            return shd.slice_rank(y, self.ctx, self.axis, 1)
        return y

    # -- params -----------------------------------------------------------
    def use(self, t, spec, dup=False, keep=False):
        """A param from its local block ``t`` (spec ``spec``): gathered
        whole over every mesh axis of its spec (the ZeRO-3 all_gather
        over ``data``; over ``model`` for work each rank does alike when
        ``dup``), except, with ``keep``, a dim sharded over ``model`` alone,
        which stays the rank's share (column- or row-parallel). A leaf
        replicated over ``model`` that enters work differing by rank
        passes ``pvary``."""
        if not isinstance(t, torch.Tensor):
            return t                  # a quantized leaf, held whole
        ctx, on_model = self.ctx, False
        for dim, entry in enumerate(spec):
            axes = shd._axes(entry)
            if not axes:
                continue
            if self.axis in axes:
                on_model = True
                if keep and axes == (self.axis,):
                    continue
            t = shd.all_gather(t, ctx, axes, dim,
                               dup=dup and self.axis in axes)
        if not dup and not on_model:
            t = shd.pvary(t, ctx, self.axis)
        return t

    def use_tree(self, tree, specs, dup=False, keep=False):
        if isinstance(tree, dict):
            return {k: self.use_tree(v, specs[k], dup, keep)
                    for k, v in tree.items()}
        return self.use(tree, specs, dup, keep)

    def sharded(self, spec, dim):
        """Whether a leaf's ``dim`` is sharded over ``model`` alone."""
        return (len(spec) > dim and spec[dim] is not None
                and shd._axes(spec[dim]) == (self.axis,))


def _qkv_axes(cfg, parallel):
    """Attention's tensor-parallel policy (the reference's): shard heads
    over ``model`` when ``n_kv_heads`` divides the tp size, else None
    (context parallelism shards the query sequence instead)."""
    if parallel is None:
        return None
    if cfg.n_kv_heads % parallel.tp_size == 0:
        return ("batch", None, "heads", None)
    return None


def use_cp(parallel, qkv_ax, sq, skv, cfg):
    """The reference's rule for context-parallel attention: no head
    sharding, and the query sequence divides into ``tp`` blocks of whole
    64-row (or ``attn_chunk``) chunks, the key sequence into ``tp``
    blocks."""
    return (parallel is not None and qkv_ax is None
            and sq % (parallel.tp_size * min(cfg.attn_chunk, 64)) == 0
            and skv % parallel.tp_size == 0)


def _cp_attention(q, k, v, parallel, *, causal, window, softcap, scale):
    """Context-parallel flash attention on a rank: q, k, v (B, S/tp, H|KV,
    d) are its rows of the sequence; K and V are all-gathered over
    ``model`` (backward: reduce-scatter of dK, dV) and kernel D runs the
    rank's query rows against them at ``q_offset = rank * S/tp``, the
    rows' global positions. Returns the rank's rows (B, S/tp, H, d)."""
    axis = parallel.tp_axis
    kf = shd.all_gather(k, parallel, axis, 1)
    vf = shd.all_gather(v, parallel, axis, 1)
    off = parallel.index(axis) * q.shape[1]
    return flash_attention(q, kf, vf, causal=causal, window=window,
                           softcap=softcap, scale=scale, q_offset=off)


def spmd_attention(p, ps, h, cfg, sm, positions, *, window, causal,
                   cache_spec=None):
    """Self-attention of a block under ``Spmd`` ``sm``: ``p`` the layer's
    local blocks, ``ps`` their specs, ``h`` the normed stream. Heads
    sharded (column-parallel q/k/v, row-parallel ``wo``, a psum or SP's
    reduce-scatter), else context-parallel on the rank's rows, else every
    ``model`` rank computes it whole. Returns the block's output in the
    stream's layout; with ``cache_spec`` (prefill: a K/V cache leaf's spec
    without its periods dim) also the roped {"k", "v"} re-cut from the
    attention's layout into the cache's (``sharding.reshard``: heads over
    ``model`` to a ``kv_seq`` cut is one all_to_all)."""
    ctx = sm.ctx
    bsp = sm.bspec

    def out(y, k, v, src):
        if cache_spec is None:
            return y
        return y, {"k": shd.reshard(k, ctx, src, cache_spec),
                   "v": shd.reshard(v, ctx, src, cache_spec)}
    hd = cfg.head_dim_
    softcap = cfg.attn_softcap
    scale = hd ** -0.5 if cfg.query_scale == 0 else cfg.query_scale
    qkv_ax = _qkv_axes(cfg, ctx)
    rope_on = cfg.use_rope
    if sm.tp > 1 and qkv_ax is not None and all(
            sm.sharded(ps[n], 1) for n in ("wq", "wk", "wv")) and \
            sm.sharded(ps["wo"], 0):
        xf = sm.full(h, dup=False)
        b, s = xf.shape[:2]
        w = {n: sm.use(p[n], ps[n], keep=True) for n in p}
        q = dense(xf, w["wq"], w.get("bq")).reshape(b, s, -1, hd)
        k = dense(xf, w["wk"], w.get("bk")).reshape(b, s, -1, hd)
        v = dense(xf, w["wv"], w.get("bv")).reshape(b, s, -1, hd)
        glob = (sm.gbatch(b), s)
        shd.constraint(q, qkv_ax, ctx, glob + (cfg.n_heads, hd))
        shd.constraint(k, qkv_ax, ctx, glob + (cfg.n_kv_heads, hd))
        shd.constraint(v, qkv_ax, ctx, glob + (cfg.n_kv_heads, hd))
        if rope_on:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        o = flash_attention(q, k, v, causal=causal, window=window,
                            softcap=softcap, scale=scale)
        return out(sm.from_partial(dense(o.reshape(b, s, -1), w["wo"])),
                   k, v, (bsp, None, sm.axis))
    if sm.tp > 1 and sm.sp and use_cp(ctx, qkv_ax, sm.seq, sm.seq, cfg):
        w = {n: sm.use(p[n], ps[n]) for n in p}
        b, s = h.shape[:2]
        q = dense(h, w["wq"], w.get("bq")).reshape(b, s, -1, hd)
        k = dense(h, w["wk"], w.get("bk")).reshape(b, s, -1, hd)
        v = dense(h, w["wv"], w.get("bv")).reshape(b, s, -1, hd)
        if rope_on:
            pos = positions[sm.rows]
            q = rope(q, pos, cfg.rope_theta)
            k = rope(k, pos, cfg.rope_theta)
        o = _cp_attention(q, k, v, ctx, causal=causal, window=window,
                          softcap=softcap, scale=scale)
        return out(dense(o.reshape(b, s, -1), w["wo"]), k, v,
                   (bsp, sm.axis))
    xf = sm.full(h, dup=True)
    w = {n: sm.use(p[n], ps[n], dup=True) for n in p}
    y, kv = attention_layer(w, xf, cfg, positions, window=window,
                            causal=causal)
    return out(sm.from_full_dup(y), kv["k"], kv["v"], (bsp,))


def write_ring_block(ring, new, slot, spec, ctx, dim=1):
    """Write ``new`` (one entry along ``dim``) at global ring ``slot`` (a
    (1,) device tensor) into this rank's block ``ring`` of a ring cut over
    ``spec[dim]``'s axes: only the rank whose block holds the slot
    changes (a masked write, decided on the device, no host sync)."""
    axes = shd._axes(spec[dim]) if len(spec) > dim else ()
    n = ring.shape[dim]
    loc = slot.to(torch.int64) % (n * ctx.size(axes)) - ctx.index(axes) * n
    inside = (loc >= 0) & (loc < n)
    loc = torch.clamp(loc, 0, n - 1)
    old = ring.index_select(dim, loc)
    shape = [1] * ring.dim()
    ring.index_copy_(dim, loc, torch.where(inside.reshape(shape),
                                           new.to(ring.dtype), old))


def spmd_attention_decode(p, ps, h, cfg, sm, cache, cache_spec, cur_pos,
                          positions, *, window, cross=False, slot=None):
    """One decode step of a block's attention under ``Spmd`` ``sm`` (S = 1:
    the stream is whole on every ``model`` rank): ``cache`` the rank's
    block of the K/V ring (or of whisper's static cross-attention K/V with
    ``cross``), placed by ``cache_spec`` (a leaf's spec without its
    periods dim), ``positions`` the rank's block of the position table.
    Every rank projects q, k and v for its batch rows alike (the weights
    gathered); the new entry lands at ring slot ``slot % S`` (``slot`` a
    (1,) tensor, the global row 0's position) on the rank holding it
    (``write_ring_block``); attention runs on the rank's
    block of the sequence and the flash-decode combine
    (``decode_attention``'s ``combine``) joins the blocks over the
    ``kv_seq`` axes; a cache cut by heads attends the rank's heads and
    gathers them. A cache cut over ``head_dim`` holds the rank's slice of
    d: q, k and v are projected and roped whole (RoPE pairs dims across
    d), then sliced; the partial scores over the slice are summed over
    the ``head_dim`` axes in rank order before the softcap, the mask and
    the softmax (``decode_attention``'s ``dsum``), and the rank's slice of
    the output, weighed from its slice of V, is gathered along d.
    Returns (the block's output, the cache)."""
    ctx = sm.ctx
    hd = cfg.head_dim_
    spec = tuple(cache_spec) + (None,) * (4 - len(cache_spec))
    seq_ax, head_ax, dim_ax = (shd._axes(spec[i]) for i in (1, 2, 3))
    w = sm.use_tree(p, ps, dup=True)
    b = h.shape[0]
    softcap = cfg.attn_softcap
    scale = hd ** -0.5 if cfg.query_scale == 0 else cfg.query_scale
    q = dense(h, w["wq"], w.get("bq")).reshape(b, 1, -1, hd)
    nh, nd = ctx.size(head_ax), ctx.size(dim_ax)
    hi = ctx.index(head_ax) if head_ax else 0
    di = ctx.index(dim_ax) if dim_ax else 0

    def mine(t):                # the rank's heads and slice of d of a cache
        n, m = t.shape[2] // nh, t.shape[3] // nd
        return t[:, :, hi * n:(hi + 1) * n, di * m:(di + 1) * m].contiguous()

    combine = (ctx, seq_ax) if seq_ax else None
    dsum = (ctx, dim_ax) if dim_ax else None
    if cross:
        s_l = cache["k"].shape[1]
        off = (ctx.index(seq_ax) if seq_ax else 0) * s_l
        s = s_l * ctx.size(seq_ax)
        tab = torch.arange(off, off + s_l, dtype=torch.int32,
                           device=h.device)[None].expand(b, s_l)
        o = decode_attention(mine(q), cache["k"], cache["v"], tab,
                             torch.full((b,), s - 1, dtype=torch.int32,
                                        device=h.device),
                             softcap=softcap, scale=scale, combine=combine,
                             dsum=dsum)
    else:
        k = dense(h, w["wk"], w.get("bk")).reshape(b, 1, -1, hd)
        v = dense(h, w["wv"], w.get("bv")).reshape(b, 1, -1, hd)
        if cfg.use_rope:
            q = rope(q, cur_pos[:, None], cfg.rope_theta)
            k = rope(k, cur_pos[:, None], cfg.rope_theta)
        write_ring_block(cache["k"], mine(k), slot, spec, ctx)
        write_ring_block(cache["v"], mine(v), slot, spec, ctx)
        o = decode_attention(mine(q), cache["k"], cache["v"], positions,
                             cur_pos, window=window, softcap=softcap,
                             scale=scale, combine=combine, dsum=dsum)
    if dim_ax:
        o = shd.raw_all_gather(ctx, o, dim_ax, 3)
    if head_ax:
        o = shd.raw_all_gather(ctx, o, head_ax, 2)
    return dense(o.reshape(b, 1, -1), w["wo"]), cache


def spmd_mlp(p, ps, h, sm):
    """The SwiGLU MLP under ``Spmd``: column-parallel ``wg``/``wi`` and
    row-parallel ``wo`` over the hidden channels when ``model`` shards
    them (the reference's ``mlp`` activations), else row-wise on the
    stream (the rank's rows under SP, the whole sequence alike on every
    rank otherwise)."""
    if sm.tp > 1 and sm.sharded(ps["wg"], 1) and sm.sharded(ps["wi"], 1) \
            and sm.sharded(ps["wo"], 0):
        w = sm.use_tree(p, ps, keep=True)
        return sm.from_partial(mlp_layer(w, sm.full(h, dup=False)))
    return mlp_layer(sm.use_tree(p, ps, dup=not sm.sp), h)
