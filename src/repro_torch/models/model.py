"""Top-level Model API: the loss (and its gradients), static prefill and
ring decode, and paged serving.

Port of ``repro.models.model`` for all ten architectures: embedding and
logits; the frontends (internvl's patch embeddings before the tokens,
whisper's audio frames through its encoder); sinusoidal positions where
there is no RoPE (jamba; whisper's two stacks); ``loss`` (with the
router's load-balancing loss; differentiable for training), ``prefill``
and ``decode_step``
over a cache (``cache_defs``/``init_cache``: attention rings, mamba and
xLSTM state, whisper's static cross-attention K/V) for the static
engine; paged K/V pools (kv16, or MSB-quantized at kv_bits 8|4), one
paged step (decode or chunked prefill), packed ragged prefill, and the
decode horizon with on-device greedy sampling for the continuous engine,
for the stacks the reference serves paged (``supports_paged``; a stack
without RoPE gets the reference's sinusoidal positions there, computed
on the device from ``q_pos`` so a captured graph holds them).

``parallel`` (a ``parallel.TPShard``) runs a method on one rank's shard
of a tensor-parallel mesh (DESIGN.md Sec. 10): ``params`` is the rank's
tree (``core.policy.tp_shard``, ``tp_localize``), the paged pools and
static caches hold the rank's KV heads where heads shard, and the logits
come out whole on every rank (the vocab shards gathered).

``loss`` also takes a ``parallel.ParallelContext``: on a rank of a
process mesh (``launch.mesh.make_host_mesh``) ``params`` and ``batch``
are the rank's blocks and the stacks run their GSPMD path
(``transformer._block_spmd``); on the controller ``params`` is a
``sharding.Sharded`` tree and the loss runs on every rank. The loss is
the global mean: each rank's NLL sum and token count are summed over the
mesh. ``prefill`` and ``decode_step`` take one too (GSPMD serving): on a
rank they work on its blocks, the stack runs ``transformer.
_block_spmd`` with the cache and the cache is the rank's blocks under
``cache_specs`` (the reference's cache axes: K/V rings and whisper's
cross-attention K/V cut by ``kv_seq``, mamba's state by channels over
``model``); from the controller they run on every rank, return rank 0's
logits (the whole batch) and keep the cache on the ranks, a
``sharding.Sharded`` handle. The paged steps under a ``ParallelContext``
run the tensor-parallel path over the ``model`` axis
(``ParallelContext.model_shard``): params are the planner's slices
(``place_paged``), pools a rank's KV heads, and every data rank runs the
whole step.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..configs.base import ModelConfig
from ..core.quantize import KVQuantSpec, PackedQTensor, QTensor, \
    map_tensors, packed_gather
from ..device import resolve_device
from ..kernels.msb_matmul.ops import msb_unembed
from . import ssm, xlstm
from ..parallel import sharding as shd
from ..parallel.sharding import ParallelContext
from .layers import (Spmd, chunked_softmax_xent, heads_split, rms_norm,
                     tp_of, write_ring_block, xent_sums)
from .transformer import (_require_attention_stack, forward_stack,
                          init_params, layer_plan, n_periods, param_axes,
                          param_shapes, supports_paged)


def _sinusoid(positions, d):
    """Sinusoidal position features (..., d) f32 of ``positions``, the
    reference's (frequency step ``max(half - 1, 1)``)."""
    half = d // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32,
                                    device=positions.device)
                     / max(half - 1, 1))
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _has_attn(cfg):
    return any(m in ("attn", "enc_attn") for m, _ in layer_plan(cfg, "dec"))


def _quant_paged(paged, kv_bits, slots, seg_off=None):
    """Add the quantized pools' inputs to a step's ``paged`` dict."""
    kv_bits = int(kv_bits)
    if kv_bits == 16:
        return paged
    if slots is None:
        raise ValueError("kv_bits < 16 needs the slots array")
    paged = dict(paged, kv_bits=kv_bits, slots=slots.to(torch.int32))
    if seg_off is not None:
        paged["seg_off"] = seg_off.to(torch.int64)
    return paged


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """The global sizes a static cache is cut from on a process mesh:
    ``batch`` rows, ``seq`` ring entries and whisper's ``enc_seq``
    cross-attention rows (None without an encoder)."""
    batch: int
    seq: int
    enc_seq: Optional[int] = None


def _quantized(t):
    return isinstance(t, (QTensor, PackedQTensor))


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -- params ------------------------------------------------------------
    def init(self, generator, device=None):
        """Random params on ``device`` (``None`` = the card)."""
        return init_params(self.cfg, generator, device)

    def param_axes(self):
        """Logical axes of every param leaf (the resolver's input)."""
        return param_axes(self.cfg)

    def param_shapes(self):
        """Global shape (a tuple) of every param leaf."""
        return param_shapes(self.cfg)

    def param_specs(self, ctx, params=None):
        """``resolve_spec`` of every param leaf on ``ctx``'s mesh; with
        ``params``, a quantized leaf's is () (such leaves are placed
        whole: ``sharding.device_put``)."""
        specs = shd.tree_map_axes(
            lambda ax, shape: shd.resolve_spec(ax, shape, ctx),
            self.param_axes(), self.param_shapes())
        if params is None:
            return specs
        return shd.tree_map_axes(lambda sp, t: () if _quantized(t) else sp,
                                 specs, params)

    def param_shardings(self, ctx, params=None):
        """``NamedSharding`` of every param leaf (``param_specs``) for
        ``sharding.device_put``."""
        specs = self.param_specs(ctx, params)
        return shd.tree_map_axes(
            lambda sp, shape: shd.NamedSharding(ctx.mesh, sp, shape),
            specs, self.param_shapes())

    # -- shared pieces -----------------------------------------------------
    def _embed(self, params, tokens):
        cfg = self.cfg
        table = params["embed"]
        tokens = tokens.to(torch.int64)
        if isinstance(table, PackedQTensor):
            # only the gathered rows are unpacked and dequantized
            e = packed_gather(table, tokens).to(cfg.dtype)
        else:
            if isinstance(table, QTensor):
                table = table.dequantize()
            e = table[tokens].to(cfg.dtype)
        # the scale rounded to cfg.dtype, as the reference's
        # ``jnp.asarray(scale, dtype)``; a fill on the device, not a copy
        # from the host, so a CUDA graph can capture it
        return e * torch.full((), cfg.embed_scale, dtype=cfg.dtype,
                              device=e.device)

    def _unembed_vd(self, params):
        table = params.get("unembed", params["embed"])
        if isinstance(table, PackedQTensor):
            w = table.dequantize()
            return w.t() if table.kblocked else w
        if isinstance(table, QTensor):
            table = table.dequantize()
        return table

    def _logits(self, params, hidden, parallel=None):
        """Unembedding projection in f32 + softcap + vocab mask. A packed
        table of either layout runs the unembedding kernel
        (``msb_unembed``, hidden in f32): the untied k-blocked ``unembed``,
        and a tied table (packed in natural orientation for the embedding
        gather: gemma2, qwen, granite, granite-moe) read in place as its
        transpose, where the reference dequantizes it whole and multiplies
        outside any kernel. Unpacked and dense tables are multiplied in
        f32. Under a ``TPShard`` a vocab-sharded table (shard "n" or "v")
        gives this rank's columns, a full-K product, so every logit is
        made whole on one rank; the slices are gathered to the whole
        (B, V) the samplers read, as wide as on one device."""
        cfg = self.cfg
        table = params.get("unembed", params["embed"])
        hidden = hidden.to(torch.float32)
        if isinstance(table, PackedQTensor):
            logits = msb_unembed(hidden, table)
        else:
            logits = hidden @ self._unembed_vd(params).to(torch.float32).t()
        tp = tp_of(parallel)
        if tp is not None and getattr(table, "shard", None) in ("n", "v"):
            # the slices, less the planner's padding: one device's width
            logits = tp.all_gather(logits, dim=-1)[..., :cfg.vocab_padded]
        if cfg.logit_softcap > 0:
            logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
        vp = logits.shape[-1]
        if cfg.vocab_size < vp:
            keep = torch.arange(vp, device=logits.device) < cfg.vocab_size
            logits = torch.where(keep, logits,
                                 torch.full_like(logits, -float("inf")))
        return logits

    def _assemble_inputs(self, params, batch):
        """The decoder's input (B, S, D): internvl's ``patch_embeds``
        before its tokens' embeddings; an audio model that is not enc-dec
        reads ``frames``; otherwise the tokens' embeddings."""
        cfg = self.cfg
        if cfg.frontend == "vision":
            patches = batch["patch_embeds"].to(cfg.dtype)
            return torch.cat([patches, self._embed(params, batch["tokens"])],
                             dim=1)
        if cfg.frontend == "audio" and not cfg.is_encdec:
            return batch["frames"].to(cfg.dtype)
        return self._embed(params, batch["tokens"])

    def _encoder(self, params, batch, parallel=None):
        """Whisper's encoder over ``batch["frames"]`` (B, S_enc, D) with
        sinusoidal positions; returns its normed output (B, S_enc, D)."""
        cfg = self.cfg
        frames = batch["frames"].to(cfg.dtype)
        pos = torch.arange(frames.shape[1], device=frames.device)
        x = frames + _sinusoid(pos, cfg.d_model)[None].to(cfg.dtype)
        x, _, _ = forward_stack(params["enc"], x, cfg, stack="enc",
                                positions=pos, parallel=parallel)
        return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)

    # -- loss forward --------------------------------------------------------
    def loss(self, params, batch, parallel=None):
        """Mean next-token cross-entropy (plus the z-loss) of ``batch``
        {"tokens" (B, S), "labels" (B, S'); labels < 0 are masked; internvl
        adds "patch_embeds" (B, P, D) before the tokens (S' = P + S),
        whisper "frames" (B, S_enc, D) for its encoder}, plus
        ``router_aux_weight`` times the router's load-balancing loss summed
        over MoE layers. Returns (loss, {"ce", "router_aux"});
        ``router_aux`` is 0 without MoE. Differentiable: with params that
        require grad, ``loss.backward()`` gives every leaf its gradient
        (kernel D under its autograd Function, the stack and each CE chunk
        rematerialized; a tied table gets the sum of its embedding and
        unembedding uses), as ``jax.grad`` of the reference's ``loss``.
        Under a ``TPShard`` (inference only) each cross-entropy chunk's
        logits are gathered over a vocab-sharded table's slices."""
        cfg = self.cfg
        if isinstance(parallel, ParallelContext):
            if not parallel.on_rank:
                return _mesh_loss(self, params, batch, parallel)
            return self._loss_spmd(params, batch, parallel)
        tp = tp_of(parallel)
        enc_out = (self._encoder(params, batch, parallel) if cfg.is_encdec
                   else None)
        x = self._assemble_inputs(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        if not cfg.use_rope and not cfg.is_encdec and _has_attn(cfg):
            x = x + _sinusoid(positions, cfg.d_model)[None].to(cfg.dtype)
        if cfg.is_encdec:
            x = x + _sinusoid(positions, cfg.d_model)[None].to(cfg.dtype)
        x, _, aux = forward_stack(params["dec"], x, cfg, positions=positions,
                                  enc_out=enc_out, parallel=parallel)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        labels = batch["labels"].to(torch.int64)
        table = params.get("unembed", params["embed"])
        vocab_tp = tp if getattr(table, "shard", None) in ("n", "v") else None
        ce = chunked_softmax_xent(x, self._unembed_vd(params),
                                  torch.clamp(labels, min=0),
                                  (labels >= 0).to(torch.float32),
                                  softcap=cfg.logit_softcap,
                                  vocab_real=cfg.vocab_size, tp=vocab_tp)
        return ce + cfg.router_aux_weight * aux, {"ce": ce,
                                                  "router_aux": aux}

    def _loss_spmd(self, params, batch, ctx):
        """``loss`` on a rank of a process mesh: ``params`` the rank's
        blocks, ``batch`` its batch rows. The embedding (and internvl's,
        whisper's inputs) is computed whole and alike on every ``model``
        rank, then cut to the rank's rows of the sequence where SP holds
        the stream in rows; each rank's NLL sum and count are summed over
        the mesh. The returned loss carries the global value on every
        rank and, backward, the gradient of this rank's share of it (a
        value replicated over the data axes, as the router loss, counts
        ``1 / dp`` a rank), so ``loss.backward()`` on every rank gives
        the global gradient once the shares are reduced (``train.
        make_train_step``)."""
        cfg = self.cfg
        specs = self.param_specs(ctx, params)
        enc_out = (self._encoder_spmd(params, batch, ctx, specs)
                   if cfg.is_encdec else None)
        whole = {"embed": Spmd(ctx, 1).use(params["embed"], specs["embed"],
                                           dup=True)}
        x = self._assemble_inputs(whole, batch)
        positions = torch.arange(x.shape[1], device=x.device)
        if (not cfg.use_rope and not cfg.is_encdec and _has_attn(cfg)) \
                or cfg.is_encdec:
            x = x + _sinusoid(positions, cfg.d_model)[None].to(cfg.dtype)
        sm = Spmd(ctx, x.shape[1], specs)
        x = sm.from_full_dup(x)
        x, _, aux = forward_stack(params["dec"], x, cfg, positions=positions,
                                  enc_out=enc_out, parallel=sm)
        dup = not sm.sp
        x = rms_norm(x, sm.use(params["final_norm"], specs["final_norm"],
                               dup=dup), cfg.norm_eps)
        name = "unembed" if "unembed" in params else "embed"
        w = sm.use(params[name], specs[name], dup=dup)
        if _quantized(w):
            w = self._unembed_vd({"embed": w})
        labels = batch["labels"].to(torch.int64)[:, sm.rows]
        tot, cnt = xent_sums(x, w, torch.clamp(labels, min=0),
                             (labels >= 0).to(torch.float32),
                             softcap=cfg.logit_softcap,
                             vocab_real=cfg.vocab_size)
        if sm.sp:
            tot = shd.psum(tot, ctx, ctx.tp_axis)
            cnt = shd.raw_psum(ctx, cnt, ctx.tp_axis)
        cnt = shd.raw_psum(ctx, cnt, ctx.dp_axes)
        ce_share = tot / torch.clamp(cnt, min=1.0)
        aux = aux.to(torch.float32)
        share = ce_share + cfg.router_aux_weight * aux / ctx.dp_size
        loss = _GlobalValue.apply(share, ctx)
        ce = shd.raw_psum(ctx, ce_share.detach(), ctx.dp_axes)
        return loss, {"ce": ce, "router_aux": aux.detach()}

    # -- static serving: prefill + ring-buffer decode ------------------------
    def prefill(self, params, batch, parallel=None, *, global_batch=None):
        """Forward over ``batch`` ({"tokens" (B, S)}, with "patch_embeds"
        or "frames" as ``loss`` takes them) collecting the cache. Returns
        (last-position logits (B, V) f32, cache): cache["layers"] holds
        each slot's cache stacked over periods (``forward_stack``) and,
        where the stack has attention, cache["pos"] (B, S) int32 the
        positions 0..S-1.

        Under a ``ParallelContext``: from the controller ``params`` is a
        ``Sharded`` tree (``param_shardings``), ``batch`` global; every
        rank runs the prefill and the result is (the whole batch's
        logits, a ``Sharded`` cache handle). On a rank ``params`` and
        ``batch`` are its blocks, ``global_batch`` the global rows (None:
        ``batch`` is the rank's cut over the data axes), and the logits
        and cache are its rows' and blocks (``cache_specs`` of
        ``cache_layout``)."""
        if isinstance(parallel, ParallelContext):
            if not parallel.on_rank:
                return _mesh_prefill(self, params, batch, parallel)
            return self._prefill_spmd(params, batch, parallel, global_batch)
        cfg = self.cfg
        enc_out = (self._encoder(params, batch, parallel) if cfg.is_encdec
                   else None)
        x = self._assemble_inputs(params, batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, device=x.device)
        if (not cfg.use_rope or cfg.is_encdec) and _has_attn(cfg):
            x = x + _sinusoid(positions, cfg.d_model)[None].to(cfg.dtype)
        x, layer_cache, _ = forward_stack(params["dec"], x, cfg,
                                          positions=positions,
                                          enc_out=enc_out,
                                          collect_cache=True,
                                          parallel=parallel)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = self._logits(params, x[:, -1], parallel)
        cache = {"layers": layer_cache}
        if _has_attn(cfg):
            cache["pos"] = positions.to(torch.int32)[None].expand(
                b, s).contiguous()
        return logits, cache

    def decode_step(self, params, cache, tokens, cur_pos, parallel=None, *,
                    layout=None):
        """One decode step. tokens (B, 1), cur_pos (B,) on the cache's
        device. Every row writes ring slot ``cur_pos[0] % S`` (as the
        reference does), and ``cache`` — K/V rings, recurrent state and
        the ``pos`` table — is updated in place, with no host sync.
        Returns (logits (B, V), cache).

        Under a ``ParallelContext``: from the controller ``cache`` is the
        ``Sharded`` handle ``prefill`` gave and ``tokens``
        / ``cur_pos`` global; on a rank everything is the rank's blocks
        and ``layout`` (a ``CacheLayout``) the cache's global sizes. The
        new entry lands on the rank whose block of the ring holds slot
        ``cur_pos[0] % S`` of the global row 0, and attention joins the
        ranks' blocks of the sequence by the flash-decode combine."""
        if isinstance(parallel, ParallelContext):
            if not parallel.on_rank:
                return _mesh_decode(self, params, cache, tokens, cur_pos,
                                    parallel)
            if layout is None:
                raise ValueError("decode_step on a rank needs the cache's "
                                 "layout (a CacheLayout)")
            return self._decode_spmd(params, cache, tokens, cur_pos,
                                     parallel, layout)
        cfg = self.cfg
        x = self._embed(params, tokens)
        if (not cfg.use_rope or cfg.is_encdec) and _has_attn(cfg):
            x = x + _sinusoid(cur_pos[:, None], cfg.d_model).to(cfg.dtype)
        pos = None
        if _has_attn(cfg):
            pos = cache["pos"]
            slot = (cur_pos[:1] % pos.shape[1]).to(torch.int64)
            pos.index_copy_(1, slot, cur_pos[:, None].to(pos.dtype))
        x, _, _ = forward_stack(params["dec"], x, cfg,
                                positions=cur_pos[:, None],
                                cache=cache["layers"], cur_pos=cur_pos,
                                decode_positions=pos, parallel=parallel)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return self._logits(params, x[:, -1], parallel), cache

    # -- static serving on a process mesh ------------------------------------
    def cache_layout(self, batch, global_batch=None):
        """The ``CacheLayout`` of a prefill over ``batch`` (its rows, or
        ``global_batch``)."""
        cfg = self.cfg
        s = batch["frames" if cfg.frontend == "audio" and not cfg.is_encdec
                  else "tokens"].shape[1]
        if cfg.frontend == "vision":
            s += batch["patch_embeds"].shape[1]
        enc = batch["frames"].shape[1] if cfg.is_encdec else None
        first = next(iter(batch.values()))
        return CacheLayout(int(global_batch or first.shape[0]), int(s), enc)

    def cache_axes(self):
        """The logical axes of every cache leaf (the reference's third
        ``cache_defs`` entry): K/V ("layers", "batch", "kv_seq", "heads",
        "head_dim"), mamba's conv / ssm state channels on "mlp", xLSTM
        state replicated past "batch", pos ("batch", "kv_seq")."""
        kv = ("layers", "batch", "kv_seq", "heads", "head_dim")

        def axes(path, shape):
            if path[-1] in ("k", "v"):
                return kv
            if path[-1] == "pos":
                return ("batch", "kv_seq")
            if path[-2] == "mamba":
                return {"conv": ("layers", "batch", None, "mlp"),
                        "ssm": ("layers", "batch", "mlp", None)}[path[-1]]
            return ("layers", "batch") + (None,) * (len(shape) - 2)
        return _map_defs(axes, self.cache_defs(1, 1))

    def cache_shapes(self, layout):
        """The global shape of every cache leaf of ``layout`` (whisper's
        cross-attention K/V ``enc_seq`` rows long)."""
        def shape(path, shp):
            if "xattn" in path:
                shp = shp[:2] + (layout.enc_seq,) + shp[3:]
            return shp
        return _map_defs(shape, self.cache_defs(layout.batch, layout.seq))

    def cache_specs(self, ctx, layout):
        """``resolve_spec`` of every cache leaf of ``layout``: the blocks a
        rank holds."""
        return shd.tree_map_axes(
            lambda ax, shp: shd.resolve_spec(ax, shp, ctx),
            self.cache_axes(), self.cache_shapes(layout))

    def cache_shardings(self, ctx, layout):
        return shd.tree_shardings(ctx, self.cache_axes(),
                                  self.cache_shapes(layout))

    def _whole(self, params, specs, sm, names):
        """The named top-level leaves gathered whole on every rank."""
        return {n: sm.use(params[n], specs[n], dup=True) for n in names
                if n in params}

    def _encoder_spmd(self, params, batch, ctx, specs, gbatch=None):
        """Whisper's encoder on a rank (its batch rows); returns its normed
        output, the whole sequence, alike on every ``model`` rank."""
        cfg = self.cfg
        frames = batch["frames"].to(cfg.dtype)
        sme = Spmd(ctx, frames.shape[1], specs, batch=gbatch)
        pos = torch.arange(frames.shape[1], device=frames.device)
        xe = sme.from_full_dup(
            frames + _sinusoid(pos, cfg.d_model)[None].to(cfg.dtype))
        xe, _, _ = forward_stack(params["enc"], xe, cfg, stack="enc",
                                 positions=pos, parallel=sme)
        xe = rms_norm(xe, sme.use(params["enc_final_norm"],
                                  specs["enc_final_norm"],
                                  dup=not sme.sp), cfg.norm_eps)
        return sme.full(xe, dup=True)

    def _prefill_spmd(self, params, batch, ctx, global_batch):
        cfg = self.cfg
        specs = self.param_specs(ctx, params)
        first = next(iter(batch.values()))
        gb = global_batch or first.shape[0] * ctx.dp_size
        layout = self.cache_layout(batch, gb)
        enc_out = (self._encoder_spmd(params, batch, ctx, specs, gb)
                   if cfg.is_encdec else None)
        sm = Spmd(ctx, layout.seq, specs, batch=gb)
        whole = self._whole(params, specs, sm, ("embed", "unembed"))
        x = self._assemble_inputs(whole, batch)
        s = x.shape[1]
        positions = torch.arange(s, device=x.device)
        if (not cfg.use_rope or cfg.is_encdec) and _has_attn(cfg):
            x = x + _sinusoid(positions, cfg.d_model)[None].to(cfg.dtype)
        cspecs = self.cache_specs(ctx, layout)
        x, layer_cache, _ = forward_stack(
            params["dec"], sm.from_full_dup(x), cfg, positions=positions,
            enc_out=enc_out, collect_cache=True, parallel=sm,
            cache_specs=cspecs["layers"])
        x = rms_norm(sm.full(x, dup=True)[:, -1],
                     sm.use(params["final_norm"], specs["final_norm"],
                            dup=True), cfg.norm_eps)
        cache = {"layers": layer_cache}
        if _has_attn(cfg):
            pos = positions.to(torch.int32)[None].expand(gb, s)
            cache["pos"] = shd.local_block(pos, cspecs["pos"],
                                           ctx).contiguous()
        return self._logits(whole, x), cache

    def _decode_spmd(self, params, cache, tokens, cur_pos, ctx, layout):
        cfg = self.cfg
        specs = self.param_specs(ctx, params)
        cspecs = self.cache_specs(ctx, layout)
        sm = Spmd(ctx, 1, specs, batch=layout.batch)
        whole = self._whole(params, specs, sm, ("embed", "unembed"))
        x = self._embed(whole, tokens)
        if (not cfg.use_rope or cfg.is_encdec) and _has_attn(cfg):
            x = x + _sinusoid(cur_pos[:, None], cfg.d_model).to(cfg.dtype)
        pos = slot = None
        if _has_attn(cfg):
            pos = cache["pos"]
            bax = shd._axes(sm.bspec)
            # the position of the global row 0, which the first data rank
            # holds: every row writes its ring slot
            slot = (shd.raw_all_gather(ctx, cur_pos[:1], bax, 0)[:1]
                    if bax else cur_pos[:1])
            write_ring_block(pos, cur_pos[:, None], slot, cspecs["pos"],
                             ctx)
        x, _, _ = forward_stack(params["dec"], x, cfg,
                                positions=cur_pos[:, None],
                                cache=cache["layers"], cur_pos=cur_pos,
                                decode_positions=pos, parallel=sm,
                                cache_specs=cspecs["layers"],
                                ring_slot=slot)
        x = rms_norm(x, sm.use(params["final_norm"], specs["final_norm"],
                               dup=True), cfg.norm_eps)
        return self._logits(whole, x[:, -1]), cache

    def cache_defs(self, batch, seq_len):
        """(shape, dtype) per leaf of the decode cache, nested like it:
        per slot, attn {"k", "v"} (n_periods, B, S, KV, d), mamba {"conv",
        "ssm"}, sLSTM / mLSTM state, and whisper's xattn {"k", "v"} (S
        rows here; ``prefill`` gives S_enc); "pos" (B, S) int32 where the
        stack has attention."""
        cfg = self.cfg
        p = n_periods(cfg)
        kvshape = (p, batch, seq_len, cfg.n_kv_heads, cfg.head_dim_)
        layers = {}
        for slot, (mixer, _ffn) in enumerate(layer_plan(cfg, "dec")):
            sl = {}
            if mixer == "attn":
                sl["attn"] = {"k": (kvshape, cfg.dtype),
                              "v": (kvshape, cfg.dtype)}
            elif mixer == "mamba":
                sl["mamba"] = {k: ((p,) + shp, dt) for k, (shp, dt) in
                               ssm.mamba_cache_shapes(cfg, batch).items()}
            else:
                sl[mixer] = {k: ((p,) + shp, dt) for k, (shp, dt) in
                             xlstm.xlstm_cache_shapes(cfg, batch,
                                                      mixer).items()}
            if cfg.is_encdec:
                sl["xattn"] = {"k": (kvshape, cfg.dtype),
                               "v": (kvshape, cfg.dtype)}
            layers[f"s{slot}"] = sl
        defs = {"layers": layers}
        if _has_attn(cfg):
            defs["pos"] = ((batch, seq_len), torch.int32)
        return defs

    def init_cache(self, batch, seq_len, device=None):
        """An empty cache on ``device`` (``None`` = the card): every
        float leaf zero (K/V and recurrent state alike), and ``pos`` the
        positions 0..S-1 of every row, as the reference initialises it."""
        dev = resolve_device(device)

        def build(d):
            if isinstance(d, dict):
                return {k: build(v) for k, v in d.items()}
            shape, dt = d
            if dt == torch.int32:
                return torch.arange(shape[-1], dtype=dt, device=dev)[
                    None].expand(shape).contiguous()
            return torch.zeros(shape, dtype=dt, device=dev)
        return build(self.cache_defs(batch, seq_len))

    # -- dry-run input specs -------------------------------------------------
    def input_specs(self, shape):
        """Shape stand-ins (``torch.empty(..., device="meta")``) and
        logical axes of every entry point's arguments at ``shape`` (a
        ``configs.ShapeConfig``), leaf for leaf the reference's: for
        train and prefill the batch ("tokens", with "labels" to train,
        internvl's "patch_embeds" before S - P tokens, whisper's
        "frames"), for decode {"cache", "tokens" (B, 1), "cur_pos" (B,)}
        with the cache of ``cache_defs(B, S)`` (whisper's cross-attention
        K/V S rows long, as the reference's). Returns (specs, axes)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32, dt = torch.int32, cfg.dtype

        def meta(shp, dtype):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.kind in ("train", "prefill"):
            batch, axes = {}, {}
            n_tok = s
            if cfg.frontend == "vision":
                p = cfg.n_frontend_tokens
                n_tok = s - p
                batch["patch_embeds"] = meta((b, p, cfg.d_model), dt)
                axes["patch_embeds"] = ("batch", None, None)
            elif cfg.is_encdec:
                batch["frames"] = meta((b, s, cfg.d_model), dt)
                axes["frames"] = ("batch", None, None)
            batch["tokens"] = meta((b, n_tok), i32)
            axes["tokens"] = ("batch", None)
            if shape.kind == "train":
                batch["labels"] = meta((b, s), i32)
                axes["labels"] = ("batch", None)
            return batch, axes

        def build(d):
            if isinstance(d, dict):
                return {k: build(v) for k, v in d.items()}
            return meta(*d)
        return ({"cache": build(self.cache_defs(b, s)),
                 "tokens": meta((b, 1), i32),
                 "cur_pos": meta((b,), i32)},
                {"cache": self.cache_axes(), "tokens": ("batch", None),
                 "cur_pos": ("batch",)})

    # -- paged serving -------------------------------------------------------
    def place_paged(self, params, ctx):
        """The paged steps' params on ``ctx``'s process mesh, placed as
        ``ContinuousEngine(parallel=)`` places them: ``shard_params`` over
        the ``model`` axis (packed and ``QTensor`` trees keep their codes,
        so kernel A runs on each rank's slice), replicated over the data
        axes, each rank's slices installed by ``install_slices``. Returns
        (a ``Sharded`` handle, the planner's report)."""
        mesh = ctx.mesh
        shards, report = shard_params(self, params, mesh, mesh.device, ctx)
        key = mesh.new_key()
        mesh.install(key, install_slices, [(shard,) for shard in shards])
        return shd.Sharded(mesh, key, None), report

    def supports_paged(self):
        """Paged serving covers decoder-only attention stacks (any FFN
        kind); ssm/xlstm/enc-dec caches are per-sequence state, not pages.
        The reference's rule."""
        return supports_paged(self.cfg)

    def init_paged_pools(self, num_pages, page_size, kv_bits=16,
                         max_seqs=None, device=None, parallel=None):
        """Global K/V page pools on ``device`` (``None`` = the card),
        nested like the reference's. Page 0 is the allocator's scratch
        page. The serving steps update them in place.

        ``kv_bits=16``: leaves (n_periods, num_pages, page_size, KV,
        head_dim) in ``cfg.dtype``. ``kv_bits=8|4``: the dual-pool layout
        of DESIGN.md Sec. 15 — ``k_codes/v_codes`` and ``k_scales/
        v_scales`` per page (``KVQuantSpec``) for committed pages, and
        ``k_hot/v_hot`` (n_periods, max_seqs + 1, page_size, KV, head_dim)
        in ``cfg.dtype``, one partial-page row per engine slot (row slot +
        1) plus scratch row 0. Under a ``TPShard`` whose size divides both
        head counts (``layers.heads_split``) a rank's pools hold its
        ``KV / size`` heads: the KV codec's groups never cross heads, so
        every representation splits along them. Under a ``ParallelContext``
        a rank's pools are those of its ``model_shard``; from the
        controller every rank allocates its own and a ``Sharded`` handle
        comes back."""
        cfg = self.cfg
        _require_attention_stack(cfg)
        if isinstance(parallel, ParallelContext):
            if not parallel.on_rank:
                return _mesh_pools(self, parallel, num_pages=num_pages,
                                   page_size=page_size, kv_bits=kv_bits,
                                   max_seqs=max_seqs)
            parallel = parallel.model_shard()
        dev = resolve_device(device)
        p, kv, hd = n_periods(cfg), cfg.n_kv_heads, cfg.head_dim_
        tp = tp_of(parallel)
        if heads_split(cfg, tp):
            kv //= tp.size
        if int(kv_bits) == 16:
            shape = (p, num_pages, page_size, kv, hd)
            leaves = {"k": (shape, cfg.dtype), "v": (shape, cfg.dtype)}
        else:
            if max_seqs is None:
                raise ValueError("quantized pools need max_seqs (hot rows)")
            spec = KVQuantSpec(int(kv_bits), page_size, kv, hd)
            hot = (p, int(max_seqs) + 1, page_size, kv, hd)
            leaves = {}
            for x in ("k", "v"):
                leaves[f"{x}_codes"] = ((p, num_pages) + spec.codes_tail,
                                        spec.code_dtype)
                leaves[f"{x}_scales"] = ((p, num_pages) + spec.scales_tail,
                                         spec.scale_dtype)
                leaves[f"{x}_hot"] = (hot, cfg.dtype)
        layers = {f"s{slot}": {"attn": {
            name: torch.zeros(shape, dtype=dt, device=dev)
            for name, (shape, dt) in leaves.items()}}
            for slot, _ in enumerate(layer_plan(cfg, "dec"))}
        return {"layers": layers}

    def paged_step(self, params, pools, tokens, q_pos, kv_lens, block_tables,
                   kv_bits=16, slots=None, parallel=None):
        """One serving step over a batch with a paged KV cache.

        tokens (B, T) int (T=1 decode, T=chunk chunked prefill); q_pos
        (B, T) absolute positions, -1 for padding; kv_lens (B,) cache length
        including this chunk; block_tables (B, max_pages) int32. Writes the
        new K/V into ``pools`` in place and returns (logits at each row's
        last valid token (B, V) f32, pools). Pad rows give garbage logits
        the caller discards. ``kv_bits`` names the pools' representation
        (``init_paged_pools``); ``slots`` (B,) engine slot ids (-1 = pad
        row) address the hot rows and are required when kv_bits < 16.
        Under a ``ParallelContext`` (``_paged_parallel``) the step runs
        on every rank from the controller (``params`` from
        ``place_paged``, ``pools`` from ``init_paged_pools``: handles)
        and on a rank over its ``model_shard``."""
        parallel, mesh_call = _paged_parallel(parallel)
        if mesh_call:
            return _mesh_paged(self, "paged_step", params, pools,
                               (tokens, q_pos, kv_lens, block_tables),
                               dict(kv_bits=kv_bits, slots=slots))
        cfg = self.cfg
        x = self._embed(params, torch.clamp(tokens, min=0))
        if not cfg.use_rope:
            x = x + _sinusoid(torch.clamp(q_pos, min=0),
                              cfg.d_model).to(cfg.dtype)
        paged = _quant_paged({"block_tables": block_tables, "q_pos": q_pos,
                              "kv_lens": kv_lens}, kv_bits, slots)
        x, layer_pools, _ = forward_stack(params["dec"], x, cfg,
                                          cache=pools["layers"], paged=paged,
                                          parallel=parallel)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        last = torch.clamp((q_pos >= 0).sum(dim=1) - 1, min=0)
        hidden = x[torch.arange(x.shape[0], device=x.device), last]
        return self._logits(params, hidden, parallel), {"layers": layer_pools}

    def paged_prefill_packed(self, params, pools, tokens, seg_ids, q_pos,
                             kv_lens, block_tables, slots, last_idx, seg_off,
                             kv_bits=16, parallel=None):
        """Packed ragged prefill: several sequences' chunks in one step.

        tokens/seg_ids/q_pos (T,): the concatenated segments, padded to the
        bucket length (seg_ids = q_pos = -1 on pads). Per-segment (S,):
        kv_lens (0 = pad segment), block_tables (S, max_pages), last_idx
        (packed index of the segment's last token, where its logits are
        read), slots (engine slot ids, -1 = pad) and seg_off (packed index
        of the segment's first token); ``slots``/``seg_off`` serve
        quantized pools only. Returns (logits (S, V), pools), pools updated
        in place. A ``ParallelContext`` as ``paged_step`` takes it."""
        parallel, mesh_call = _paged_parallel(parallel)
        if mesh_call:
            return _mesh_paged(self, "paged_prefill_packed", params, pools,
                               (tokens, seg_ids, q_pos, kv_lens,
                                block_tables, slots, last_idx, seg_off),
                               dict(kv_bits=kv_bits))
        cfg = self.cfg
        x = self._embed(params, torch.clamp(tokens, min=0)[None])
        if not cfg.use_rope:
            x = x + _sinusoid(torch.clamp(q_pos, min=0)[None],
                              cfg.d_model).to(cfg.dtype)
        paged = _quant_paged({"block_tables": block_tables,
                              "q_pos": q_pos[None], "kv_lens": kv_lens,
                              "seg_ids": seg_ids[None]}, kv_bits, slots,
                             seg_off)
        x, layer_pools, _ = forward_stack(params["dec"], x, cfg,
                                          cache=pools["layers"], paged=paged,
                                          parallel=parallel)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        hidden = x[0][torch.clamp(last_idx.to(torch.int64), min=0)]
        return self._logits(params, hidden, parallel), {"layers": layer_pools}

    def paged_decode_horizon(self, params, pools, tokens, start_pos,
                             block_tables, n_left, eos_ids, horizon,
                             kv_bits=16, slots=None, parallel=None):
        """``horizon`` decode iterations with greedy sampling on the device.

        Each iteration is one ``paged_step`` over a (B, 1) batch: it writes
        the fed token's K/V, takes the argmax of its own logits on the
        device and feeds it back. Rows that sample ``eos_ids[b]`` or exhaust
        ``n_left[b]`` carry ``q_pos = -1`` from then on (writes land on the
        scratch page, attention sees nothing). Only the (B, H) tokens and
        masks are ever read back by the caller — never (B, vocab) logits.

        tokens (B,) last sampled, not-yet-cached token; start_pos (B,) its
        position (-1 = pad row); block_tables must cover the whole lease;
        n_left/eos_ids (B,). Returns (tokens (B, H) int32, valid (B, H)
        bool prefix masks, pools). Under a ``TPShard`` the logits, and so
        the argmax, are the same on every rank; a ``ParallelContext`` as
        ``paged_step`` takes it."""
        parallel, mesh_call = _paged_parallel(parallel)
        if mesh_call:
            return _mesh_paged(self, "paged_decode_horizon", params, pools,
                               (tokens, start_pos, block_tables, n_left,
                                eos_ids, int(horizon)),
                               dict(kv_bits=kv_bits, slots=slots))
        tok = tokens.to(torch.int32)
        pos = start_pos.to(torch.int32)
        active = (start_pos >= 0) & (n_left > 0)
        out_tok, out_valid = [], []
        for i in range(int(horizon)):
            q_pos = torch.where(active, pos, torch.full_like(pos, -1))[:, None]
            kv_lens = torch.clamp(pos, min=0) + 1
            logits, pools = self.paged_step(params, pools, tok[:, None], q_pos,
                                            kv_lens, block_tables,
                                            kv_bits=kv_bits, slots=slots,
                                            parallel=parallel)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            hit_eos = (eos_ids >= 0) & (nxt == eos_ids)
            valid = active
            active = active & ~hit_eos & (i + 1 < n_left)
            tok = torch.where(valid, nxt, tok)
            pos = pos + valid.to(torch.int32)
            out_tok.append(torch.where(valid, nxt, torch.zeros_like(nxt)))
            out_valid.append(valid)
        return torch.stack(out_tok, 1), torch.stack(out_valid, 1), pools


def _map_defs(fn, defs, path=()):
    """``fn(path, shape)`` over a ``cache_defs`` tree, nested alike."""
    if isinstance(defs, dict):
        return {k: _map_defs(fn, v, path + (k,)) for k, v in defs.items()}
    return fn(path, tuple(defs[0]))


class _GlobalValue(torch.autograd.Function):
    """A rank's share of the loss -> the loss: forward the shares summed
    over the data axes (identical on every rank), backward the identity
    to the share (the exact transpose of that sum's use on each rank)."""

    @staticmethod
    def forward(fctx, share, ctx):
        return shd.raw_psum(ctx, share.detach(), ctx.dp_axes).clone()

    @staticmethod
    def backward(fctx, g):
        return g, None


def _mesh_loss(model, params, batch, ctx):
    """``Model.loss`` from the controller: every rank runs it on its
    blocks (no gradients); returns rank 0's (loss, metrics)."""
    return ctx.mesh.run(_rank_loss, model, shd._plain(params),
                        per_rank=shd.batch_blocks(ctx, batch))


def _rank_loss(rctx, model, params, batch):
    dev = rctx.device
    batch = {k: v.to(dev) for k, v in batch.items()}
    with torch.no_grad():
        return model.loss(params.local(rctx), batch, rctx.par)


# -- static serving from the controller --------------------------------------

def _rows(ctx, t, gbatch):
    """A rank's rows of a batch-major result -> the whole batch's (gathered
    over the data axes where the batch is cut)."""
    spec = shd.resolve_spec(("batch",), (gbatch,), ctx)
    return shd.raw_all_gather(ctx, t, spec[0], 0) if spec else t


def _to_device(batch, dev):
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _mesh_prefill(model, params, batch, ctx):
    """``Model.prefill`` from the controller: every rank prefills its rows
    and keeps its blocks of the cache under a new key; returns (rank 0's
    whole-batch logits, the cache's ``Sharded`` handle)."""
    mesh = ctx.mesh
    key = mesh.new_key()
    gb = int(next(iter(batch.values())).shape[0])
    logits, layout = mesh.run(_rank_prefill, model, shd._plain(params), key,
                              gb, per_rank=shd.batch_blocks(ctx, batch,
                                                            strict=False))
    return logits, shd.Sharded(mesh, key,
                               model.cache_shardings(ctx, layout))


def _rank_prefill(rctx, model, params, key, gb, batch):
    with torch.no_grad():
        logits, cache = model.prefill(params.local(rctx),
                                      _to_device(batch, rctx.device),
                                      rctx.par, global_batch=gb)
    rctx.states[key] = cache
    return _rows(rctx.par, logits, gb), model.cache_layout(batch, gb)


def layout_of(sharded):
    """The ``CacheLayout`` of a static cache's ``Sharded`` handle."""
    batch = seq = enc = None
    for path, ns in _leaf_shardings(sharded.shardings):
        if path[-1] == "pos":
            batch, seq = ns.shape
        elif path[-2:] in (("attn", "k"),):
            batch, seq = ns.shape[1], ns.shape[2]
        elif path[-2:] == ("xattn", "k"):
            enc = ns.shape[2]
        elif batch is None:
            batch, seq = ns.shape[1], 1
    return CacheLayout(batch, seq, enc)


def _leaf_shardings(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_shardings(tree[k], path + (k,))
    else:
        yield path, tree


def _mesh_decode(model, params, cache, tokens, cur_pos, ctx):
    """``Model.decode_step`` from the controller: every rank steps its
    blocks of the cache in place; returns (rank 0's whole-batch logits,
    the handle)."""
    layout = layout_of(cache)
    logits = ctx.mesh.run(
        _rank_decode, model, shd._plain(params), shd._plain(cache), layout,
        per_rank=shd.batch_blocks(ctx, {"tokens": tokens,
                                        "cur_pos": cur_pos}, strict=False))
    return logits, cache


def _rank_decode(rctx, model, params, cache, layout, inputs):
    x = _to_device(inputs, rctx.device)
    with torch.no_grad():
        logits, _ = model.decode_step(params.local(rctx), cache.local(rctx),
                                      x["tokens"], x["cur_pos"], rctx.par,
                                      layout=layout)
    return _rows(rctx.par, logits, layout.batch)


# -- paged serving on a process mesh ------------------------------------------

def model_index(ctx, rank):
    """Rank ``rank``'s index along ``ctx``'s ``model`` axis."""
    return dataclasses.replace(ctx, coords=ctx.mesh.coords(rank)).index(
        ctx.tp_axis)


def _paged_parallel(parallel):
    """A paged step's ``parallel``: a rank's ``ParallelContext`` becomes
    its ``model_shard``; (parallel, whether the controller runs the step
    on every rank)."""
    if isinstance(parallel, ParallelContext):
        if not parallel.on_rank:
            return parallel, True
        return parallel.model_shard(), False
    return parallel, False


def shard_params(model, params, mesh, device, ctx=None):
    """Partition ``params`` (on ``device``, rank 0's) for ``mesh``
    (``core.policy.tp_partition_params``) and cut every rank's slices
    (``tp_shard``): rank 0's stay on ``device``, the others' move to the
    CPU, to be sent to their ranks. With ``ctx`` (a ``ParallelContext``
    on ``mesh``) the partition is over its ``model`` axis and rank r
    takes the slices of its ``model`` index. Returns (every rank's
    slices, the planner's report)."""
    from ..core.policy import tp_partition_params, tp_shard
    if mesh.device != device:
        raise ValueError(f"the engine's device {device} is not rank 0's "
                         f"{mesh.device}")
    tp = mesh.size if ctx is None else ctx.tp_size
    tree, specs, report = tp_partition_params(params, tp, cfg=model.cfg)
    index = [r if ctx is None else model_index(ctx, r)
             for r in range(mesh.size)]
    shards = [tp_shard(tree, specs, index[0], tp)]
    for r in range(1, mesh.size):
        shards.append(map_tensors(lambda t: t.cpu(),
                                  tp_shard(tree, specs, index[r], tp)))
    return shards, report


def install_slices(rctx, params):
    """On a mesh rank: its slices of ``shard_params`` on its device,
    localized (``core.policy.tp_localize``); every mesh engine's and
    ``place_paged``'s install."""
    from ..core.policy import tp_localize
    return tp_localize(map_tensors(lambda t: t.to(rctx.device), params))


def _mesh_pools(model, ctx, **kw):
    """Every rank's pools (its ``model_shard``'s KV heads) under a new
    key; the ``Sharded`` handle (placements: the heads' dim over
    ``model`` where they split)."""
    mesh = ctx.mesh
    key = mesh.new_key()
    mesh.install(key, _install_pools, [()] * mesh.size, model, kw)
    whole = model.init_paged_pools(device="meta", **kw)
    split = heads_split(model.cfg, shd.TPShard(size=ctx.tp_size))

    def sharding(path, t):
        spec = ()
        if split:        # the KV-heads dim: 2 of the scales, 3 else
            spec = (None,) * (2 if path[-1].endswith("scales") else 3) + (
                ctx.tp_axis,)
        return shd.NamedSharding(mesh, spec, tuple(t.shape))
    return shd.Sharded(mesh, key, _map_path(sharding, whole))


def _map_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _install_pools(rctx, model, kw):
    return model.init_paged_pools(device=rctx.device, parallel=rctx.par,
                                  **kw)


def _mesh_paged(model, name, params, pools, args, kw):
    """A paged step from the controller: ``args`` (host or any device's
    tensors, ints) sent to every rank, which runs ``name`` on its params
    and pools; returns rank 0's outputs with the pools' handle last."""
    args = tuple(a.detach().cpu() if isinstance(a, torch.Tensor) else a
                 for a in args)
    kw = {k: (v.detach().cpu() if isinstance(v, torch.Tensor) else v)
          for k, v in kw.items()}
    out = pools.mesh.run(_rank_paged, model, name, shd._plain(params),
                         shd._plain(pools), args, kw)
    return tuple(out) + (pools,)


def _rank_paged(rctx, model, name, params, pools, args, kw):
    dev = rctx.device
    args = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                 for a in args)
    kw = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
          for k, v in kw.items()}
    with torch.no_grad():
        out = getattr(model, name)(params.local(rctx), pools.local(rctx),
                                   *args, parallel=rctx.par, **kw)
    return out[:-1]
