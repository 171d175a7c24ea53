"""Layer plan, parameter declarations and the layer stacks.

Port of ``repro.models.transformer`` for all ten architectures: dense
RoPE decoders (internlm2, granite), qwen's qkv bias, gemma2's post-norm
and local/global sliding windows, MoE FFNs (granite-moe; arctic's MoE
beside a dense residual MLP), jamba's hybrid of mamba and attention
layers with MoE on every 2nd layer, xlstm's sLSTM / mLSTM blocks with no
FFN, and whisper's encoder-decoder with cross-attention (internvl's
frontend is the model's, ``models/model.py``). Per-layer params are
stacked along a leading ``L`` dim (one subtree per period slot, as in the
reference); the reference's ``lax.scan`` over that dim is a Python loop
over layer slices here, and each layer's window is a Python int.
``parallel`` (a ``parallel.TPShard``) reaches every block: the stacks
then run on one rank's shard of a tensor-parallel mesh. Under a
``ParallelContext`` (the loss on a rank of a process mesh, through the
block's ``layers.Spmd`` view) each block runs ``_block_spmd``: the rank's
blocks of the params, the residual stream S/tp rows long between blocks
where SP applies, and the collectives written out (``parallel.sharding``).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..core.quantize import map_tensors
from ..device import resolve_device
from ..parallel import sharding as shd
from . import ssm, xlstm
from .layers import (Spmd, attention_layer, grad_on, mlp_layer, remat,
                     rms_norm, spmd_attention, spmd_attention_decode,
                     spmd_mlp, tp_of)
from .moe import _capacity, moe_layer


def layer_plan(cfg, stack="dec"):
    if stack == "enc":
        return [("enc_attn", "dense")]
    if cfg.layer_pattern == "xlstm":
        return [("slstm", "none"), ("mlstm", "none")]
    if cfg.layer_pattern == "jamba":
        plan = []
        for s in range(cfg.attn_every):
            mixer = "attn" if s % cfg.attn_every == cfg.attn_offset else "mamba"
            ffn = ("moe" if cfg.n_experts and s % cfg.moe_every == cfg.moe_offset
                   else "dense")
            plan.append((mixer, ffn))
        return plan
    if cfg.layer_pattern == "encdec":
        return [("attn", "dense")]
    ffn = "dense"
    if cfg.n_experts:
        ffn = "moe+dense" if cfg.dense_residual else "moe"
    return [("attn", ffn)]


def n_periods(cfg, stack="dec"):
    n_layers = cfg.n_enc_layers if stack == "enc" else cfg.n_layers
    p = len(layer_plan(cfg, stack))
    if n_layers % p:
        raise ValueError(f"{cfg.name}: {n_layers} layers do not divide into "
                         f"periods of {p}")
    return n_layers // p


def supports_paged(cfg):
    """Paged serving covers decoder-only attention stacks (any FFN kind);
    ssm/xlstm/enc-dec caches are per-sequence state, not pages. The
    reference's rule (``Model.supports_paged``)."""
    return (not cfg.is_encdec and cfg.frontend == "none"
            and all(m == "attn" for m, _ in layer_plan(cfg, "dec")))


def _require_attention_stack(cfg):
    """The paged path (pools and paged steps) refuses what the reference
    refuses: a stack with per-sequence state or a frontend."""
    if not supports_paged(cfg):
        raise ValueError(f"{cfg.name}: not a paged-servable arch (ssm/"
                         "xlstm/enc-dec caches are not paged)")


def _attn_defs(cfg, prefix, cross=False):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    defs = {
        f"{prefix}/wq": ((d, h * hd), ("fsdp", "tp"), "fan_in"),
        f"{prefix}/wk": ((d, kv * hd), ("fsdp", "tp"), "fan_in"),
        f"{prefix}/wv": ((d, kv * hd), ("fsdp", "tp"), "fan_in"),
        f"{prefix}/wo": ((h * hd, d), ("tp", "fsdp"), "fan_out"),
    }
    if cfg.qkv_bias and not cross:
        defs.update({
            f"{prefix}/bq": ((h * hd,), ("tp",), "zero"),
            f"{prefix}/bk": ((kv * hd,), ("tp",), "zero"),
            f"{prefix}/bv": ((kv * hd,), ("tp",), "zero"),
        })
    return defs


def _ffn_defs(cfg, prefix):
    d, f = cfg.d_model, cfg.d_ff
    return {
        f"{prefix}/wg": ((d, f), ("fsdp", "tp"), "fan_in"),
        f"{prefix}/wi": ((d, f), ("fsdp", "tp"), "fan_in"),
        f"{prefix}/wo": ((f, d), ("tp", "fsdp"), "fan_out"),
    }


def _moe_defs(cfg, prefix):
    """Experts padded to ``n_experts_padded`` (granite-moe: 40 -> 48); the
    router keeps a column per padded expert, masked in routing."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts_padded
    return {
        f"{prefix}/router": ((d, e), (None, None), "fan_in"),
        f"{prefix}/wg": ((e, d, f), ("experts", "fsdp", None), "fan_in"),
        f"{prefix}/wi": ((e, d, f), ("experts", "fsdp", None), "fan_in"),
        f"{prefix}/wo": ((e, f, d), ("experts", "fsdp", None), "fan_out"),
    }


def _slot_defs(cfg, slot_prefix, mixer, ffn, cross=False):
    d = cfg.d_model
    defs = {f"{slot_prefix}/norm1": ((d,), (None,), "zero")}
    if mixer in ("attn", "enc_attn"):
        defs.update(_attn_defs(cfg, f"{slot_prefix}/attn"))
    elif mixer == "mamba":
        defs.update(ssm.mamba_param_defs(cfg, f"{slot_prefix}/mamba"))
    else:
        defs.update(xlstm.xlstm_param_defs(cfg, f"{slot_prefix}/{mixer}",
                                           mixer))
    if cfg.post_norm:
        defs[f"{slot_prefix}/norm1b"] = ((d,), (None,), "zero")
    if cross:
        defs[f"{slot_prefix}/normx"] = ((d,), (None,), "zero")
        defs.update(_attn_defs(cfg, f"{slot_prefix}/xattn", cross=True))
    if ffn != "none":
        defs[f"{slot_prefix}/norm2"] = ((d,), (None,), "zero")
        if cfg.post_norm:
            defs[f"{slot_prefix}/norm2b"] = ((d,), (None,), "zero")
    if ffn in ("dense", "moe+dense"):
        defs.update(_ffn_defs(cfg, f"{slot_prefix}/mlp"))
    if ffn in ("moe", "moe+dense"):
        defs.update(_moe_defs(cfg, f"{slot_prefix}/moe"))
    return defs


def param_decls(cfg):
    """path -> (shape, logical axes, init kind), as the reference's
    ``param_defs`` declares them (a layer's shape and axes without the
    leading periods dim)."""
    d, vp = cfg.d_model, cfg.vocab_padded
    defs = {"embed": ((vp, d), ("vocab", "fsdp"), "embed"),
            "final_norm": ((d,), (None,), "zero")}
    if not cfg.tie_embeddings:
        defs["unembed"] = ((vp, d), ("vocab", "fsdp"), "fan_out")
    for slot, (mixer, ffn) in enumerate(layer_plan(cfg, "dec")):
        defs.update(_slot_defs(cfg, f"dec/s{slot}", mixer, ffn,
                               cross=cfg.is_encdec))
    if cfg.is_encdec:
        defs["enc_final_norm"] = ((d,), (None,), "zero")
        for slot, (mixer, ffn) in enumerate(layer_plan(cfg, "enc")):
            defs.update(_slot_defs(cfg, f"enc/s{slot}", mixer, ffn))
    return defs


def param_defs(cfg):
    """path -> (shape, init_kind) of ``param_decls``."""
    return {path: (shape, kind)
            for path, (shape, _axes, kind) in param_decls(cfg).items()}


def _full_shape(cfg, path, shape):
    stack = path.split("/", 1)[0]
    return ((n_periods(cfg, stack),) + tuple(shape)
            if stack in ("dec", "enc") else tuple(shape))


def param_axes(cfg):
    """The params tree's logical axes (a layer leaf's first, the periods
    dim, replicated), the sharding resolver's input."""
    return _nest({path: ((None,) + tuple(axes)
                         if path.startswith(("dec/", "enc/"))
                         else tuple(axes))
                  for path, (_s, axes, _k) in param_decls(cfg).items()})


def param_shapes(cfg):
    """The params tree's shapes (tuples), layers stacked over periods."""
    return _nest({path: _full_shape(cfg, path, shape)
                  for path, (shape, _a, _k) in param_decls(cfg).items()})


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def _init_leaf(shape, full, kind, generator, dev):
    f32 = torch.float32
    if kind == "zero":
        return torch.zeros(full, dtype=f32, device=dev)
    if kind == "one":
        return torch.ones(full, dtype=f32, device=dev)
    if kind == "f_bias":
        return torch.full(full, 3.0, dtype=f32, device=dev)
    if kind == "a_log":                      # log(1..N) along the last dim
        n = shape[-1]
        return torch.log(torch.arange(1, n + 1, dtype=f32, device=dev)
                         ).expand(full).contiguous()
    if kind == "dt_bias":    # softplus^-1 of a log-uniform draw in [1e-3, 0.1]
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand(full, generator=generator, dtype=f32, device=dev)
        return torch.log(torch.expm1(torch.exp(lo + (hi - lo) * u)))
    v = torch.randn(full, generator=generator, dtype=f32, device=dev)
    if kind == "orth":
        return v * 0.1
    if kind != "embed":                      # fan_in / fan_out
        v /= math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
    return v


def init_leaves(cfg, generator, device=None):
    """Yield (path, random f32 leaf) on ``device`` (``None`` = the card),
    drawn from ``generator`` (a ``torch.Generator`` on that device) in
    sorted path order; layer params carry a leading ``n_periods`` dim. One
    leaf at a time, so a caller can quantize each before the next exists.
    Init kinds as the reference's: "zero", "one", "f_bias" (3), "a_log"
    (log 1..N), "dt_bias" (the inverse softplus of a log-uniform draw),
    "orth" (0.1 N(0, 1)), "embed" (N(0, 1)), fan-scaled normals. The
    numbers differ from the reference's ``jax.random`` ones; the parity
    tests carry the reference's params across instead
    (``repro_torch.convert``)."""
    dev = resolve_device(device)
    for path, (shape, kind) in sorted(param_defs(cfg).items()):
        yield path, _init_leaf(shape, _full_shape(cfg, path, shape), kind,
                               generator, dev)


def init_params(cfg, generator, device=None):
    """The params tree of ``init_leaves``."""
    return _nest(dict(init_leaves(cfg, generator, device)))


def _pads_reach_tokens(cfg, plan, tokens):
    """Whether a paged dispatch of ``tokens`` (B * T) can let its pads move
    a real token: only through an MoE layer's capacity, and only where an
    expert can overflow. Top-k picks distinct experts, so an expert takes
    at most ``tokens`` choices and overflows only if its capacity is below
    that (never at decode with B <= 8). Host ints: constant per dispatch
    shape."""
    return (any(ffn != "dense" for _, ffn in plan)
            and _capacity(tokens, cfg.n_experts_active, cfg.n_experts_padded,
                          cfg.capacity_factor) < tokens)


def _block(x, lp, cfg, mixer, ffn, *, window, positions, cur_pos, cache,
           enc_out, cross, decode_positions, paged, mean_pads=False,
           parallel=None):
    """One (mixer + FFN) residual block, pre-norm and (gemma2) post-norm
    after the mixer and after the FFN. ``mixer`` is "attn" (causal),
    "enc_attn" (whisper's encoder, not causal), "mamba", "slstm" or
    "mlstm"; ``cross`` adds whisper's cross-attention onto ``enc_out``
    (prefill and the loss) or onto the static ``xattn`` cache (decode);
    ``ffn`` is "dense", "moe", "moe+dense" (the two summed, arctic) or
    "none" (xlstm). ``mean_pads``: paged pads take the reference's
    attention output (``_pads_reach_tokens``). ``parallel``: a
    ``TPShard`` or None, handed to attention, the MLP and the MoE FFN
    (the mamba and xLSTM mixers replicate). Returns (x, new_cache, aux):
    new_cache keyed "attn" or the mixer's name (and "xattn"), aux the
    router's load-balancing loss, None without an MoE FFN."""
    aux = None
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    key = "attn" if mixer in ("attn", "enc_attn") else mixer
    mix_cache = None if cache is None else cache[key]
    if key == "attn":
        y, nc = attention_layer(
            lp["attn"], h, cfg, positions, window=window, cache=mix_cache,
            cur_pos=cur_pos, causal=mixer == "attn",
            decode_positions=decode_positions, paged=paged,
            mean_pads=mean_pads, parallel=parallel)
    elif mixer == "mamba":
        y, nc = ssm.mamba_layer(lp["mamba"], h, cfg, mix_cache)
    elif mixer == "slstm":
        y, nc = xlstm.slstm_layer(lp["slstm"], h, cfg, mix_cache)
    else:
        y, nc = xlstm.mlstm_layer(lp["mlstm"], h, cfg, mix_cache)
    if cfg.post_norm:
        y = rms_norm(y, lp["norm1b"], cfg.norm_eps)
    x = x + y
    new_cache = {key: nc}
    if cross:
        h = rms_norm(x, lp["normx"], cfg.norm_eps)
        y, new_cache["xattn"] = attention_layer(
            lp["xattn"], h, cfg, positions,
            cache=None if cache is None else cache["xattn"],
            cur_pos=cur_pos, xattn_kv=enc_out, causal=False,
            cross=cache is not None, parallel=parallel)
        x = x + y
    if ffn == "none":
        return x, new_cache, aux
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    y = None if ffn == "moe" else mlp_layer(lp["mlp"], h, tp_of(parallel))
    if ffn != "dense":
        ym, aux = moe_layer(lp["moe"], h, cfg, parallel)
        y = ym if y is None else y + ym
    if cfg.post_norm:
        y = rms_norm(y, lp["norm2b"], cfg.norm_eps)
    return x + y, new_cache, aux


def _strip_layer(specs):
    """A layer-stack spec tree without each leaf's periods dim."""
    if isinstance(specs, dict):
        return {k: _strip_layer(v) for k, v in specs.items()}
    return tuple(specs[1:])


def _block_spmd(x, lp, ls, cfg, mixer, ffn, *, window, positions, enc_out,
                cross, sm, cs=None, cache=None, cur_pos=None,
                decode_positions=None, ring_slot=None):
    """``_block`` on a rank under ``Spmd`` ``sm``: ``lp`` the layer's local
    blocks, ``ls`` their specs, ``x`` the rank's residual stream (its
    batch rows; its rows of the sequence under SP). Attention, mamba, the
    MLP and the MoE FFN take their sharded paths (``spmd_attention``,
    ``ssm.spmd_mamba``, ``spmd_mlp``, ``moe_layer``); xLSTM's mixers and
    whisper's cross-attention run whole and alike on every ``model`` rank
    (the reference shards no activation of theirs over ``model`` here).
    Norms and residual adds run on the stream as it lies.

    Serving passes ``cs``, the layer cache's specs without the periods dim
    (``Model.cache_specs``): prefill (``cache`` None) then collects the
    layer's cache in that layout, decode (S = 1, ``cache`` the rank's
    blocks) steps it. Attention leaves its K/V cut by ``kv_seq`` and
    decodes through the flash-decode combine
    (``layers.spmd_attention_decode``, ring slot ``ring_slot % S``); mamba
    keeps its state on the rank's channels; xLSTM's state and the
    cross-attention K/V go between the cache's layout and the whole
    sequence of the rank's rows (``sharding.reshard``). Returns (x, the
    layer's new cache (None for the loss), aux)."""
    ctx, dup = sm.ctx, not sm.sp
    serve, decode = cs is not None, cache is not None
    rows = (sm.bspec,)              # the batch rows' layout, whole inside

    def norm(t, name):
        return rms_norm(t, sm.use(lp[name], ls[name], dup=dup),
                        cfg.norm_eps)

    def moved(tree, specs, src_rows):
        """A state tree between its cache specs and ``rows``."""
        if isinstance(tree, dict):
            return {k: moved(tree[k], specs[k], src_rows) for k in tree}
        src, dst = (rows, specs) if src_rows else (specs, rows)
        return shd.reshard(tree, ctx, src, dst)

    def whole(fn, name, h, **kw):
        w = sm.use_tree(lp[name], ls[name], dup=True)
        y, state = fn(w, sm.full(h, dup=True), cfg, **kw)
        return sm.from_full_dup(y), state

    aux, new_cache = None, {} if serve else None
    h = norm(x, "norm1")
    if mixer in ("attn", "enc_attn") and decode:
        y, new_cache["attn"] = spmd_attention_decode(
            lp["attn"], ls["attn"], h, cfg, sm, cache["attn"],
            cs["attn"]["k"], cur_pos, decode_positions, window=window,
            slot=ring_slot)
    elif mixer in ("attn", "enc_attn"):
        y = spmd_attention(lp["attn"], ls["attn"], h, cfg, sm, positions,
                           window=window, causal=mixer == "attn",
                           cache_spec=cs["attn"]["k"] if serve else None)
        if serve:
            y, new_cache["attn"] = y
    elif mixer == "mamba":
        y = ssm.spmd_mamba(lp["mamba"], ls["mamba"], h, cfg, sm,
                           cache=cache["mamba"] if decode else None,
                           cache_specs=cs["mamba"] if serve else None)
        if serve:
            y, new_cache["mamba"] = y
    else:
        fn = xlstm.slstm_layer if mixer == "slstm" else xlstm.mlstm_layer
        st = moved(cache[mixer], cs[mixer], False) if decode else None
        y, state = whole(fn, mixer, h, cache=st)
        if serve:
            new_cache[mixer] = moved(state, cs[mixer], True)
    if cfg.post_norm:
        y = norm(y, "norm1b")
    x = x + y
    if cross and decode:
        y, new_cache["xattn"] = spmd_attention_decode(
            lp["xattn"], ls["xattn"], norm(x, "normx"), cfg, sm,
            cache["xattn"], cs["xattn"]["k"], cur_pos, None, window=0,
            cross=True)
        x = x + y
    elif cross:
        y, kv = whole(attention_layer, "xattn", norm(x, "normx"),
                      positions=positions, xattn_kv=enc_out, causal=False)
        if serve:
            new_cache["xattn"] = moved(kv, cs["xattn"], True)
        x = x + y
    if ffn != "none":
        h = norm(x, "norm2")
        y = None if ffn == "moe" else spmd_mlp(lp["mlp"], ls["mlp"], h, sm)
        if ffn != "dense":
            ym, aux = moe_layer(lp["moe"], h, cfg, sm)
            y = ym if y is None else y + ym
        if cfg.post_norm:
            y = norm(y, "norm2b")
        x = x + y
    b = sm.gbatch(x.shape[0])
    shd.constraint(x, ("batch", "sp", None), ctx, (b, sm.seq, x.shape[2]))
    return x, new_cache, aux


def _write_state(view, new):
    """Copy the new recurrent state into the cache's layer slice; leaves
    the block returned as they were (ring K/V written in place, the
    static ``xattn`` K/V) are skipped."""
    for k, v in new.items():
        if isinstance(v, dict):
            _write_state(view[k], v)
        elif v is not view[k]:
            view[k].copy_(v)


def _stack_caches(caches):
    """Per-period cache trees -> one tree of leaves stacked on dim 0."""
    first = caches[0]
    if isinstance(first, dict):
        return {k: _stack_caches([c[k] for c in caches]) for k in first}
    return torch.stack(caches)


def _window_array(cfg, stack="dec"):
    """Per-period, per-slot sliding-window sizes as nested lists of ints
    (gemma2: ``sliding_window`` on layers ``i % local_every == 0``, 0 on
    the others), the reference's int32 array as Python ints."""
    plan = layer_plan(cfg, stack)
    np_, p = n_periods(cfg, stack), len(plan)
    wins = [[0] * p for _ in range(np_)]
    if cfg.sliding_window and cfg.local_every:
        for layer in range(np_ * p):
            if layer % cfg.local_every == 0:
                wins[layer // p][layer % p] = int(cfg.sliding_window)
    return wins


def forward_stack(params_stack, x, cfg, *, stack="dec", positions=None,
                  cache=None, cur_pos=None, enc_out=None, collect_cache=False,
                  decode_positions=None, paged=None, parallel=None,
                  cache_specs=None, ring_slot=None):
    """Run a layer stack, ``stack`` "dec" or "enc" (whisper's encoder; the
    reference's scan is a loop over layer slices). Returns (x, cache,
    aux): ``aux`` the router losses summed over layers (f32 scalar, 0
    without MoE). ``enc_out`` (B, S_enc, D): the encoder's output, which
    the decoder's cross-attention reads in prefill and the loss.

    * loss: ``positions`` only (``_loss_stack``); returns (x, None, aux).
    * prefill: ``collect_cache=True``; returns each slot's cache stacked
      over periods: attention's roped {"k", "v"} (n_periods, B, S, KV, d),
      mamba's {"conv", "ssm"} and sLSTM / mLSTM state after the last
      position, and whisper's cross-attention {"k", "v"} over the S_enc
      encoder rows ("xattn").
    * decode: ``cache`` (the ``layers`` subtree of ``Model.init_cache``)
      with ``cur_pos`` and ``decode_positions`` (None without attention);
      each layer writes its ring slice and its recurrent state in place,
      reads its static ``xattn`` K/V, and ``cache`` is returned.
    * paged: ``cache`` = the pools' ``layers`` subtree and ``paged``; each
      layer writes its slice of the stacked pools in place.

    Under a ``layers.Spmd`` view (a rank of a process mesh) prefill and
    decode run ``_block_spmd`` on the rank's blocks, with
    ``cache_specs`` the cache's ``layers`` spec tree (``Model.
    cache_specs``): the collected cache leaves, and the decode cache is,
    the rank's blocks under those specs; decode writes ring slot
    ``ring_slot % S`` (a (1,) tensor).

    Each layer's window is a Python int from ``_window_array``: constant
    per layer, so a captured CUDA graph holds it as it holds a shape.

    The loss runs ``_loss_stack``; under autograd (grad mode on and the
    params or ``x`` requiring grad) with ``cfg.remat``, each period is
    rematerialized there, and with more than one block a period each
    block in it too: the reference's nested ``nothing_saveable``
    checkpoints. Serving paths never remat."""
    if paged is not None:
        _require_attention_stack(cfg)
    if isinstance(parallel, shd.ParallelContext):
        raise TypeError("forward_stack takes a rank's ParallelContext "
                        "through a layers.Spmd view (Model's methods make "
                        "it)")
    plan = layer_plan(cfg, stack)
    wins = _window_array(cfg, stack)
    cross = cfg.is_encdec and stack == "dec"
    if cache is None and not collect_cache:
        return _loss_stack(params_stack, x, cfg, plan, wins, cross, stack,
                           positions, enc_out, cfg.remat and grad_on(
                               x, enc_out, *_leaf_tensors(params_stack)),
                           parallel)
    mean_pads = paged is not None and _pads_reach_tokens(
        cfg, plan, x.shape[0] * x.shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    collected = {f"s{slot}": [] for slot in range(len(plan))}
    spmd = isinstance(parallel, Spmd)
    if spmd and (paged is not None or cache_specs is None):
        raise ValueError("a ParallelContext's cached stack needs the "
                         "cache's specs and runs no paged step")
    for period in range(n_periods(cfg, stack)):
        for slot, (mixer, ffn) in enumerate(plan):
            name = f"s{slot}"
            lp = map_tensors(lambda t: t[period], params_stack[name])
            layer_cache = (None if cache is None else
                           map_tensors(lambda t: t[period], cache[name]))
            if spmd:
                x, nc, a = _block_spmd(
                    x, lp, _strip_layer(parallel.specs[stack][name]), cfg,
                    mixer, ffn, window=wins[period][slot],
                    positions=positions, enc_out=enc_out, cross=cross,
                    sm=parallel, cs=_strip_layer(cache_specs[name]),
                    cache=layer_cache, cur_pos=cur_pos,
                    decode_positions=decode_positions, ring_slot=ring_slot)
            else:
                x, nc, a = _block(x, lp, cfg, mixer, ffn,
                                  window=wins[period][slot],
                                  positions=positions, cur_pos=cur_pos,
                                  cache=layer_cache, enc_out=enc_out,
                                  cross=cross,
                                  decode_positions=decode_positions,
                                  paged=paged, mean_pads=mean_pads,
                                  parallel=parallel)
            if a is not None:
                aux = aux + a
            if collect_cache:
                collected[name].append(nc)
            elif layer_cache is not None and paged is None:
                _write_state(layer_cache, nc)
    if collect_cache:
        cache = {name: _stack_caches(cs) for name, cs in collected.items()}
    return x, cache, aux


def _leaf_tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaf_tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _loss_stack(params_stack, x, cfg, plan, wins, cross, stack, positions,
                enc_out, on, parallel=None):
    """The loss forward of ``forward_stack``, with each period (and, for a
    period of several blocks, each block) under ``remat`` when ``on``.
    Returns (x, None, aux)."""
    nested = on and len(plan) > 1

    def block(x_, period, slot):
        mixer, ffn = plan[slot]
        lp = map_tensors(lambda t: t[period], params_stack[f"s{slot}"])
        if isinstance(parallel, Spmd):
            y, _, a = _block_spmd(
                x_, lp, _strip_layer(parallel.specs[stack][f"s{slot}"]),
                cfg, mixer, ffn, window=wins[period][slot],
                positions=positions, enc_out=enc_out, cross=cross,
                sm=parallel)
        else:
            y, _, a = _block(x_, lp, cfg, mixer, ffn,
                             window=wins[period][slot], positions=positions,
                             cur_pos=None, cache=None, enc_out=enc_out,
                             cross=cross, decode_positions=None, paged=None,
                             parallel=parallel)
        return y, (torch.zeros((), dtype=torch.float32, device=y.device)
                   if a is None else a)

    def period_fn(x_, period):
        aux_p = torch.zeros((), dtype=torch.float32, device=x_.device)
        for slot in range(len(plan)):
            x_, a = remat(block, x_, period, slot, on=nested)
            aux_p = aux_p + a
        return x_, aux_p

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for period in range(n_periods(cfg, stack)):
        x, a = remat(period_fn, x, period, on=on)
        aux = aux + a
    return x, None, aux
