"""Layer plan, parameter declarations and the layer stack.

Port of ``repro.models.transformer`` for decoder-only attention stacks,
every FFN kind: dense RoPE decoders (internlm2, granite), qwen's qkv bias,
gemma2's post-norm and local/global sliding windows, and MoE FFNs
(granite-moe; arctic's MoE beside a dense residual MLP). Per-layer params
are stacked along a leading ``L`` dim (one subtree per period slot, as in
the reference); the reference's ``lax.scan`` over that dim is a Python loop
over layer slices here, and each layer's window is a Python int.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..core.quantize import map_tensors
from ..device import resolve_device
from .layers import attention_layer, mlp_layer, rms_norm
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


def _require_attention_stack(cfg):
    """The port runs the stacks the reference serves paged
    (``Model.supports_paged``): decoder-only, no frontend, every mixer
    attention with RoPE; any FFN kind. ROADMAP item 10 brings the rest."""
    if (cfg.is_encdec or cfg.frontend != "none" or not cfg.use_rope
            or any(mixer != "attn" for mixer, _ in layer_plan(cfg, "dec"))):
        raise NotImplementedError(
            f"{cfg.name}: the port runs decoder-only attention stacks "
            "(ROADMAP item 10 brings jamba's mamba layers, xlstm, the "
            "whisper enc-dec and the internvl frontend)")


def _attn_defs(cfg, prefix):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    defs = {
        f"{prefix}/wq": ((d, h * hd), "fan_in"),
        f"{prefix}/wk": ((d, kv * hd), "fan_in"),
        f"{prefix}/wv": ((d, kv * hd), "fan_in"),
        f"{prefix}/wo": ((h * hd, d), "fan_out"),
    }
    if cfg.qkv_bias:
        defs.update({
            f"{prefix}/bq": ((h * hd,), "zero"),
            f"{prefix}/bk": ((kv * hd,), "zero"),
            f"{prefix}/bv": ((kv * hd,), "zero"),
        })
    return defs


def _ffn_defs(cfg, prefix):
    d, f = cfg.d_model, cfg.d_ff
    return {
        f"{prefix}/wg": ((d, f), "fan_in"),
        f"{prefix}/wi": ((d, f), "fan_in"),
        f"{prefix}/wo": ((f, d), "fan_out"),
    }


def _moe_defs(cfg, prefix):
    """Experts padded to ``n_experts_padded`` (granite-moe: 40 -> 48); the
    router keeps a column per padded expert, masked in routing."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts_padded
    return {
        f"{prefix}/router": ((d, e), "fan_in"),
        f"{prefix}/wg": ((e, d, f), "fan_in"),
        f"{prefix}/wi": ((e, d, f), "fan_in"),
        f"{prefix}/wo": ((e, f, d), "fan_out"),
    }


def _slot_defs(cfg, slot_prefix, ffn):
    d = cfg.d_model
    defs = {f"{slot_prefix}/norm1": ((d,), "zero")}
    defs.update(_attn_defs(cfg, f"{slot_prefix}/attn"))
    defs[f"{slot_prefix}/norm2"] = ((d,), "zero")
    if cfg.post_norm:
        defs[f"{slot_prefix}/norm1b"] = ((d,), "zero")
        defs[f"{slot_prefix}/norm2b"] = ((d,), "zero")
    if ffn in ("dense", "moe+dense"):
        defs.update(_ffn_defs(cfg, f"{slot_prefix}/mlp"))
    if ffn in ("moe", "moe+dense"):
        defs.update(_moe_defs(cfg, f"{slot_prefix}/moe"))
    return defs


def param_defs(cfg):
    """path -> (shape, init_kind), as the reference declares them."""
    _require_attention_stack(cfg)
    d, vp = cfg.d_model, cfg.vocab_padded
    defs = {"embed": ((vp, d), "embed"), "final_norm": ((d,), "zero")}
    if not cfg.tie_embeddings:
        defs["unembed"] = ((vp, d), "fan_out")
    for slot, (_mixer, ffn) in enumerate(layer_plan(cfg, "dec")):
        defs.update(_slot_defs(cfg, f"dec/s{slot}", ffn))
    return defs


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def init_params(cfg, generator, device=None):
    """Random f32 params on ``device`` (``None`` = the card), drawn from
    ``generator`` (a ``torch.Generator`` on that device) in sorted path
    order. Layer params carry a leading ``n_periods`` dim. The numbers
    differ from the reference's ``jax.random`` ones; the parity tests carry
    the reference's params across instead (``repro_torch.convert``)."""
    dev = resolve_device(device)
    flat = {}
    for path, (shape, kind) in sorted(param_defs(cfg).items()):
        full = ((n_periods(cfg),) + shape if path.startswith("dec/")
                else shape)
        if kind == "zero":
            v = torch.zeros(full, dtype=torch.float32, device=dev)
        else:
            v = torch.randn(full, generator=generator, dtype=torch.float32,
                            device=dev)
            if kind != "embed":                  # fan_in / fan_out
                v /= math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])
        flat[path] = v
    return _nest(flat)


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


def _block(x, lp, cfg, ffn, *, window, positions, cur_pos, cache,
           decode_positions, paged, mean_pads=False):
    """One attention + FFN residual block, pre-norm and (gemma2) post-norm
    after the mixer and after the FFN; ``ffn`` is "dense", "moe" or
    "moe+dense" (the two summed, arctic). ``mean_pads``: paged pads take
    the reference's attention output (``_pads_reach_tokens``). Returns (x,
    new_cache, aux): the router's load-balancing loss, None without an MoE
    FFN."""
    aux = None
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    y, new_cache = attention_layer(
        lp["attn"], h, cfg, positions, window=window,
        cache=None if cache is None else cache["attn"], cur_pos=cur_pos,
        decode_positions=decode_positions, paged=paged, mean_pads=mean_pads)
    if cfg.post_norm:
        y = rms_norm(y, lp["norm1b"], cfg.norm_eps)
    x = x + y
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    y = None if ffn == "moe" else mlp_layer(lp["mlp"], h)
    if ffn != "dense":
        ym, aux = moe_layer(lp["moe"], h, cfg)
        y = ym if y is None else y + ym
    if cfg.post_norm:
        y = rms_norm(y, lp["norm2b"], cfg.norm_eps)
    return x + y, {"attn": new_cache}, aux


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


def forward_stack(params_stack, x, cfg, *, positions=None, cache=None,
                  cur_pos=None, collect_cache=False, decode_positions=None,
                  paged=None):
    """Run the layer stack (the reference's scan is a loop over layer
    slices). Returns (x, cache, aux): ``aux`` the router losses summed
    over layers (f32 scalar, 0 without MoE).

    * loss: ``positions`` only; returns (x, None, aux).
    * prefill: ``collect_cache=True``; returns each slot's roped
      {"k", "v"} stacked to (n_periods, B, S, KV, d).
    * ring decode: ``cache`` (the ``layers`` subtree of ``Model.init_cache``)
      with ``cur_pos`` and ``decode_positions``; each layer writes its ring
      slice in place and ``cache`` is returned.
    * paged: ``cache`` = the pools' ``layers`` subtree and ``paged``; each
      layer writes its slice of the stacked pools in place.

    Each layer's window is a Python int from ``_window_array``: constant
    per layer, so a captured CUDA graph holds it as it holds a shape."""
    _require_attention_stack(cfg)
    plan = layer_plan(cfg, "dec")
    wins = _window_array(cfg, "dec")
    mean_pads = paged is not None and _pads_reach_tokens(
        cfg, plan, x.shape[0] * x.shape[1])
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    collected = {f"s{slot}": [] for slot in range(len(plan))}
    for period in range(n_periods(cfg)):
        for slot, (_mixer, ffn) in enumerate(plan):
            name = f"s{slot}"
            lp = map_tensors(lambda t: t[period], params_stack[name])
            layer_cache = (None if cache is None else
                           map_tensors(lambda t: t[period], cache[name]))
            x, nc, a = _block(x, lp, cfg, ffn, window=wins[period][slot],
                              positions=positions, cur_pos=cur_pos,
                              cache=layer_cache,
                              decode_positions=decode_positions, paged=paged,
                              mean_pads=mean_pads)
            if a is not None:
                aux = aux + a
            if collect_cache:
                collected[name].append(nc["attn"])
    if collect_cache:
        cache = {name: {"attn": {k: torch.stack([c[k] for c in cs])
                                 for k in ("k", "v")}}
                 for name, cs in collected.items()}
    return x, cache, aux
