"""Layer plan, parameter declarations and the layer stack (dense stacks).

Port of ``repro.models.transformer`` for dense decoders. Per-layer params
are stacked along a leading ``L`` dim (one subtree per period slot, as in
the reference); the reference's ``lax.scan`` over that dim is a Python loop
over layer slices here.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..core.quantize import map_tensors
from ..device import resolve_device
from .layers import attention_layer, mlp_layer, rms_norm


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


def _require_dense(cfg):
    """The port runs dense RoPE decoders without qkv bias, sliding window
    or post-norm (internlm2, granite); ROADMAP item 10 brings the rest."""
    if (cfg.is_encdec or cfg.frontend != "none" or not cfg.use_rope
            or cfg.qkv_bias or cfg.sliding_window or cfg.post_norm
            or any(mixer != "attn" or ffn != "dense"
                   for mixer, ffn in layer_plan(cfg, "dec"))):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense RoPE decoders only (ROADMAP "
            "item 10 brings MoE, hybrid, xlstm, enc-dec, VLM, qkv bias, "
            "sliding windows and post-norm)")


def param_defs(cfg):
    """path -> (shape, init_kind), as the reference declares them."""
    _require_dense(cfg)
    d, vp = cfg.d_model, cfg.vocab_padded
    h, kv, hd, f = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_, cfg.d_ff
    defs = {"embed": ((vp, d), "embed"), "final_norm": ((d,), "zero")}
    if not cfg.tie_embeddings:
        defs["unembed"] = ((vp, d), "fan_out")
    p = "dec/s0"
    defs.update({
        f"{p}/norm1": ((d,), "zero"),
        f"{p}/attn/wq": ((d, h * hd), "fan_in"),
        f"{p}/attn/wk": ((d, kv * hd), "fan_in"),
        f"{p}/attn/wv": ((d, kv * hd), "fan_in"),
        f"{p}/attn/wo": ((h * hd, d), "fan_out"),
        f"{p}/norm2": ((d,), "zero"),
        f"{p}/mlp/wg": ((d, f), "fan_in"),
        f"{p}/mlp/wi": ((d, f), "fan_in"),
        f"{p}/mlp/wo": ((f, d), "fan_out"),
    })
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


def _block(x, lp, cfg, *, positions, cur_pos, cache, decode_positions,
           paged):
    """One attention + dense-MLP residual block. Returns (x, new_cache)."""
    h = rms_norm(x, lp["norm1"], cfg.norm_eps)
    y, new_cache = attention_layer(
        lp["attn"], h, cfg, positions,
        cache=None if cache is None else cache["attn"], cur_pos=cur_pos,
        decode_positions=decode_positions, paged=paged)
    x = x + y
    h = rms_norm(x, lp["norm2"], cfg.norm_eps)
    return x + mlp_layer(lp["mlp"], h), {"attn": new_cache}


def forward_stack(params_stack, x, cfg, *, positions=None, cache=None,
                  cur_pos=None, collect_cache=False, decode_positions=None,
                  paged=None):
    """Run the layer stack (the reference's scan is a loop over layer
    slices). Returns (x, cache).

    * loss: ``positions`` only; returns (x, None).
    * prefill: ``collect_cache=True``; returns each slot's roped
      {"k", "v"} stacked to (n_periods, B, S, KV, d).
    * ring decode: ``cache`` (the ``layers`` subtree of ``Model.init_cache``)
      with ``cur_pos`` and ``decode_positions``; each layer writes its ring
      slice in place and ``cache`` is returned.
    * paged: ``cache`` = the pools' ``layers`` subtree and ``paged``; each
      layer writes its slice of the stacked pools in place."""
    _require_dense(cfg)
    collected = []
    for period in range(n_periods(cfg)):
        lp = map_tensors(lambda t: t[period], params_stack["s0"])
        layer_cache = (None if cache is None
                       else map_tensors(lambda t: t[period], cache["s0"]))
        x, nc = _block(x, lp, cfg, positions=positions, cur_pos=cur_pos,
                       cache=layer_cache, decode_positions=decode_positions,
                       paged=paged)
        if collect_cache:
            collected.append(nc["attn"])
    if collect_cache:
        cache = {"s0": {"attn": {
            name: torch.stack([c[name] for c in collected])
            for name in ("k", "v")}}}
    return x, cache
