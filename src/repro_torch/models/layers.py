"""Transformer building blocks (plain functions, params as dicts).

Port of ``repro.models.layers`` for the dense decoder's paged serving path:
norms and RoPE in f32, projections through ``dense`` (the msb_matmul kernel
for packed weights), and the paged branches of ``attention_layer`` over
kv16 and quantized (kv_bits 8|4) pools.
"""
from __future__ import annotations

import torch

from ..core.quantize import PackedQTensor, QTensor
from ..kernels.msb_matmul.ops import packed_matmul
from .attention import (paged_attention, paged_attention_packed,
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


def dense(x, w, b=None):
    """y = x @ w (+ b), dispatching on the weight representation: packed
    weights run the msb_matmul kernel (bias fused), QTensors dequantize,
    plain tensors multiply as they are."""
    if isinstance(w, PackedQTensor):
        return packed_matmul(x, w, bias=b)
    if isinstance(w, QTensor):
        w = w.dequantize()
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def attention_layer(p, x, cfg, *, cache, paged):
    """Paged self-attention. ``paged`` = dict(block_tables, q_pos, kv_lens
    [, seg_ids][, slots, seg_off, kv_bits]); ``cache`` = this layer's
    pools, written in place: {"k", "v"} at kv16, or the quantized dual
    pools {"k_codes", "v_codes", "k_scales", "v_scales", "k_hot", "v_hot"}
    (hot-row write, commit-time quantization, fused-dequant attention).
    With ``seg_ids`` the (1, T) row is a packed ragged prefill: per-token
    segment ids route every write and read to the token's own block-table
    row. Returns (out, cache)."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    b = x.shape[0]
    q = dense(x, p["wq"], p.get("bq")).reshape(b, -1, h, hd)
    k = dense(x, p["wk"], p.get("bk")).reshape(b, -1, kv, hd)
    v = dense(x, p["wv"], p.get("bv")).reshape(b, -1, kv, hd)
    softcap = cfg.attn_softcap
    scale = hd ** -0.5 if cfg.query_scale == 0 else cfg.query_scale
    q_pos = paged["q_pos"]
    safe_pos = torch.clamp(q_pos, min=0)
    q = rope(q, safe_pos, cfg.rope_theta)
    k = rope(k, safe_pos, cfg.rope_theta)
    seg_ids = paged.get("seg_ids")
    t = q.shape[1]
    if "k_codes" in cache:
        kv_bits = paged["kv_bits"]
        if seg_ids is not None:
            cache = paged_write_quant_packed(
                cache, k, v, paged["block_tables"], seg_ids, q_pos,
                paged["kv_lens"], paged["slots"], paged["seg_off"], kv_bits)
            out = paged_attention_quant_packed(
                q, cache, paged["block_tables"], seg_ids, q_pos,
                paged["kv_lens"], paged["slots"], kv_bits, softcap=softcap,
                scale=scale)
        else:
            cache = paged_write_quant(
                cache, k, v, paged["block_tables"], q_pos, paged["kv_lens"],
                paged["slots"], kv_bits)
            out = paged_attention_quant(
                q, cache, paged["block_tables"], q_pos, paged["kv_lens"],
                paged["slots"], kv_bits, softcap=softcap, scale=scale)
        return dense(out.reshape(b, t, -1), p["wo"]), cache
    if seg_ids is not None:
        k_pool, v_pool = paged_write_packed(
            cache["k"], cache["v"], k, v, paged["block_tables"], seg_ids,
            q_pos)
        out = paged_attention_packed(
            q, k_pool, v_pool, paged["block_tables"], seg_ids, q_pos,
            paged["kv_lens"], softcap=softcap, scale=scale)
    else:
        k_pool, v_pool = paged_write(cache["k"], cache["v"], k, v,
                                     paged["block_tables"], q_pos)
        out = paged_attention(q, k_pool, v_pool, paged["block_tables"],
                              q_pos, paged["kv_lens"], softcap=softcap,
                              scale=scale)
    return dense(out.reshape(b, t, -1), p["wo"]), {"k": k_pool, "v": v_pool}


def mlp_layer(p, x):
    """SwiGLU MLP."""
    gate = torch.nn.functional.silu(
        dense(x, p["wg"]).to(torch.float32)).to(x.dtype)
    up = dense(x, p["wi"])
    return dense(gate * up, p["wo"])
