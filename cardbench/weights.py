"""Raw weights from a seed, on the device, in the port's parameter layout.

The layout is the port's decoder stack with every layer stacked along a
leading dim: ``embed`` (V_padded, D), ``final_norm`` (D,), the untied
``unembed`` (V_padded, D), and under ``dec/s0``: ``norm1``/``norm2``
(L, D), ``attn/wq`` (L, D, H * hd), ``attn/wk``/``wv`` (L, D, KV * hd),
``attn/wo`` (L, H * hd, D), then ``mlp/wg``/``wi`` (L, D, F) and
``mlp/wo`` (L, F, D), or ``moe/router`` (L, D, E_padded) and
``moe/wg``/``wi`` (L, E_padded, D, F), ``moe/wo`` (L, E_padded, F, D).

Every random leaf is a slice of one f32 buffer filled by one call of a
``torch.Generator`` on the device, scaled in place: an untied embedding
N(0, 1), every projection (the unembedding and the router too) N(0,
1 / fan_in), a tied table N(0, 1 / D) (at N(0, 1) its own row would
outweigh every other logit by some |e|^2 / sqrt(D), so every precision
would serve the same tokens), norms 0 (a scale of 1), padded experts 0.
The same seed gives the same tensors on the same card.
"""
from __future__ import annotations

import math


def vocab_padded(cfg):
    r = cfg["port"].get("vocab_round", 256)
    return -(-cfg["vocab_size"] // r) * r


def experts_padded(cfg):
    e = cfg.get("num_local_experts", 0)
    return -(-e // 16) * 16 if e % 16 else e


def layout(cfg):
    """path -> (shape, init, fan_in) for every leaf, in a fixed order."""
    d, f = cfg["hidden_size"], cfg["intermediate_size"]
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    L, vp = cfg["num_hidden_layers"], vocab_padded(cfg)
    tied = cfg["tie_word_embeddings"]
    out = {"embed": ((vp, d), "normal", d if tied else 1),
           "final_norm": ((d,), "zero", 0)}
    if not tied:
        out["unembed"] = ((vp, d), "normal", d)
    s = "dec/s0/"
    out.update({
        s + "norm1": ((L, d), "zero", 0),
        s + "attn/wq": ((L, d, h * hd), "normal", d),
        s + "attn/wk": ((L, d, kv * hd), "normal", d),
        s + "attn/wv": ((L, d, kv * hd), "normal", d),
        s + "attn/wo": ((L, h * hd, d), "normal", h * hd),
        s + "norm2": ((L, d), "zero", 0),
    })
    if cfg.get("num_local_experts"):
        e = experts_padded(cfg)
        out.update({
            s + "moe/router": ((L, d, e), "normal", d),
            s + "moe/wg": ((L, e, d, f), "experts", d),
            s + "moe/wi": ((L, e, d, f), "experts", d),
            s + "moe/wo": ((L, e, f, d), "experts", f),
        })
    else:
        out.update({
            s + "mlp/wg": ((L, d, f), "normal", d),
            s + "mlp/wi": ((L, d, f), "normal", d),
            s + "mlp/wo": ((L, f, d), "normal", f),
        })
    return out


def make(torch, cfg, seed, device):
    """{path: f32 tensor} on ``device`` drawn from ``seed``."""
    lay = layout(cfg)
    total = sum(math.prod(shape) for shape, kind, _ in lay.values()
                if kind != "zero")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    n_real = cfg.get("num_local_experts", 0)
    out, off = {}, 0
    for path, (shape, kind, fan_in) in lay.items():
        if kind == "zero":
            out[path] = torch.zeros(shape, dtype=torch.float32, device=device)
            continue
        n = math.prod(shape)
        t = flat[off:off + n].view(shape)
        off += n
        if fan_in > 1:
            t.mul_(1.0 / math.sqrt(fan_in))
        if kind == "experts":
            t[:, n_real:].zero_()
        out[path] = t
    return out


def nest(flat):
    """{"a/b/c": t} -> {"a": {"b": {"c": t}}}."""
    tree = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree
