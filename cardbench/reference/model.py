"""Plain f32 reference of the served decoder stacks (dense and MoE).

Pre-norm decoder: RMSNorm with scale ``1 + w``, GQA attention with
rotary embeddings (half-rotation, ``theta ** (-i / (d / 2))``), causal;
SwiGLU MLP, or a top-k MoE over the real experts (softmax over experts,
top-k renormalised, no capacity: every choice is kept); final RMSNorm
and the unembedding. It follows the configuration file's keys as run
(``hidden_size``, ``num_attention_heads``, ``rms_norm_eps``, ...),
takes weights as dense f32 matrices in (in, out) orientation under the
port's layer layout (``dec/s0/attn/wq`` (L, D, H * hd), ...), and runs
one sequence at a time, layer by layer, with attention in blocks of
queries. TF32 is switched off for its products.

``fp8=True`` is the lower-precision control, the reference computed in
float8 e4m3 where the program computes in bf16: each product's operands
are rounded to it (a scale per row of the activations and per output
column of the weights) before an f32 product, and so is the residual
stream wherever it is stored (after the embedding and each residual
add, a scale per row).
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0


def _qdq(x, dim):
    """x rounded to float8 e4m3 with one absmax scale along ``dim``."""
    s = torch.clamp(x.abs().amax(dim=dim, keepdim=True), min=1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def mm(x, w, fp8=False):
    if fp8:
        return _qdq(x, -1) @ _qdq(w, -2)
    return x @ w


def rms_norm(x, w, eps):
    return x * torch.rsqrt(torch.mean(x * x, -1, keepdim=True) + eps) * (1.0 + w)


def rope(x, pos, theta):
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = pos[:, None].to(torch.float32) * freqs
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def attention(q, k, v, scale, fp8=False, block=1024):
    """Causal GQA. q (S, H, d), k/v (S, KV, d) -> (S, H, d)."""
    s, h, d = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).transpose(0, 1)      # (H, S, d)
    v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    for i in range(0, s, block):
        qb = q[i:i + block].transpose(0, 1)                  # (H, b, d)
        kk, vv = k[:, :i + qb.shape[1]], v[:, :i + qb.shape[1]]
        sc = mm(qb, kk.transpose(1, 2), fp8) * scale
        qpos = torch.arange(i, i + qb.shape[1], device=q.device)
        kpos = torch.arange(kk.shape[1], device=q.device)
        sc = sc.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
        out[i:i + block] = mm(torch.softmax(sc, -1), vv, fp8).transpose(0, 1)
    return out


def _moe(h, W, l, cfg, fp8):
    n_real = cfg["num_local_experts"]
    k = cfg["num_experts_per_tok"]
    logits = h @ W["dec/s0/moe/router"][l][:, :n_real]
    probs = torch.softmax(logits, -1)
    gates, eidx = torch.topk(probs, k, -1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    y = torch.zeros_like(h)
    for e in torch.unique(eidx).tolist():
        rows, slot = torch.nonzero(eidx == e, as_tuple=True)
        xe = h[rows]
        g = mm(xe, W["dec/s0/moe/wg"][l, e], fp8)
        u = mm(xe, W["dec/s0/moe/wi"][l, e], fp8)
        ye = mm(torch.nn.functional.silu(g) * u, W["dec/s0/moe/wo"][l, e], fp8)
        y.index_add_(0, rows, ye * gates[rows, slot][:, None])
    return y


def hidden_states(W, cfg, tokens, fp8=False):
    """Final-normed hidden states (S, D) f32 of one token sequence."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = cfg["hidden_size"]
    h_n, kv_n = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h_n
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    scale = cfg.get("attention_multiplier", hd ** -0.5)
    moe = "num_local_experts" in cfg
    tokens = tokens.to(torch.int64)
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = W["embed"][tokens] * cfg.get("embedding_multiplier", 1.0)
    store = (lambda t: _qdq(t, -1)) if fp8 else (lambda t: t)
    x = store(x)
    for l in range(cfg["num_hidden_layers"]):
        h = rms_norm(x, W["dec/s0/norm1"][l], eps)
        q = mm(h, W["dec/s0/attn/wq"][l], fp8).reshape(-1, h_n, hd)
        k = mm(h, W["dec/s0/attn/wk"][l], fp8).reshape(-1, kv_n, hd)
        v = mm(h, W["dec/s0/attn/wv"][l], fp8).reshape(-1, kv_n, hd)
        o = attention(rope(q, pos, theta), rope(k, pos, theta), v, scale,
                      fp8)
        x = store(x + mm(o.reshape(-1, h_n * hd), W["dec/s0/attn/wo"][l],
                         fp8))
        h = rms_norm(x, W["dec/s0/norm2"][l], eps)
        if moe:
            x = store(x + _moe(h, W, l, cfg, fp8))
        else:
            g = mm(h, W["dec/s0/mlp/wg"][l], fp8)
            u = mm(h, W["dec/s0/mlp/wi"][l], fp8)
            x = store(x + mm(torch.nn.functional.silu(g) * u,
                             W["dec/s0/mlp/wo"][l], fp8))
    return rms_norm(x, W["final_norm"], eps)


def unembed_dv(W, cfg):
    """The unembedding as (D, V_padded): the untied table, else the
    embedding's transpose."""
    return W["embed"].t() if cfg["tie_word_embeddings"] else W["unembed_dv"]


def logits(W, cfg, hidden, fp8=False, chunk=1024):
    """(S, V_padded) f32 logits; rows past ``vocab_size`` are -inf."""
    w = unembed_dv(W, cfg)
    out = torch.cat([mm(hidden[i:i + chunk], w, fp8)
                     for i in range(0, hidden.shape[0], chunk)])
    out = out / cfg.get("logits_scaling", 1.0)
    out[:, cfg["vocab_size"]:] = float("-inf")
    return out


def gaps(ref_logits, chosen):
    """How far each chosen token's logit lies below the row's best."""
    best = ref_logits.max(-1).values
    return best - torch.gather(ref_logits, -1, chosen[:, None].to(
        torch.int64))[:, 0]


def widest_gap(W, cfg, prompt, served, control=False):
    """Widest gap over the served tokens of one request: the reference
    runs once over prompt + served tokens; position i of the answer is
    predicted from everything before it. With ``control``, also the
    widest gap of the tokens the fp8 control puts first at the same
    positions. Returns (gap, control_gap or None)."""
    seq = torch.cat([prompt, served])
    p = prompt.shape[0]
    hid = hidden_states(W, cfg, seq[:-1])[p - 1:]
    ref = logits(W, cfg, hid)
    gap = float(gaps(ref, served).max())
    cgap = None
    if control:
        chid = hidden_states(W, cfg, seq[:-1], fp8=True)[p - 1:]
        ctl = logits(W, cfg, chid, fp8=True)
        cgap = float(gaps(ref, ctl.argmax(-1)).max())
    return gap, cgap
