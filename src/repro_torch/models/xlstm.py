"""xLSTM blocks (sLSTM + mLSTM, Beck et al. 2024) for the xlstm-125m arch.

Port of ``repro.models.xlstm``: both blocks are their exact stabilized
recurrences, a step per position. The reference runs them as a
``lax.scan`` of checkpointed chunk scans (``_chunked_time_scan``); the
chunking bounds its saved residuals and changes no number, so its port is
a plain loop over time, chunked and rematerialized under autograd only. The recurrences are plain PyTorch on every
device: in the reference they are jnp ops, not Pallas kernels (ROADMAP §2
notes an mLSTM kernel as possible work). The state is small: no KV cache,
O(H * dh^2) a layer.

Stack layout: alternating sLSTM / mLSTM (period 2), no FFN (d_ff = 0):
each block has its own up/down projections.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import dense, grad_on, remat

_M0 = -1e30                   # the stabilizer's initial value


def _scan_steps(step, state, xs):
    ys = []
    for t in range(xs[0].shape[0]):
        state, y = step(state, tuple(x[t] for x in xs))
        ys.append(y)
    return state, torch.stack(ys)


def _time_scan(step, state, xs, chunk=256):
    """``step(state, inputs_t) -> (state, y_t)`` over the leading (time)
    axis of each of ``xs``. Returns (state, ys stacked on dim 0). Under
    autograd the time axis runs in chunks of ``chunk`` steps (shrunk until
    it divides S), each rematerialized, so the backward keeps per-chunk
    states only: the reference's ``_chunked_time_scan``."""
    s = xs[0].shape[0]
    if not grad_on(*xs, *state):
        return _scan_steps(step, state, xs)
    ck = min(chunk, s)
    while s % ck:
        ck -= 1
    ys = []
    for t0 in range(0, s, ck):
        state, y = remat(lambda st, *xc: _scan_steps(step, st, xc), state,
                         *(x[t0:t0 + ck] for x in xs))
        ys.append(y)
    return state, torch.cat(ys)


# ---------------------------------------------------------------------------
# mLSTM: matrix memory C (B,H,dh,dh) with exponential gating
# ---------------------------------------------------------------------------

def _mlstm_step(state, inp):
    c, nrm, m = state                       # (B,H,d,d), (B,H,d), (B,H)
    q, k, v, logf, logi = inp               # (B,H,d) x3, (B,H), (B,H)
    m_new = torch.maximum(logf + m, logi)
    f = torch.exp(logf + m - m_new)[..., None]
    i = torch.exp(logi - m_new)[..., None]
    c = f[..., None] * c + i[..., None] * (v[..., :, None] * k[..., None, :])
    nrm = f * nrm + i * k
    h_num = torch.einsum("bhvk,bhk->bhv", c, q)
    h_den = torch.abs(torch.einsum("bhk,bhk->bh", nrm, q))
    h = h_num / torch.maximum(h_den, torch.exp(-m_new))[..., None]
    return (c, nrm, m_new), h


def mlstm_layer(p, x, cfg, cache=None):
    """x (B, S, D) -> (B, S, D), and the state {"c" (B, H, dh, dh), "n"
    (B, H, dh), "m" (B, H)}, all f32; ``cache`` is the state to start
    from (zeros and m = -1e30 when None)."""
    b, s, _ = x.shape
    h_, dh = cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    q = dense(x, p["wq"]).reshape(b, s, h_, dh)
    k = dense(x, p["wk"]).reshape(b, s, h_, dh) * (dh ** -0.5)
    v = dense(x, p["wv"]).reshape(b, s, h_, dh)
    gates = dense(x, p["w_gates"]).to(f32)               # (B, S, 2H)
    logf = F.logsigmoid(gates[..., :h_] + p["f_bias"].to(f32))
    logi = gates[..., h_:]
    o = torch.sigmoid(dense(x, p["w_o_gate"]).to(f32))

    if cache is None:
        c0 = torch.zeros((b, h_, dh, dh), dtype=f32, device=x.device)
        n0 = torch.zeros((b, h_, dh), dtype=f32, device=x.device)
        m0 = torch.full((b, h_), _M0, dtype=f32, device=x.device)
    else:
        c0, n0, m0 = cache["c"], cache["n"], cache["m"]
    xs = tuple(t.transpose(0, 1).to(f32) for t in (q, k, v, logf, logi))
    (c, n, m), hs = _time_scan(_mlstm_step, (c0, n0, m0), xs)
    hs = hs.transpose(0, 1)                              # (B, S, H, dh)
    out = (hs.reshape(b, s, h_ * dh) * o).to(x.dtype)
    return dense(out, p["w_out"]), {"c": c, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM: scalar memory with block-diagonal (per-head) recurrence
# ---------------------------------------------------------------------------

def _slstm_step(rw, state, inp):
    c, n, m, h_prev = state                 # (B,H,d) each
    zx, ix, fx, ox = inp                    # (B,H,d) each
    rec = torch.einsum("bhd,hde->bhe", h_prev, rw)
    z = torch.tanh(zx + rec)
    logi = ix + rec
    logf = F.logsigmoid(fx + rec)
    m_new = torch.maximum(logf + m, logi)
    i = torch.exp(logi - m_new)
    f = torch.exp(logf + m - m_new)
    c = f * c + i * z
    n = f * n + i
    h = torch.sigmoid(ox) * c / torch.clamp(n, min=1e-6)
    return (c, n, m_new, h), h


def slstm_layer(p, x, cfg, cache=None):
    """x (B, S, D) -> (B, S, D), and the state {"c", "n", "m", "h"} (B,
    H, dh) f32; ``cache`` is the state to start from (zeros and m =
    -1e30 when None)."""
    b, s, _ = x.shape
    h_, dh = cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    pre = dense(x, p["w_in"]).to(f32)                    # (B, S, 4*H*dh)
    zx, ix, fx, ox = [t.reshape(b, s, h_, dh)
                      for t in torch.chunk(pre, 4, dim=-1)]
    if cache is None:
        zeros = torch.zeros((b, h_, dh), dtype=f32, device=x.device)
        state = (zeros, zeros, torch.full((b, h_, dh), _M0, dtype=f32,
                                          device=x.device), zeros)
    else:
        state = (cache["c"], cache["n"], cache["m"], cache["h"])
    rw = p["w_rec"].to(f32)                              # (H, dh, dh)
    xs = tuple(t.transpose(0, 1) for t in (zx, ix, fx, ox))
    state, hs = _time_scan(lambda st, inp: _slstm_step(rw, st, inp), state,
                           xs)
    hs = hs.transpose(0, 1).reshape(b, s, h_ * dh).to(x.dtype)
    out = dense(hs, p["w_out"])
    return out, {"c": state[0], "n": state[1], "m": state[2], "h": state[3]}


def xlstm_param_defs(cfg, prefix, kind):
    """path -> (shape, logical axes, init kind) of an ``kind`` ("mlstm"
    | "slstm") block, as the reference declares them."""
    d, h_, dh = cfg.d_model, cfg.n_heads, cfg.head_dim
    hd = h_ * dh
    if kind == "mlstm":
        return {
            f"{prefix}/wq": ((d, hd), ("embed", "heads"), "fan_in"),
            f"{prefix}/wk": ((d, hd), ("embed", "heads"), "fan_in"),
            f"{prefix}/wv": ((d, hd), ("embed", "heads"), "fan_in"),
            f"{prefix}/w_gates": ((d, 2 * h_), ("embed", None), "fan_in"),
            f"{prefix}/f_bias": ((h_,), (None,), "f_bias"),
            f"{prefix}/w_o_gate": ((d, hd), ("embed", "heads"), "fan_in"),
            f"{prefix}/w_out": ((hd, d), ("heads", "embed"), "fan_in"),
        }
    return {
        f"{prefix}/w_in": ((d, 4 * hd), ("embed", "heads"), "fan_in"),
        f"{prefix}/w_rec": ((h_, dh, dh), (None, None, None), "orth"),
        f"{prefix}/w_out": ((hd, d), ("heads", "embed"), "fan_in"),
    }


def xlstm_cache_shapes(cfg, batch, kind):
    h_, dh = cfg.n_heads, cfg.head_dim
    f32 = torch.float32
    if kind == "mlstm":
        return {"c": ((batch, h_, dh, dh), f32),
                "n": ((batch, h_, dh), f32),
                "m": ((batch, h_), f32)}
    return {"c": ((batch, h_, dh), f32),
            "n": ((batch, h_, dh), f32),
            "m": ((batch, h_, dh), f32),
            "h": ((batch, h_, dh), f32)}
