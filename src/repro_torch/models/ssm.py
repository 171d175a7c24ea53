"""Mamba (S6 selective state-space) block for the jamba hybrid.

Port of ``repro.models.ssm``. Prefill and the loss run the chunked
sequential scan (``ck`` steps of the (B, ck, C, N) discretized tensors at
a time, ``ck`` shrunk until it divides S, as the reference chooses it);
decode carries {conv, ssm} state and runs the single-step recurrence.
Under autograd each scan chunk is rematerialized, as the reference's
checkpointed chunk body.
The recurrence is plain PyTorch on every device: in the reference it is a
``lax.scan`` over jnp ops, not a Pallas kernel (ROADMAP §2 notes a fused
selective-scan kernel as possible work). Projections go through ``dense``
(kernel A for packed weights); ``x_proj`` and ``dt_proj`` at widths the
quantization policy skips multiply with ``torch.matmul``.

Under a ``ParallelContext`` the inner channels shard over ``model`` (the
reference's ``mlp`` anchoring of ``xi`` and ``z``): a rank runs the scan
on its ``d_inner / tp`` channels, ``x_proj`` is row-parallel (its dt/B/C
summed over the ranks) and ``out_proj`` gives a partial sum
(``spmd_mamba``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import sharding as shd
from .layers import dense, grad_on, remat


def _causal_conv1d(x, w, state=None):
    """Depthwise causal conv. x: (B, S, C), w: (K, C); ``state`` (B, K-1,
    C) the previous inputs (zeros when None). Returns (y, new_state): y in
    the promoted type of x and w, as the reference's products give it."""
    k = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * w[0][None, None, :]
    for t in range(1, k):
        y = y + xp[:, t:t + s] * w[t][None, None, :]
    new_state = xp[:, -(k - 1):] if k > 1 else torch.zeros_like(pad)
    return y, new_state


def _ssm_scan(delta_a, delta_bx, h0=None):
    """h_t = delta_a_t * h_{t-1} + delta_bx_t over S, as the reference's
    associative scan defines it (a test oracle; the layer runs the chunked
    sequential form). delta_a/delta_bx: (B, S, C, N). Returns (all h, h
    at the last step)."""
    if h0 is not None:
        delta_bx = delta_bx.clone()
        delta_bx[:, 0] += delta_a[:, 0] * h0
    h = delta_bx[:, 0]
    hs = [h]
    for t in range(1, delta_a.shape[1]):
        h = delta_a[:, t] * h + delta_bx[:, t]
        hs.append(h)
    hs = torch.stack(hs, dim=1)
    return hs, hs[:, -1]


def _ssm_scan_seq(delta_a, delta_bx, h0):
    """The sequential recurrence over one chunk's steps: (B, ck, C, N)
    inputs, h0 (B, C, N). Returns (h at every step, h at the last); no
    in-place write, so autograd runs through it."""
    hs = []
    h = h0
    for t in range(delta_a.shape[1]):
        h = delta_a[:, t] * h + delta_bx[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def _scan_chunk(h, dtc, xic, bc, cc, a, dtype):
    """One chunk of the selective scan from state ``h``: the discretized
    (B, ck, C, N) tensors, the recurrence and the chunk's output in
    ``dtype``. Returns (h at the chunk's end, y (B, ck, C))."""
    dtf = dtc.to(torch.float32)
    delta_a = torch.exp(dtf[..., None] * a[None, None])
    delta_bx = (dtf * xic.to(torch.float32))[..., None] \
        * bc.to(torch.float32)[:, :, None, :]
    hs, h = _ssm_scan_seq(delta_a, delta_bx, h)
    yc = torch.einsum("bscn,bsn->bsc", hs, cc.to(torch.float32))
    return h, yc.to(dtype)


def _chunk(s, chunk):
    ck = min(chunk, s)
    while s % ck:
        ck -= 1
    return ck


def mamba_layer(p, x, cfg, cache=None, parallel=None, gbatch=None):
    """x: (B, S, D) -> (B, S, D), and the recurrent state {"conv" (B, K-1,
    d_inner) in x's type, "ssm" (B, d_inner, N) f32}. ``cache`` (decode)
    is that state; S == 1 with a cache runs the single-step branch.
    ``parallel`` (a rank's ``ParallelContext``): ``p`` holds the rank's
    channels, ``x`` the whole sequence of its batch rows; the output is
    the rank's partial sum of ``out_proj``, and ``gbatch`` the global
    batch (default: ``x``'s rows cut over the data axes)."""
    b, s, _ = x.shape
    n, r = cfg.mamba_d_state, cfg.mamba_dt_rank
    f32 = torch.float32
    xi = dense(x, p["in_proj_x"])                        # (B, S, d_in)
    z = dense(x, p["in_proj_z"])
    if parallel is not None:
        glob = (gbatch or b * parallel.dp_size, s, cfg.mamba_d_inner)
        xi = shd.constraint(xi, ("batch", None, "mlp"), parallel, glob)
        z = shd.constraint(z, ("batch", None, "mlp"), parallel, glob)
    xi, new_conv = _causal_conv1d(xi, p["conv_w"],
                                  None if cache is None else cache["conv"])
    xi = F.silu(xi.to(f32)).to(x.dtype)
    proj = dense(xi, p["x_proj"])                        # (B, S, r + 2N)
    if parallel is not None:     # row-parallel: summed, then every rank's
        axis = parallel.tp_axis  # channels read it
        proj = shd.pvary(shd.psum(proj, parallel, axis), parallel, axis)
    dt_low, bmat, cmat = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    dt = F.softplus(dense(dt_low, p["dt_proj"]).to(f32)
                    + p["dt_bias"].to(f32))              # (B, S, d_in) f32
    a = -torch.exp(p["a_log"].to(f32))                   # (d_in, N)

    if cache is not None and s == 1:                     # single-step decode
        delta_a = torch.exp(dt[:, 0, :, None] * a[None])
        delta_bx = (dt[:, 0] * xi[:, 0].to(f32))[..., None] \
            * bmat[:, 0].to(f32)[:, None, :]
        h_last = delta_a * cache["ssm"] + delta_bx
        y = torch.einsum("bcn,bn->bc", h_last, cmat[:, 0].to(f32))[:, None]
    else:
        # one chunk of the discretized (B, ck, C, N) tensors at a time;
        # dt, the chunk outputs and the inputs pass through cfg.dtype, as
        # the reference streams them; under autograd each chunk is
        # rematerialized, as the reference's checkpointed chunk body
        h_last = (cache["ssm"] if cache is not None else
                  torch.zeros((b, xi.shape[-1], n), dtype=f32,
                              device=x.device))
        ck = _chunk(s, cfg.mamba_chunk)
        dt_c = dt.to(cfg.dtype)
        on = grad_on(dt_c, xi, bmat, cmat, a)
        ys = []
        for i in range(0, s, ck):
            h_last, yc = remat(_scan_chunk, h_last, dt_c[:, i:i + ck],
                               xi[:, i:i + ck], bmat[:, i:i + ck],
                               cmat[:, i:i + ck], a, cfg.dtype, on=on)
            ys.append(yc)
        y = torch.cat(ys, dim=1).to(f32)

    y = y + p["d_skip"].to(f32)[None, None] * xi.to(f32)
    y = y.to(x.dtype) * F.silu(z.to(f32)).to(x.dtype)
    out = dense(y, p["out_proj"])
    return out, {"conv": new_conv, "ssm": h_last}


def mamba_param_defs(cfg, prefix):
    """path -> (shape, logical axes, init kind), as the reference
    declares them."""
    d, d_in = cfg.d_model, cfg.mamba_d_inner
    n, k, r = cfg.mamba_d_state, cfg.mamba_d_conv, cfg.mamba_dt_rank
    return {
        f"{prefix}/in_proj_x": ((d, d_in), ("embed", "mlp"), "fan_in"),
        f"{prefix}/in_proj_z": ((d, d_in), ("embed", "mlp"), "fan_in"),
        f"{prefix}/conv_w": ((k, d_in), (None, "mlp"), "one"),
        f"{prefix}/x_proj": ((d_in, r + 2 * n), ("mlp", None), "fan_in"),
        f"{prefix}/dt_proj": ((r, d_in), (None, "mlp"), "fan_in"),
        f"{prefix}/dt_bias": ((d_in,), ("mlp",), "dt_bias"),
        f"{prefix}/a_log": ((d_in, n), ("mlp", None), "a_log"),
        f"{prefix}/d_skip": ((d_in,), ("mlp",), "one"),
        f"{prefix}/out_proj": ((d_in, d), ("mlp", "embed"), "fan_in"),
    }


def mamba_cache_shapes(cfg, batch):
    d_in, n, k = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {"conv": ((batch, k - 1, d_in), cfg.dtype),
            "ssm": ((batch, d_in, n), torch.float32)}


_MLP_DIMS = {"in_proj_x": 1, "in_proj_z": 1, "conv_w": 1, "x_proj": 0,
             "dt_proj": 1, "dt_bias": 0, "a_log": 0, "d_skip": 0,
             "out_proj": 0}


def spmd_mamba(p, ps, h, cfg, sm, cache=None, cache_specs=None):
    """The mamba mixer under a block's ``Spmd`` ``sm``: on the rank's
    inner channels when ``model`` shards them, else the whole layer alike
    on every ``model`` rank. Returns the output in the stream's layout;
    with ``cache_specs`` (serving: the {"conv", "ssm"} state's specs
    without the periods dim) also the new state in that layout, and
    ``cache`` (decode) is the rank's block of the state before the step."""
    ctx, bsp = sm.ctx, sm.bspec
    sharded = sm.tp > 1 and all(sm.sharded(ps[k], d)
                                for k, d in _MLP_DIMS.items())
    ch = sm.axis if sharded else None
    lay = {"conv": (bsp, None, ch), "ssm": (bsp, ch)}

    def moved(state, src, dst):
        return None if state is None else {
            k: shd.reshard(state[k], ctx, src[k], dst[k]) for k in state}

    st = moved(cache, cache_specs, lay) if cache_specs else None
    if sharded:
        w = sm.use_tree(p, ps, keep=True)
        y, new = mamba_layer(w, sm.full(h, dup=False), cfg, st,
                             parallel=ctx, gbatch=sm.gbatch(h.shape[0]))
        y = sm.from_partial(y)
    else:
        y, new = mamba_layer(sm.use_tree(p, ps, dup=True),
                             sm.full(h, dup=True), cfg, st)
        y = sm.from_full_dup(y)
    if cache_specs is None:
        return y
    return y, moved(new, lay, cache_specs)
