"""Mixture-of-Experts FFN, on one device or expert-sharded over a mesh.

Port of the single-device and tensor-parallel paths of
``repro.models.moe`` (granite-moe; arctic runs it beside a dense residual
MLP): top-k routing with per-expert
positions in the reference's token order, capacity-bounded dispatch into
an (E, C, D) buffer, the expert SwiGLU FFN, and the gated combine.
Experts are zero-padded to ``n_experts_padded`` (granite-moe: 40 -> 48);
padded experts are masked out of routing.

Every token of the (B, S) input routes and takes capacity, pads included:
a packed-prefill wave's pad tokens compete for expert slots as they do in
the reference, so a request's tokens can depend on the wave it was served
in (ROADMAP §3). Tokens past an expert's capacity are dropped (their
expert term is 0), as in the reference.

Packed expert weights run kernel A's expert batch
(``packed_matmul_experts``): one launch per projection for all experts,
where the reference maps ``packed_matmul`` over experts one at a time
under ``lax.cond(count > 0)``; an expert with no routed token reads no
weight and gives exactly 0, decided on the device from ``counts``.
Under a ``TPShard`` with expert-sharded weights (``_moe_tp``) every rank
routes all tokens and runs its resident experts. Under a
``ParallelContext`` (training) the reference's expert-parallel path runs
(``_moe_ep``): each rank routes its own tokens (its batch rows and its
rows of the sequence) with a capacity from that local count, the experts'
weights are gathered over ``data`` in ``cfg.dtype`` (ZeRO-3), the
dispatch buffer goes out to the experts' ranks and back by all_to_all
over ``model``, and the load-balancing loss is the mean over the ranks.
Where that does not apply (experts that do not divide over ``model``, a
stream not held in rows) every rank routes the whole global batch, as
the reference's GSPMD path does there.

Gradients run through routing as the reference's: the gates and the
load-balancing loss (through the router's softmax) carry them; top-k
indices, positions and the dispatch slots do not. The dispatch writes
into a fresh buffer (``index_put``, whose backward gathers), and dense
experts rematerialize their capacity chunks under autograd.
"""
from __future__ import annotations

import torch

from ..core.quantize import PackedQTensor, QTensor
from ..kernels.msb_matmul.ops import packed_matmul_experts
from ..parallel import sharding as shd
from ..parallel.sharding import ParallelContext
from .layers import Spmd, grad_on, remat, tp_of


def _capacity(tokens, k, e_total, cf):
    """Slots per expert: ``cf * tokens * k / E`` rounded up to a multiple
    of 8, at least 8 (host ints: it depends on shapes alone)."""
    cap = int(cf * tokens * k / max(e_total, 1))
    return max(8, -(-cap // 8) * 8)


def _route(x2d, router_w, e_total, n_real, k, capacity):
    """Top-k routing of the (T, D) tokens. Returns (gates (T, k) f32
    renormalised, eidx (T, k), pos (T, k) each choice's position in its
    expert, keep (T, k) = pos < capacity, aux the load-balancing loss).
    Positions count over the flat (k, T) order — every token's first
    choice before any second choice — as the reference's cumsum does."""
    t = x2d.shape[0]
    dev = x2d.device
    logits = x2d.to(torch.float32) @ router_w.to(torch.float32)
    experts = torch.arange(e_total, device=dev)
    if n_real < e_total:
        logits = torch.where(experts < n_real, logits,
                             torch.full_like(logits, -1e30))
    probs = torch.softmax(logits, dim=-1)
    gates, eidx = torch.topk(probs, k, dim=-1)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    flat_e = eidx.t().reshape(-1)                               # (k*T,)
    onehot = (flat_e[:, None] == experts[None, :]).to(torch.int32)
    pos_flat = torch.cumsum(onehot, dim=0) - 1
    pos_flat = torch.gather(pos_flat, 1, flat_e[:, None])[:, 0]
    pos = pos_flat.reshape(k, t).t()
    keep = pos < capacity
    me = probs.mean(dim=0)
    ce = (eidx[:, :1] == experts[None, :]).to(torch.float32).mean(dim=0)
    aux = n_real * torch.sum(me * ce)
    return gates, eidx, pos, keep, aux


def _dispatch(x2d, gates, eidx, pos, keep, e_total, capacity):
    """Scatter tokens into the (E*C + 1, D) dispatch buffer; the last row
    takes every dropped choice. Returns (buffer, flat_slot (T*k,))."""
    t, d = x2d.shape
    k = eidx.shape[1]
    slot = torch.where(keep, eidx * capacity + pos,
                       torch.full_like(eidx, e_total * capacity))
    flat_slot = slot.reshape(-1)
    buf = x2d.new_zeros((e_total * capacity + 1, d))
    buf[flat_slot] = x2d[:, None].expand(t, k, d).reshape(-1, d)
    return buf, flat_slot


def _combine(ye_flat, flat_slot, gates, keep, t, k, d):
    """Gather each choice's expert output back and sum it over the k
    choices, weighted by its gate (0 for a dropped choice)."""
    yflat = torch.cat([ye_flat, ye_flat.new_zeros((1, d))], dim=0)
    yk = yflat[flat_slot].reshape(t, k, d)
    w = (gates * keep).to(yk.dtype)
    return torch.sum(yk * w[..., None], dim=1)


def _silu_gate(g, u, dtype):
    return torch.nn.functional.silu(g.to(torch.float32)).to(dtype) * u


def _expert_chunk(xc, wg, wi, wo):
    g = torch.einsum("ecd,edf->ecf", xc, wg.to(xc.dtype))
    u = torch.einsum("ecd,edf->ecf", xc, wi.to(xc.dtype))
    return torch.einsum("ecf,efd->ecd", _silu_gate(g, u, xc.dtype),
                        wo.to(xc.dtype))


def _expert_ffn(xe, wg, wi, wo, chunk=2048):
    """Dense expert weights: xe (E, C, D); wg/wi (E, D, F), wo (E, F, D).
    Under autograd, chunks of ``chunk`` capacity slots (shrunk until it
    divides C) are each rematerialized, so the (E, C, F) hidden
    activations are never kept whole: the reference's checkpointed
    capacity chunks."""
    if not grad_on(xe, wg, wi, wo):
        return _expert_chunk(xe, wg, wi, wo)
    c = xe.shape[1]
    ck = min(chunk, c)
    while c % ck:
        ck -= 1
    return torch.cat([remat(_expert_chunk, xe[:, i:i + ck], wg, wi, wo)
                      for i in range(0, c, ck)], dim=1)


def _expert_ffn_quantized(xe, wg, wi, wo, counts):
    """Quantized expert weights, the reference's router-gated map over
    experts: an expert with ``counts`` 0 gives exactly 0. Packed weights
    run kernel A's expert batch, which skips those experts on the device;
    a ``QTensor`` dequantizes and multiplies (``execution="simulated"``),
    and the zero branch is then a select on the device."""
    def mm(x, w):
        if isinstance(w, PackedQTensor):
            return packed_matmul_experts(x, w, counts)
        if isinstance(w, QTensor):
            w = w.dequantize()
        return torch.matmul(x, w.to(x.dtype))

    y = mm(_silu_gate(mm(xe, wg), mm(xe, wi), xe.dtype), wo)
    if isinstance(wo, PackedQTensor):
        return y
    return torch.where((counts > 0)[:, None, None], y, torch.zeros_like(y))


def _moe_tp(p, x, cfg, tp):
    """Expert-sharded MoE on one rank (the reference's ``_moe_tp``). Every
    rank routes the whole (replicated) token stream with the replicated
    router, so gates, expert choices and positions are those of one
    device; it then dispatches only the choices bound for its
    ``E / tp.size`` resident experts, runs them through the expert batch,
    combines with the other choices masked out, and the ranks' disjoint
    partial sums are added (``psum``)."""
    b, s, d = x.shape
    k = cfg.n_experts_active
    e_total = cfg.n_experts_padded
    e_loc = e_total // tp.size
    capacity = _capacity(b * s, k, e_total, cfg.capacity_factor)
    x2d = x.reshape(-1, d)
    gates, eidx, pos, keep, aux = _route(x2d, p["router"], e_total,
                                         cfg.n_experts, k, capacity)
    lo = tp.rank * e_loc
    local = (eidx >= lo) & (eidx < lo + e_loc)
    keep_l = keep & local
    eidx_l = torch.where(local, eidx - lo, torch.zeros_like(eidx))
    buf, flat_slot = _dispatch(x2d, gates, eidx_l, pos, keep_l, e_loc,
                               capacity)
    xe = buf[:-1].reshape(e_loc, capacity, d)
    counts = torch.zeros(e_loc, dtype=torch.int32, device=x.device)
    counts.index_add_(0, eidx_l.reshape(-1),
                      keep_l.reshape(-1).to(torch.int32))
    ye = _expert_ffn_quantized(xe, p["wg"], p["wi"], p["wo"], counts)
    y = _combine(ye.reshape(-1, d), flat_slot, gates, keep_l, b * s, k, d)
    return tp.psum(y).reshape(b, s, d), aux


def moe_param_specs(cfg, ctx):
    """The specs of an MoE layer's leaves (one layer, no periods dim)."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts_padded
    ax = ("experts", "fsdp", None)
    return {"router": shd.resolve_spec((None, None), (d, e), ctx),
            "wg": shd.resolve_spec(ax, (e, d, f), ctx),
            "wi": shd.resolve_spec(ax, (e, d, f), ctx),
            "wo": shd.resolve_spec(ax, (e, f, d), ctx)}


def _moe_spmd(p, x, cfg, sm, ps):
    """The MoE FFN on a rank under ``Spmd`` ``sm``: ``p`` the layer's
    local blocks (specs ``ps``; quantized experts are dequantized first
    and cut to the rank's block, as the reference dequantizes them before
    its collectives), ``x`` the rank's stream. Expert-parallel
    (``_moe_ep``) when the experts divide over ``model`` and the stream
    is held in rows (or ``model`` has one rank), or over the rank's share
    of its tokens where the stream is whole on every ``model`` rank and
    the tokens divide (decode), both only where the batch is cut over the
    data axes; else every rank routes the global batch. Capacity comes
    from the tokens a rank routes."""
    ctx = sm.ctx
    p = dict(p)
    for n in ("wg", "wi", "wo"):
        if isinstance(p[n], (QTensor, PackedQTensor)):
            p[n] = shd.local_block(p[n].dequantize(), ps[n], ctx)
    # the reference's expert parallelism needs the tokens cut over every
    # axis (its shard_map's P(dp, model) blocks): a batch held whole on
    # every data rank routes globally, as one device does
    ep = cfg.n_experts_padded % sm.tp == 0 and (
        ctx.dp_size == 1 or sm.bspec is not None)
    if ep and (sm.tp == 1 or sm.sp):
        return _moe_ep(p, x, cfg, sm, ps)
    b, s, d = x.shape
    if ep and sm.serving and (b * s) % sm.tp == 0:
        # a stream whole on every model rank (decode): each rank routes
        # its share of the tokens, as in rows, and the outputs are
        # gathered back
        mine = shd.slice_rank(x.reshape(1, b * s, d), ctx, sm.axis, 1)
        y, aux = _moe_ep(p, mine, cfg, sm, ps)
        y = shd.all_gather(y, ctx, sm.axis, 1, dup=True)
        return y.reshape(b, s, d), aux
    bax = shd._axes(sm.bspec)
    xg = shd.all_gather(sm.full(x, dup=True), ctx, bax, 0) if bax else \
        sm.full(x, dup=True)
    y, aux = moe_layer(sm.use_tree(p, ps, dup=True), xg, cfg)
    if bax:
        y = shd.slice_rank(y, ctx, bax, 0)
    return sm.from_full_dup(y), aux


def _moe_ep(p, x, cfg, sm, ps):
    """The reference's expert-parallel MoE on one rank: route the rank's
    (B, S_l) tokens with capacity from ``B * S_l``, all_to_all the (E, C,
    D) dispatch over ``model`` so each rank holds its ``E / tp`` experts'
    slots from every rank, run them (weights gathered over ``data`` in
    ``cfg.dtype``), all_to_all back and combine; aux psum'd over every
    mesh axis / n_devices."""
    ctx, axis = sm.ctx, sm.axis
    b, s, d = x.shape
    k = cfg.n_experts_active
    e_total = cfg.n_experts_padded
    capacity = _capacity(b * s, k, e_total, cfg.capacity_factor)
    router = sm.use(p["router"], ps["router"])
    w = {n: sm.use(p[n].to(cfg.dtype), ps[n], keep=True)
         for n in ("wg", "wi", "wo")}
    x2d = x.reshape(-1, d)
    gates, eidx, pos, keep, aux = _route(x2d, router, e_total,
                                         cfg.n_experts, k, capacity)
    buf, flat_slot = _dispatch(x2d, gates, eidx, pos, keep, e_total,
                               capacity)
    send = buf[:-1].reshape(e_total, capacity, d)
    recv = shd.all_to_all(send, ctx, axis, 0, 1)     # (E/tp, tp*C, D)
    ye = _expert_ffn(recv, w["wg"], w["wi"], w["wo"])
    back = shd.all_to_all(ye, ctx, axis, 1, 0)       # (E, C, D)
    y = _combine(back.reshape(-1, d), flat_slot, gates, keep, b * s, k, d)
    aux = shd.psum(aux, ctx, ctx.mesh.axis_names) / ctx.n_devices
    return y.reshape(b, s, d), aux


def moe_layer(p, x, cfg, parallel=None):
    """x (B, S, D) -> (y (B, S, D), aux). ``p``: router (D, E) and experts
    wg/wi (E, D, F), wo (E, F, D), dense, ``QTensor`` or ``PackedQTensor``.
    ``parallel``: None (one device); a ``TPShard``: expert-sharded
    weights take ``_moe_tp``, any other layer the one-device path, which
    is then exact on every rank; a rank's ``ParallelContext``: ``p`` holds
    the rank's blocks and ``x`` its block of the reference's
    ``P(dp_axes, model)`` token layout (``_moe_spmd``); or a block's
    ``Spmd`` view."""
    if isinstance(parallel, ParallelContext):
        parallel = Spmd(parallel, x.shape[1] * parallel.tp_size)
    if isinstance(parallel, Spmd):
        return _moe_spmd(p, x, cfg, parallel,
                         moe_param_specs(cfg, parallel.ctx))
    tp = tp_of(parallel)
    if tp is not None and getattr(p.get("wg"), "shard", None) == "e":
        return _moe_tp(p, x, cfg, tp)
    b, s, d = x.shape
    k = cfg.n_experts_active
    e_total = cfg.n_experts_padded
    capacity = _capacity(b * s, k, e_total, cfg.capacity_factor)
    x2d = x.reshape(-1, d)
    gates, eidx, pos, keep, aux = _route(x2d, p["router"], e_total,
                                         cfg.n_experts, k, capacity)
    buf, flat_slot = _dispatch(x2d, gates, eidx, pos, keep, e_total,
                               capacity)
    xe = buf[:-1].reshape(e_total, capacity, d)
    if isinstance(p["wg"], (QTensor, PackedQTensor)):
        counts = torch.zeros(e_total, dtype=torch.int32, device=x.device)
        counts.index_add_(0, eidx.reshape(-1),
                          keep.reshape(-1).to(torch.int32))
        ye = _expert_ffn_quantized(xe, p["wg"], p["wi"], p["wo"], counts)
    else:
        ye = _expert_ffn(xe, p["wg"], p["wi"], p["wo"])
    y = _combine(ye.reshape(-1, d), flat_slot, gates, keep, b * s, k, d)
    return y.reshape(b, s, d), aux
