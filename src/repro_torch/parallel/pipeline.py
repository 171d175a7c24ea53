"""GPipe pipeline parallelism over a ``stage`` axis of a process mesh.

Port of ``repro.parallel.pipeline``: the layer stack splits into
``n_stages`` contiguous groups, one a rank along ``stage``; microbatches
flow stage to stage, and every stage computes each tick (the GPipe
fill/drain bubble is (S-1)/(M+S-1)). The reference's ``ppermute`` is a
send/recv on the stage ring (``sharding.ppermute``, whose backward is the
shift back), and its masked psum broadcasts the last stage's outputs to
every stage.

``layer_fn(stage_params, x) -> x`` runs on the ranks, so it is sent by
name: a module-level function of an importable module.
"""
from __future__ import annotations

import torch

from . import sharding as shd


def pipeline_forward(layer_fn, params, x_micro, mesh, stage_axis="stage"):
    """Run microbatches through the pipeline stages of ``mesh`` (a
    ``spmd.ProcessMesh`` with a ``stage_axis``). ``params``: a tree of
    tensors with leaves (n_stages, ...), stage s's slice going to the
    ranks at stage s; ``x_micro`` (n_micro, mb, ...) every stage reads.
    Returns the (n_micro, mb, ...) outputs after all stages, on the
    CPU."""
    shardings = shd._map(lambda t: shd.NamedSharding(
        mesh, (stage_axis,), tuple(t.shape)), params)
    placed = shd.device_put(params, shardings, mesh)
    x = torch.as_tensor(x_micro).detach().to("cpu")
    try:
        out = mesh.run(_stage_program, layer_fn, placed.key, x, stage_axis)
    finally:
        if not mesh._broken:
            placed.drop()
    return out


def _stage_program(rctx, layer_fn, key, xs, stage_axis):
    """One rank's GPipe schedule (sent by name): ``n_micro + n_stages -
    1`` ticks; stage 0 injects microbatch t while there is one, every
    stage applies its layers, the last stage keeps microbatch ``t -
    (n_stages - 1)``, and each output moves one stage on."""
    ctx = rctx.par
    local = shd._map(lambda t: t[0], rctx.states[key])
    xs = xs.to(rctx.device)
    return stage_loop(layer_fn, local, xs, ctx, stage_axis).to("cpu")


def stage_loop(layer_fn, params_local, xs, ctx, stage_axis="stage"):
    """The schedule on a rank of ``ctx``: ``params_local`` this stage's
    params, ``xs`` (n_micro, mb, ...) the microbatches. Returns every
    stage's copy of the last stage's outputs."""
    n_stages = ctx.size(stage_axis)
    stage = ctx.index(stage_axis)
    n_micro = xs.shape[0]
    zero = torch.zeros_like(xs[0])
    buf = zero
    outs = [zero] * n_micro
    for t in range(n_micro + n_stages - 1):
        inject = xs[min(t, n_micro - 1)] if t < n_micro else zero
        y = layer_fn(params_local, inject if stage == 0 else buf)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs[t - (n_stages - 1)] = y
        buf = shd.ppermute(y, ctx, stage_axis, 1)
    mine = torch.stack(outs)
    if stage != n_stages - 1:
        mine = torch.zeros_like(mine)
    return shd.psum(mine, ctx, stage_axis)
