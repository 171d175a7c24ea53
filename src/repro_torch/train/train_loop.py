"""Training step and loop with fault-tolerance hooks.

Port of ``repro.train.train_loop``. The step runs eagerly: ``Model.loss``
forward, ``backward()`` (kernel D under its autograd Function, the stack
rematerialized where ``cfg.remat`` says), the global norm clip and
``AdamW.update`` in place.

``parallel=`` a ``ParallelContext`` of a process mesh
(``launch.mesh.make_host_mesh``) runs the reference's GSPMD step: the
state lives on the ranks as the blocks ``state_axes`` resolves to
(``sharding.device_put``), every rank runs the loss and its backward on
its blocks and its batch rows, gradients of leaves that the data axes
replicate are summed over them (an ``fsdp`` leaf's came reduce-scattered
out of its all_gather's backward), the global norm is the sum of every
rank's squared norms over the mesh, and AdamW updates each rank's blocks.
From the controller the step and the loop take and return a
``sharding.Sharded`` state; checkpoints are gathered to this process and
written in the reference's byte format.
"""
from __future__ import annotations

import math
import time

import torch

from ..parallel import sharding as shd
from ..parallel.sharding import ParallelContext
from .optim import AdamW, _map, clip_by_global_norm, leaves, lr_schedule


def _device_of(params):
    return next(t for _, t in leaves(params)).device


def _on_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model, opt: AdamW, parallel=None):
    """(state, batch) -> (state, metrics); state = {"params", "opt"},
    updated in place. ``batch`` holds numpy arrays or tensors (moved to
    the params' device). metrics: loss, ce, router_aux, grad_norm and lr
    (0-d tensors on the device); the params leave the step, as they do a
    rank's, not requiring grad. ``parallel``: a ``ParallelContext``;
    on a rank the step runs on its blocks (``_rank_step``), from the
    controller it takes a ``sharding.Sharded`` state and the global batch
    and runs on every rank."""
    if isinstance(parallel, ParallelContext):
        if parallel.on_rank:
            return _rank_step(model, opt, parallel)
        return _mesh_step(model, opt, parallel)
    if parallel is not None:
        raise TypeError("make_train_step(parallel=...): expected a "
                        "ParallelContext")

    def train_step(state, batch):
        params = state["params"]
        dev = _device_of(params)
        for _, p in leaves(params):
            p.requires_grad_(True)
            p.grad = None
        loss, metrics = model.loss(params, _on_device(batch, dev))
        loss.backward()
        grads = _grads(params)
        grads, gnorm = clip_by_global_norm(grads, opt.cfg.grad_clip)
        params, opt_state = opt.update(grads, state["opt"], params)
        for _, p in leaves(params):
            p.grad = None
            p.requires_grad_(False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm,
                       lr=lr_schedule(opt.cfg, opt_state["step"]))
        return {"params": params, "opt": opt_state}, metrics

    return train_step


def _grads(params):
    """Each leaf's .grad (zeros where autograd reached none), nested like
    ``params``."""
    if isinstance(params, dict):
        return {k: _grads(v) for k, v in params.items()}
    return (params.grad if params.grad is not None
            else torch.zeros_like(params))


def init_state(model, opt: AdamW, generator, device=None,
               param_dtype=torch.float32):
    """{"params": random params from ``generator`` in ``param_dtype``,
    "opt": zero moments}; ``device`` None = the card."""
    params = model.init(generator, device)
    params = _cast(params, param_dtype)
    return {"params": params, "opt": opt.init(params)}


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    return tree.to(dtype)


def state_axes(model, opt: AdamW):
    """Logical axes of the whole train state (the resolver's input)."""
    pax = model.param_axes()
    return {"params": pax,
            "opt": opt.moment_axes(pax, model.param_shapes())}


def state_shapes(model, opt: AdamW):
    """Global shapes of the whole train state, nested as ``state_axes``."""
    shapes = model.param_shapes()
    return {"params": shapes, "opt": opt.moment_shapes(shapes)}


def state_shardings(model, opt: AdamW, ctx):
    """The ``NamedSharding`` tree of the train state on ``ctx``'s mesh."""
    return shd.tree_shardings(ctx, state_axes(model, opt),
                              state_shapes(model, opt))


def _specs(tree):
    return _map(lambda ns: ns.spec, tree)


def _mesh_axes(spec):
    return {a for entry in spec for a in shd._axes(entry)}


def sharded_global_norm(grads, specs, ctx):
    """The global norm of a tree of gradient blocks: each rank's squared
    norms, each leaf's divided by the ranks that hold the same block,
    summed over the mesh (identical on every rank)."""
    tot = None
    for path, g in leaves(grads):
        spec = _get_spec(specs, path)
        copies = ctx.n_devices // math.prod(
            ctx.size((a,)) for a in _mesh_axes(spec))
        sq = torch.sum(g.to(torch.float32) ** 2) * (1.0 / copies)
        tot = sq if tot is None else tot + sq
    return torch.sqrt(shd.raw_psum(ctx, tot, ctx.mesh.axis_names))


def _get_spec(specs, path):
    for k in path:
        specs = specs[k]
    return specs


def _rank_step(model, opt, ctx):
    """The step on a rank: (state blocks, batch rows) -> (state,
    metrics), state updated in place."""
    specs = _specs(state_shardings(model, opt, ctx))
    shapes = model.param_shapes()

    def train_step(state, batch):
        params = state["params"]
        dev = _device_of(params)
        for _, p in leaves(params):
            p.requires_grad_(True)
            p.grad = None
        loss, metrics = model.loss(params, _on_device(batch, dev), ctx)
        loss.backward()
        grads = _grads(params)
        for path, g in leaves(grads):
            spec = _get_spec(specs["params"], path)
            rest = tuple(a for a in ctx.dp_axes if a not in _mesh_axes(spec))
            if rest:
                g.copy_(shd.raw_psum(ctx, g, rest))
        gnorm = sharded_global_norm(grads, specs["params"], ctx)
        factor = torch.clamp(opt.cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                             max=1.0)
        grads = _map(lambda t: (t.to(torch.float32) * factor).to(t.dtype),
                     grads)
        params, opt_state = opt.update(grads, state["opt"], params,
                                       sharding=(ctx, specs, shapes))
        for _, p in leaves(params):
            p.grad = None
            p.requires_grad_(False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm,
                       lr=lr_schedule(opt.cfg, opt_state["step"]))
        return {"params": params, "opt": opt_state}, metrics

    return train_step


def _mesh_step(model, opt, ctx):
    """The step from the controller: (``Sharded`` state, global batch) ->
    (the same state, rank 0's metrics on the host)."""
    def train_step(state, batch):
        metrics = ctx.mesh.run(_run_rank_step, model, opt, state.key,
                               per_rank=shd.batch_blocks(ctx, batch))
        return state, metrics

    return train_step


def _run_rank_step(rctx, model, opt, key, batch):
    """Every rank's step on its installed state (sent by name)."""
    state, metrics = _rank_step(model, opt, rctx.par)(rctx.states[key],
                                                      batch)
    rctx.states[key] = state
    return {k: v.to("cpu") for k, v in metrics.items()}


def place_state(model, opt, state, mesh):
    """A global train state (CPU or any device) on the ranks of ``mesh``
    by ``state_shardings``: the ``Sharded`` handle."""
    return shd.device_put(_map(lambda t: t.detach().to("cpu"), state),
                          state_shardings(model, opt, shd.from_mesh(mesh)),
                          mesh)


def train_loop(model, opt, data_iter, *, steps, state=None, generator=None,
               device=None, parallel=None, checkpointer=None,
               checkpoint_every=0, log_every=10, straggler_monitor=None,
               should_stop=None, log_fn=print, on_step=None):
    """Run the training loop with checkpoint/restart and preemption
    handling, as the reference's (``parallel`` a ``ParallelContext`` of a
    process mesh: the state, made on the CPU when None, is placed on the
    ranks and returned as a ``sharding.Sharded`` handle; checkpoints are
    gathered to this process):

    - ``state`` None: ``init_state`` from ``generator`` on ``device``;
    - resumes from ``checkpointer.restore_latest`` if there is a step;
    - saves every ``checkpoint_every`` steps and on a preemption signal
      (``should_stop()``), then stops;
    - ``straggler_monitor`` records each step's wall time (the loss read
      back first, so the time covers the device's work);
    - ``on_step(step, metrics)``, where given, sees every step's metrics.
    Returns (state, last metrics)."""
    step_fn = make_train_step(model, opt, parallel)
    start_step = 0
    mesh = parallel.mesh if isinstance(parallel, ParallelContext) else None
    if state is None:
        state = init_state(model, opt, generator,
                           "cpu" if mesh is not None else device)
    if checkpointer is not None and checkpointer.steps():
        like = shd.gather(state) if isinstance(state, shd.Sharded) else state
        state, start_step = checkpointer.restore_latest(like=like)
        log_fn(f"[train] resumed from step {start_step}")
    if mesh is not None and not isinstance(state, shd.Sharded):
        state = place_state(model, opt, state, mesh)

    metrics = {}
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        if straggler_monitor is not None:
            float(metrics["loss"])
            straggler_monitor.record(step, time.perf_counter() - t0)
        if on_step is not None:
            on_step(step, metrics)
        if log_every and (step % log_every == 0 or step == steps - 1):
            log_fn(f"[train] step {step} loss {float(metrics['loss']):.4f} "
                   f"gnorm {float(metrics['grad_norm']):.3f}")
        preempted = should_stop is not None and should_stop()
        if checkpointer is not None and (
                preempted or (checkpoint_every
                              and (step + 1) % checkpoint_every == 0)):
            checkpointer.save(shd.gather(state) if mesh is not None
                              else state, step + 1)
        if preempted:
            log_fn(f"[train] preemption: checkpointed at step {step + 1}")
            break
    if checkpointer is not None:
        checkpointer.wait()        # the last async save is on disk
    return state, metrics
