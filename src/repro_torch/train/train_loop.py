"""Training step and loop with fault-tolerance hooks.

Port of ``repro.train.train_loop`` on one device. The step runs eagerly:
``Model.loss`` forward, ``backward()`` (kernel D under its autograd
Function, the stack rematerialized where ``cfg.remat`` says), the global
norm clip and ``AdamW.update`` in place. The reference's ``parallel=``
(GSPMD / shard_map) and ``state_axes`` (sharding rules of the state)
belong to tensor parallelism, ROADMAP item 11.
"""
from __future__ import annotations

import time

import torch

from .optim import AdamW, clip_by_global_norm, leaves, lr_schedule


def _item11(what):
    return NotImplementedError(f"{what}: sharded training is ROADMAP item 11")


def _device_of(params):
    return next(t for _, t in leaves(params)).device


def _on_device(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(model, opt: AdamW, parallel=None):
    """(state, batch) -> (state, metrics); state = {"params", "opt"},
    updated in place. ``batch`` holds numpy arrays or tensors (moved to
    the params' device). metrics: loss, ce, router_aux, grad_norm and lr
    (0-d tensors on the device)."""
    if parallel is not None:
        raise _item11("make_train_step(parallel=...)")

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


def state_axes(model, opt):
    raise _item11("state_axes")


def train_loop(model, opt, data_iter, *, steps, state=None, generator=None,
               device=None, parallel=None, checkpointer=None,
               checkpoint_every=0, log_every=10, straggler_monitor=None,
               should_stop=None, log_fn=print):
    """Run the training loop with checkpoint/restart and preemption
    handling, as the reference's:

    - ``state`` None: ``init_state`` from ``generator`` on ``device``;
    - resumes from ``checkpointer.restore_latest`` if there is a step;
    - saves every ``checkpoint_every`` steps and on a preemption signal
      (``should_stop()``), then stops;
    - ``straggler_monitor`` records each step's wall time (the loss read
      back first, so the time covers the device's work).
    Returns (state, last metrics)."""
    step_fn = make_train_step(model, opt, parallel)
    start_step = 0
    if state is None:
        state = init_state(model, opt, generator, device)
    if checkpointer is not None:
        restored = checkpointer.restore_latest(like=state)
        if restored is not None:
            state, start_step = restored
            log_fn(f"[train] resumed from step {start_step}")

    metrics = {}
    for step in range(start_step, steps):
        t0 = time.perf_counter()
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        if straggler_monitor is not None:
            float(metrics["loss"])
            straggler_monitor.record(step, time.perf_counter() - t0)
        if log_every and (step % log_every == 0 or step == steps - 1):
            log_fn(f"[train] step {step} loss {float(metrics['loss']):.4f} "
                   f"gnorm {float(metrics['grad_norm']):.3f}")
        preempted = should_stop is not None and should_stop()
        if checkpointer is not None and (
                preempted or (checkpoint_every
                              and (step + 1) % checkpoint_every == 0)):
            checkpointer.save(state, step + 1)
        if preempted:
            log_fn(f"[train] preemption: checkpointed at step {step + 1}")
            break
    if checkpointer is not None:
        checkpointer.wait()        # the last async save is on disk
    return state, metrics
