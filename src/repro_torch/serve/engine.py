"""Static-batch serving engine (prefill -> ring-buffer decode), and the
execution-mode resolution the serving engines share.

Port of ``repro.serve.engine``. ``execution="packed"`` (the default)
rewrites QTensor leaves once at load into kernel-layout ``PackedQTensor``s,
so every forward streams 4-bit codes through the msb_matmul kernel;
``execution="simulated"`` keeps the QTensors and dequantizes them per call,
the paper's simulation (Sec. 4.1). ``ServeEngine`` runs a fixed batch in
lockstep: one prefill (every attention on the flash-attention kernel) and
then one ring decode step per token; ``score`` is the held-out NLL
through the loss forward. It serves every decoder-only stack, those with
per-sequence state too (jamba's mamba layers, xlstm), which paging does
not. Production traffic goes through ``ContinuousEngine``; both give the
same greedy tokens in either mode.

Both engines take ``mesh=`` (``launch.mesh.make_tp_mesh``) for tensor
parallelism (DESIGN.md Sec. 10): ``models.model.shard_params``
partitions the weights once and cuts each rank's slices; here every rank
runs the whole ``generate`` (prefill, ring decode and sampling, with
collectives inside the model code) or ``score`` on its shard in one call
to the mesh, and rank 0's result comes back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.quantize import map_tensors
from ..device import resolve_device
from ..models.model import install_slices, shard_params
from ..parallel import sharding as shd
from ..parallel.sharding import ParallelContext
from ..parallel.spmd import ProcessMesh, TPMesh


def check_mesh(mesh, parallel):
    """The engines' refusals, the reference's where it has them: ``mesh=``
    with ``parallel=`` is a ValueError; a ``mesh=`` that ``make_tp_mesh``
    did not make, or a ``parallel=`` that is not a controller's
    ``ParallelContext`` on a process mesh (``launch.mesh.
    make_host_mesh``; ``parallel.sharding.from_mesh``), is a
    TypeError."""
    if mesh is not None and parallel is not None:
        raise ValueError("pass either mesh= (manual TP) or parallel= "
                         "(GSPMD), not both")
    if mesh is not None and not isinstance(mesh, TPMesh):
        raise TypeError(f"mesh= takes a mesh of launch.mesh.make_tp_mesh, "
                        f"got {type(mesh).__name__}")
    if parallel is not None and not (
            isinstance(parallel, ParallelContext) and not parallel.on_rank
            and isinstance(parallel.mesh, ProcessMesh)):
        raise TypeError(f"parallel= takes a ParallelContext of a process "
                        f"mesh (from_mesh(make_host_mesh(...))), got "
                        f"{type(parallel).__name__}")


def resolve_execution(execution, params, device):
    """Resolve ``execution`` (``None`` = ``"packed"``) and place ``params``
    on ``device``. ``"packed"`` packs the QTensor leaves into kernel layout
    once (``core.policy.pack_params``); ``"simulated"`` moves the tree as it
    is, so ``dense`` and the embedding dequantize QTensors per call and
    multiply with ``torch.matmul``, where the reference multiplies outside
    any kernel (``jnp.einsum``). Attention runs its kernels either way.
    Returns (execution, params)."""
    if execution is None:
        execution = "packed"
    if execution == "packed":
        from ..core.policy import pack_params
        params, _ = pack_params(params, device=device)
    elif execution == "simulated":
        params = map_tensors(lambda t: t.to(device), params)
    else:
        raise ValueError(f"execution must be 'packed' or 'simulated', "
                         f"got {execution!r}")
    return execution, params


@dataclasses.dataclass
class ServeEngine:
    """Static-batch serving engine on ``device`` (``None`` = the card).

    Contract: ``generate(prompts, n)`` runs one prefill and n lockstep
    decode steps and returns the argmax token sequence of the model (or,
    with ``temperature > 0``, samples drawn with the given generator).
    ``params`` may mix dense tensors and MSB ``QTensor`` leaves; they are
    packed once at load (``execution="packed"``) or dequantized per call
    (``"simulated"``), and the caller's tree is not modified. ``mesh=``
    runs every call on the mesh's ranks (module docstring): the static
    caches hold a rank's heads when attention's weights shard, tokens are
    those of one device and ``score`` is within float rounding of it;
    ``tp_report`` is the planner's. ``close()`` frees the ranks' state.

    ``parallel=`` (a ``ParallelContext`` of a process mesh) serves
    GSPMD-style: the weights are placed once by the resolver
    (``Model.param_shardings``: dense leaves cut over ``data`` and
    ``model``, quantized leaves whole on every rank), and every rank runs
    ``generate`` on its batch rows (the whole batch where it does not
    divide over the data axes) in one call: the prefill keeps its blocks
    of the cache (K/V cut by ``kv_seq``), ``_grow_cache`` re-places them
    as ``max_seq`` rings (``grow_cache_spmd``), and each decode step's
    attention joins the blocks by the flash-decode combine; sampling
    reads the whole batch's logits, alike on every rank. ``score`` is
    ``Model.loss`` on the context (a batch that divides over the data
    axes). Tokens are those of one device; ``mesh=`` with ``parallel=``
    is refused.
    """
    model: object
    params: object
    max_seq: int
    execution: Optional[str] = None    # "packed" | "simulated"; None=packed
    device: object = None              # None = the card
    parallel: object = None
    mesh: object = None

    def __post_init__(self):
        check_mesh(self.mesh, self.parallel)
        host = self.mesh if self.parallel is None else self.parallel.mesh
        if host is not None and self.device is None:
            self.device = host.device
        self.device = resolve_device(self.device)
        self.execution, self.params = resolve_execution(
            self.execution, self.params, self.device)
        self.tp_report = {}
        self._key, self._closed = None, False
        if self.parallel is not None:
            # GSPMD: each rank holds its blocks of every dense leaf (the
            # resolver's) and quantized leaves whole
            cpu = map_tensors(lambda t: t.detach().to("cpu"), self.params)
            self.params = shd.device_put(
                cpu, self.model.param_shardings(self.parallel, cpu),
                host)
            self._key = self.params.key
        elif self.mesh is not None:
            shards, self.tp_report = shard_params(
                self.model, self.params, self.mesh, self.device)
            self._key = self.mesh.new_key()
            self.mesh.install(self._key, _tp_install_static,
                              [(shard,) for shard in shards], self.model,
                              self.max_seq)
            self.params = self.mesh.ctx.states[self._key]["params"]

    def close(self):
        """Free the ranks' state of a mesh engine; later calls on it
        raise. A no-op without a mesh."""
        if self._key is not None and not self._closed:
            self._closed = True
            (self.mesh or self.parallel.mesh).drop(self._key)

    def _mesh_key(self):
        if self._closed:
            raise RuntimeError("call on a closed engine")
        return self._key

    def _grow_cache(self, cache, prompt_len):
        """Move prefill caches (length P) into ``max_seq`` ring buffers.
        Only attention's K/V leaves grow, found by their path (``attn/k``,
        ``attn/v``), as the reference finds them: recurrent state keeps its
        shape, and whisper's ``xattn`` K/V is the static encoder's, every
        row of which decode attends. Where the reference pads each K/V
        leaf, this allocates the rings once (zeros) and copies the prefill
        K/V into their first P rows; the position table, where the cache
        has one, is -1 (empty) past P."""
        return grow_cache(cache, prompt_len, self.max_seq)

    def generate(self, prompts, n_tokens, temperature=0.0, generator=None):
        """prompts: (B, P) int. Returns (B, n_tokens) int32 numpy tokens.

        A Python loop of ``Model.decode_step`` with sampling on the device —
        greedy argmax, or with ``temperature > 0`` a categorical sample
        (Gumbel-max with noise from ``generator``, a ``torch.Generator`` on
        the engine's device; default seed 0) — in the reference's order:
        sample, decode, advance. Nothing is read back until the loop ends.
        On a mesh every rank runs the loop, the workers from ``generator``'s
        state, so every rank draws the same noise."""
        prompts = np.asarray(prompts)
        if self.parallel is not None:
            self._mesh_key()
            ctx = self.parallel
            state = None if generator is None else generator.get_state()
            blocks = shd.batch_blocks(ctx, {"tokens": prompts}, strict=False)
            return ctx.mesh.run(_gspmd_generate, self.model,
                                shd._plain(self.params), prompts.shape[0],
                                int(n_tokens), temperature, state,
                                self.max_seq, per_rank=blocks)
        if self.mesh is None:
            return _generate(self.model, self.params, prompts, n_tokens,
                             temperature, generator, self.max_seq,
                             self.device)
        state = None if generator is None else generator.get_state()
        workers = [(None,)] * (self.mesh.size - 1)
        return self.mesh.run(_tp_generate, self._mesh_key(), prompts,
                             int(n_tokens), temperature, state,
                             per_rank=[(generator,)] + workers)

    def score(self, tokens):
        """Mean next-token NLL (with the z-loss, as the reference's loss) of
        ``tokens`` (B, S) under the model; on a mesh, ``Model.loss`` on
        every rank with each chunk's logits gathered over the vocab
        shards."""
        tokens = np.asarray(tokens)
        if self.parallel is not None:
            self._mesh_key()
            return _score(self.model, self.params, tokens, "cpu",
                          self.parallel)
        if self.mesh is None:
            return _score(self.model, self.params, tokens, self.device)
        return self.mesh.run(_tp_score, self._mesh_key(), tokens)


def grow_cache(cache, prompt_len, max_seq):
    """``ServeEngine._grow_cache`` of a cache: rings of ``max_seq`` rows."""
    s = max_seq

    def grow(node, path=()):
        if isinstance(node, dict):
            return {k: grow(v, path + (k,)) for k, v in node.items()}
        if path[-2:] not in (("attn", "k"), ("attn", "v")):
            return node
        ring = node.new_zeros(node.shape[:2] + (s,) + node.shape[3:])
        ring[:, :, :prompt_len] = node
        return ring

    new = {"layers": grow(cache["layers"])}
    if "pos" in cache:
        pos = torch.full((cache["pos"].shape[0], s), -1,
                         dtype=torch.int32, device=cache["pos"].device)
        pos[:, :prompt_len] = cache["pos"]
        new["pos"] = pos
    return new


def _generate(model, params, prompts, n_tokens, temperature, generator,
              max_seq, device, parallel=None):
    """``ServeEngine.generate`` on ``params`` (a rank's on a mesh)."""
    prompts = torch.as_tensor(prompts, dtype=torch.int32, device=device)
    b, p = prompts.shape
    assert p + n_tokens <= max_seq
    logits, cache = model.prefill(params, {"tokens": prompts}, parallel)
    cache = grow_cache(cache, p, max_seq)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    cur = torch.full((b,), p, dtype=torch.int32, device=device)
    out = []
    for _ in range(int(n_tokens)):
        if temperature > 0:
            u = torch.rand(logits.shape, generator=generator, device=device)
            gumbel = -torch.log(-torch.log(u))
            tok = torch.argmax(logits / temperature + gumbel, dim=-1)
        else:
            tok = torch.argmax(logits, dim=-1)
        tok = tok.to(torch.int32)
        out.append(tok)
        logits, cache = model.decode_step(params, cache, tok[:, None], cur,
                                          parallel)
        cur = cur + 1
    if not out:
        return np.zeros((b, 0), np.int32)
    return torch.stack(out, dim=1).cpu().numpy()


def _score(model, params, tokens, device, parallel=None):
    tokens = torch.as_tensor(tokens, dtype=torch.int32, device=device)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    loss, _ = model.loss(params, batch, parallel)
    return float(loss)


def grow_cache_spmd(model, cache, ctx, layout, max_seq):
    """``grow_cache`` of a rank's blocks of a prefill cache (``layout``,
    a ``models.model.CacheLayout``): every K/V ring and the position
    table are re-placed for ``max_seq`` entries (a ``kv_seq`` cut of the
    longer ring gives a rank other positions than the prompt's block
    did: each ring is gathered along the sequence, grown and cut again),
    other leaves moved to their specs of the grown layout. Returns (the
    grown blocks, the grown layout)."""
    grown = dataclasses.replace(layout, seq=int(max_seq))
    src = model.cache_specs(ctx, layout)
    dst = model.cache_specs(ctx, grown)
    p = layout.seq

    def ring(t, fill, dim):
        shape = list(t.shape)
        shape[dim] = max_seq
        out = torch.full(shape, fill, dtype=t.dtype, device=t.device)
        out.narrow(dim, 0, p).copy_(t)
        return out

    def grow(node, s_node, d_node, path=()):
        if isinstance(node, dict):
            return {k: grow(v, s_node[k], d_node[k], path + (k,))
                    for k, v in node.items()}
        if path[-2:] in (("attn", "k"), ("attn", "v")):
            return shd.reshard(node, ctx, s_node, d_node,
                               fn=lambda t: ring(t, 0, 2), dims=(2,))
        if path == ("pos",):
            return shd.reshard(node, ctx, s_node, d_node,
                               fn=lambda t: ring(t, -1, 1), dims=(1,))
        return shd.reshard(node, ctx, s_node, d_node)
    return grow(cache, src, dst), grown


# -- the functions a ServeEngine's mesh ranks run ---------------------------

def _gspmd_generate(rctx, model, params, gb, n_tokens, temperature, state,
                    max_seq, batch):
    """``ServeEngine.generate`` on a rank of a ``ParallelContext``: its
    rows' prefill, the grown cache, then the decode loop; every rank
    samples the whole batch from the same logits and noise and feeds its
    rows back. Returns the (B, n_tokens) tokens."""
    from ..models.model import _rows
    ctx, dev = rctx.par, rctx.device
    prompts = torch.as_tensor(batch["tokens"], dtype=torch.int32,
                              device=dev)
    b, p = prompts.shape
    assert p + n_tokens <= max_seq
    local = params.local(rctx)
    spec = shd.resolve_spec(("batch",), (gb,), ctx)
    generator = None
    if temperature > 0:
        generator = torch.Generator(device=dev)
        if state is None:
            generator.manual_seed(0)
        else:
            generator.set_state(state)
    with torch.no_grad():
        logits, cache = model.prefill(local, {"tokens": prompts}, ctx,
                                      global_batch=gb)
        cache, layout = grow_cache_spmd(
            model, cache, ctx, model.cache_layout({"tokens": prompts}, gb),
            max_seq)
        cur = torch.full((b,), p, dtype=torch.int32, device=dev)
        out = []
        for _ in range(int(n_tokens)):
            logits = _rows(ctx, logits, gb)
            if temperature > 0:
                u = torch.rand(logits.shape, generator=generator, device=dev)
                tok = torch.argmax(logits / temperature
                                   - torch.log(-torch.log(u)), dim=-1)
            else:
                tok = torch.argmax(logits, dim=-1)
            tok = tok.to(torch.int32)
            out.append(tok)
            mine = shd.local_block(tok, spec, ctx).contiguous()
            logits, cache = model.decode_step(local, cache, mine[:, None],
                                              cur, ctx, layout=layout)
            cur = cur + 1
    if not out:
        return np.zeros((gb, 0), np.int32)
    return torch.stack(out, dim=1).cpu().numpy()


def _tp_install_static(ctx, model, max_seq, params):
    return {"model": model, "params": install_slices(ctx, params),
            "max_seq": max_seq}


def _tp_generate(ctx, key, prompts, n_tokens, temperature, state,
                 generator):
    st = ctx.states[key]
    if generator is None and state is not None:
        generator = torch.Generator(device=ctx.device)
        generator.set_state(state)
    return _generate(st["model"], st["params"], prompts, n_tokens,
                     temperature, generator, st["max_seq"], ctx.device,
                     ctx.tp)


def _tp_score(ctx, key, tokens):
    st = ctx.states[key]
    return _score(st["model"], st["params"], tokens, ctx.device, ctx.tp)
