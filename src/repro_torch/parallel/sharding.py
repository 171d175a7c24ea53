"""Sharding: the manual tensor-parallel context of serving (``TPShard``)
and the GSPMD-style context of training (``ParallelContext``), the
resolver from logical axis names to mesh axes, and the collectives both
run.

Port of ``repro.parallel.sharding``. The port has no compiler that
inserts collectives: a mesh is one process a rank (``parallel/spmd.py``),
each rank holds exactly the block of every leaf that ``resolve_spec``
gives it and runs the model on its local blocks, and the collectives the
reference leaves to GSPMD (or writes in its ``shard_map``s) are written
out here.

Gloo's collectives run through host memory: a CUDA tensor is staged
through it explicitly (a copy to the host, the collective, a copy back).
The arithmetic stays on the tensor's device: a sum gathers the ranks'
partial tensors (exact copies) and adds them there, in rank order, so the
sum is bit-identical on every rank and does not depend on gloo's
reduction order. Every collective runs under the process group's timeout:
a rank that died fails the call instead of hanging it.

Resolver rules (the reference's): every param, state and activation leaf
carries a tuple of logical axis names, mapped to mesh axes by
  1. divisibility: an axis is assigned only if the dim divides by the mesh
     axis size;
  2. exclusivity: each mesh axis is used at most once per leaf, in dim
     order, so fallback names ("kv_seq" after "batch") pick up idle axes.
Vocabulary: fsdp/embed -> data (ZeRO-3); tp/mlp/heads/kv/vocab/head_dim/
experts/sp -> model; batch -> (pod, data); kv_seq -> every idle axis;
layers/None -> replicated.

Gradients of the collectives (``torch.autograd.Function``s): over the
data axes every value is varying (each rank holds other rows) and each
collective's backward is its exact transpose (all_gather <-> reduce-
scatter, psum <-> psum, all_to_all <-> the reverse all_to_all). Over the
``model`` axis a replicated value carries a replicated cotangent, as
Megatron and ``shard_map``'s invariant values do: a psum of partials
transposes to the identity, an all_gather used for the same work on
every rank (``dup``) to taking the rank's slice, one used for different
work on each rank to a reduce-scatter, and a replicated value entering
different work on each rank passes ``pvary`` (identity forward, psum
backward).
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Tuple

import torch

from ..core.quantize import map_tensors


@dataclasses.dataclass(frozen=True)
class TPShard:
    """This process's place on a tensor-parallel mesh: the axis name (as
    the reference's), the number of ranks ``size``, this process's
    ``rank`` and the gloo process group of the mesh."""
    axis: str = "model"
    size: int = 1
    rank: int = 0
    group: object = dataclasses.field(default=None, compare=False,
                                      repr=False)

    def all_gather(self, x, dim=-1):
        """Tiled all-gather: the ranks' ``x`` concatenated along ``dim``
        in rank order, on ``x``'s device."""
        return group_all_gather(self.group if self.size > 1 else None, x,
                                dim)

    def psum(self, x):
        """The sum of every rank's ``x`` (same shape and dtype), added on
        ``x``'s device in rank order: identical on every rank."""
        return group_psum(self.group if self.size > 1 else None, x)


# ---------------------------------------------------------------------------
# meshes as shapes, the context and the resolver
# ---------------------------------------------------------------------------

class MeshShape:
    """A mesh's axis names and sizes, without ranks: ``shape`` maps each
    axis name to its size in mesh order (as ``jax.sharding.Mesh.shape``
    does). The resolver needs nothing more; ``spmd.ProcessMesh`` adds the
    ranks."""

    def __init__(self, shape, axis_names):
        shape = tuple(int(n) for n in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} does not fit axes "
                             f"{axis_names}")
        self.shape = dict(zip(axis_names, shape))
        self.axis_names = axis_names

    @property
    def size(self):
        return math.prod(self.shape.values())

    def coords(self, rank):
        """Rank ``rank``'s index along each axis (row-major, mesh order)."""
        return mesh_coords(tuple(self.shape.values()), rank)

    def __repr__(self):
        return f"MeshShape({tuple(self.shape.values())}, {self.axis_names})"


def mesh_coords(shape, rank):
    """The row-major coordinates of ``rank`` on a mesh of ``shape``."""
    coords = []
    for n in reversed(tuple(shape)):
        coords.append(rank % n)
        rank //= n
    return tuple(reversed(coords))


def _axes(axes):
    """A mesh-axis entry (a name, a tuple of names or None) as a tuple."""
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """A GSPMD-style context over a named N-D mesh: the reference's fields
    and ``dp_size`` / ``tp_size`` / ``n_devices`` / ``logical_map``. On a
    rank of a ``spmd.ProcessMesh`` it also holds the rank's ``coords`` (its
    index along each mesh axis, in mesh order), its ``device`` and the
    gloo groups of the axis sets it takes part in; the controller's
    context (``from_mesh``) has none of these and drives the ranks."""
    mesh: object
    dp_axes: Tuple[str, ...]
    tp_axis: str = "model"
    fsdp_axis: Optional[str] = "data"
    coords: Optional[Tuple[int, ...]] = dataclasses.field(
        default=None, compare=False)
    groups: Optional[dict] = dataclasses.field(default=None, compare=False,
                                               repr=False)
    device: Optional[torch.device] = dataclasses.field(default=None,
                                                       compare=False)

    @property
    def dp_size(self):
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    @property
    def tp_size(self):
        return self.mesh.shape[self.tp_axis]

    @property
    def n_devices(self):
        return math.prod(self.mesh.shape.values())

    def logical_map(self):
        """logical name -> candidate mesh-axis tuples, tried in order."""
        fsdp = [(self.fsdp_axis,)] if self.fsdp_axis else [()]
        tp = [(self.tp_axis,)]
        dp = tuple(self.dp_axes)
        return {
            "fsdp": fsdp, "embed": fsdp,
            "tp": tp, "mlp": tp, "heads": tp, "kv": tp, "vocab": tp,
            "head_dim": tp, "experts": tp, "sp": tp,
            "batch": [dp],
            "kv_seq": [dp + (self.tp_axis,), dp, (self.tp_axis,)],
            "layers": [()], None: [()],
        }

    # -- a rank's place ------------------------------------------------------
    @property
    def on_rank(self):
        """Whether this is a rank's context (else the controller's)."""
        return self.coords is not None

    def _mesh_order(self, axes):
        axes = set(_axes(axes))
        return tuple(a for a in self.mesh.axis_names if a in axes)

    def size(self, axes):
        """The number of ranks along ``axes`` (a name or a tuple)."""
        return math.prod(self.mesh.shape[a] for a in _axes(axes))

    def index(self, axes):
        """This rank's index along ``axes`` (row-major, in the order
        given): the block of a dim sharded over them that it holds."""
        idx = 0
        for a in _axes(axes):
            idx = idx * self.mesh.shape[a] + self.coords[
                self.mesh.axis_names.index(a)]
        return idx

    def group(self, axes):
        """The group (``GlooGroup``) of this rank's ranks along ``axes``,
        or None when there is only this rank. Members are ordered
        row-major over the axes in mesh order."""
        key = self._mesh_order(axes)
        if self.size(key) == 1:
            return None
        return self.groups[key]

    def model_shard(self):
        """This rank's ``TPShard`` over the ``model`` axis: the manual
        tensor parallelism of the paged serving path (the planner's
        slices, KV heads over ``model``), one such group for each
        coordinate on the data axes, which all run the same step."""
        return TPShard(axis=self.tp_axis, size=self.tp_size,
                       rank=self.index(self.tp_axis),
                       group=self.group(self.tp_axis))


def from_mesh(mesh) -> ParallelContext:
    """The reference's ``from_mesh``: data-parallel axes are "pod" and
    "data"; a pure ``("model",)`` mesh (the serving engines') has none."""
    names = tuple(mesh.axis_names)
    dp = tuple(a for a in names if a in ("pod", "data"))
    if not dp and "model" in names and len(names) == 1:
        dp = ()
    elif not dp:
        dp = (names[0],)
    return ParallelContext(mesh=mesh, dp_axes=dp,
                           tp_axis="model" if "model" in names else names[-1],
                           fsdp_axis="data" if "data" in names else None)


def resolve_spec(axes, shape, ctx: ParallelContext):
    """One leaf's logical axes -> its spec: a tuple with, for each dim, a
    mesh axis name, a tuple of names or None, trailing Nones dropped;
    entry for entry the reference's ``PartitionSpec``."""
    lm = ctx.logical_map()
    used = set()
    parts = []
    for dim, name in zip(shape, axes):
        cands = lm.get(name, [()])
        if isinstance(cands, tuple):
            cands = [cands]
        chosen = None
        for mesh_axes in cands:
            size = (math.prod(ctx.mesh.shape[a] for a in mesh_axes)
                    if mesh_axes else 1)
            if (mesh_axes and not (set(mesh_axes) & used)
                    and size > 1 and dim % size == 0):
                chosen = mesh_axes
                break
        if chosen:
            parts.append(chosen if len(chosen) > 1 else chosen[0])
            used.update(chosen)
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: its mesh and spec (``resolve_spec``'s tuple),
    as ``jax.sharding.NamedSharding``; ``shape`` is the global shape."""
    mesh: object
    spec: tuple
    shape: tuple = ()


def tree_map_axes(fn, axes_tree, *trees):
    """``fn(axes, *leaves)`` over an axes tree and trees of its structure
    (nested dicts)."""
    if isinstance(axes_tree, dict):
        return {k: tree_map_axes(fn, axes_tree[k], *(t[k] for t in trees))
                for k in axes_tree}
    return fn(axes_tree, *trees)


def tree_shardings(ctx: ParallelContext, axes_tree, shape_tree):
    """A ``NamedSharding`` tree for (axes, shapes) trees of one structure;
    shapes may be tuples or anything with ``.shape``."""
    def one(axes, shp):
        shape = tuple(shp.shape) if hasattr(shp, "shape") else tuple(shp)
        return NamedSharding(ctx.mesh, resolve_spec(axes, shape, ctx),
                             shape)
    return tree_map_axes(one, axes_tree, shape_tree)


def local_shape(shape, spec, ctx: ParallelContext):
    """The shape of the block of a ``shape`` leaf each rank holds."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        out[dim] //= ctx.size(_axes(entry))
    return tuple(out)


def local_block(x, spec, ctx: ParallelContext, coords=None):
    """The block of global ``x`` that the rank at ``coords`` (default this
    rank) holds under ``spec``."""
    if coords is not None:
        ctx = dataclasses.replace(ctx, coords=tuple(coords))
    for dim, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n = x.shape[dim] // ctx.size(axes)
        x = x.narrow(dim, ctx.index(axes) * n, n)
    return x


def constraint(x, axes, ctx: Optional[ParallelContext], shape=None):
    """The reference's sharding constraint. A rank's activations are local
    blocks already, so this checks that ``x`` is the block ``resolve_spec``
    gives the global ``shape`` on this rank, and returns it."""
    if ctx is None or not isinstance(ctx, ParallelContext) or shape is None:
        return x
    want = local_shape(shape, resolve_spec(axes, shape, ctx), ctx)
    if tuple(x.shape) != want:
        raise ValueError(f"constraint {axes}: local block {tuple(x.shape)} "
                         f"is not {want} of {tuple(shape)}")
    return x


# ---------------------------------------------------------------------------
# collectives on a rank's context (raw, then with their transposes)
# ---------------------------------------------------------------------------

class GlooGroup:
    """The collectives of one gloo process group ``pg`` (its members in
    group order), staged through the host; each returns on ``x``'s device
    and gives the same bits on every rank. ``launch/dryrun.py``'s
    ``RecordingGroup`` has the same methods."""

    def __init__(self, pg):
        self.pg = pg

    def size(self):
        return self.pg.size()

    def _parts(self, x):
        """Every rank's ``x`` as host tensors, in group order."""
        h = _host(x)
        parts = [torch.empty_like(h) for _ in range(self.size())]
        self.pg.allgather([parts], [h]).wait()
        return parts

    def _exchange(self, chunks):
        """alltoall of equal host chunks: chunk j to rank j; returns what
        every rank sent this one, in rank order."""
        inp = torch.cat([c.reshape(-1) for c in chunks])
        out = torch.empty_like(inp)
        self.pg.alltoall_base(out, inp, [], []).wait()
        return [o.reshape(chunks[0].shape)
                for o in torch.chunk(out, len(chunks))]

    def all_gather(self, x, dim):
        """The ranks' ``x`` concatenated along ``dim`` in rank order."""
        return torch.cat([p.to(x.device) for p in self._parts(x)], dim=dim)

    def psum(self, x):
        """The sum of the ranks' ``x``, added in rank order."""
        return _fold(torch.add, self._parts(x), x.device)

    def pmax(self, x):
        return _fold(torch.maximum, self._parts(x), x.device)

    def reduce_scatter(self, x, dim):
        """The sum of the rank's chunk of ``dim``: every rank's partial of
        that chunk (an alltoall, 1/n of ``x`` a peer), added in rank
        order: the bits of the psum's chunk."""
        chunks = [_host(c) for c in torch.chunk(x, self.size(), dim=dim)]
        return _fold(torch.add, self._exchange(chunks), x.device)

    def all_to_all(self, x, split_dim, concat_dim):
        """``split_dim`` cut into one chunk a rank, chunk j sent to rank
        j, the chunks received concatenated along ``concat_dim``."""
        chunks = [_host(c) for c in torch.chunk(x, self.size(),
                                                dim=split_dim)]
        return torch.cat([r.to(x.device) for r in self._exchange(chunks)],
                         dim=concat_dim)

    def permute(self, x, shift):
        """Send ``x`` to the rank ``shift`` places on, return what the
        rank ``shift`` places back sent."""
        n, i = self.size(), self.pg.rank()
        h = _host(x)
        out = torch.empty_like(h)
        send = self.pg.send([h], (i + shift) % n, 0)
        recv = self.pg.recv([out], (i - shift) % n, 0)
        send.wait()
        recv.wait()
        return out.to(x.device)


def _host(x):
    return x.detach().to("cpu").contiguous()


def _fold(fn, parts, device):
    """``fn`` folded over ``parts`` in rank order on ``device``."""
    out = parts[0].to(device)
    for part in parts[1:]:
        out = fn(out, part.to(device))
    return out


def group_all_gather(group, x, dim):
    """The ranks' ``x`` in ``group`` (None: this rank alone) concatenated
    along ``dim`` in rank order, on ``x``'s device."""
    return x if group is None else group.all_gather(x, dim)


def group_psum(group, x):
    """The sum of the ranks' ``x`` in ``group``, in rank order on ``x``'s
    device: the same bits on every rank."""
    return x if group is None else group.psum(x)


def raw_all_gather(ctx, x, axes, dim):
    return group_all_gather(ctx.group(axes), x, dim)


def raw_psum(ctx, x, axes):
    return group_psum(ctx.group(axes), x)


def raw_pmax(ctx, x, axes):
    group = ctx.group(axes)
    return x if group is None else group.pmax(x)


def _my_chunk(ctx, x, axes, dim):
    n = x.shape[dim] // ctx.size(axes)
    return x.narrow(dim, ctx.index(ctx._mesh_order(axes)) * n, n)


def raw_reduce_scatter(ctx, x, axes, dim):
    """The sum over ``axes`` of the rank's chunk of ``dim``."""
    group = ctx.group(axes)
    return x if group is None else group.reduce_scatter(x, dim)


def raw_all_to_all(ctx, x, axes, split_dim, concat_dim):
    """Tiled all_to_all over ``axes`` (``GlooGroup.all_to_all``)."""
    group = ctx.group(axes)
    return (x if group is None
            else group.all_to_all(x, split_dim, concat_dim))


def raw_permute(ctx, x, axis, shift):
    """Ring shift along ``axis``: send ``x`` to the rank ``shift`` places
    on, return what the rank ``shift`` places back sent."""
    group = ctx.group(axis)
    return x if group is None else group.permute(x, shift)


def reshard(x, ctx, src, dst, fn=None, dims=()):
    """A rank's block ``x`` of a leaf placed by spec ``src`` -> its block
    under spec ``dst`` (no autograd; the serving caches' layouts). A mesh
    axis that moves from one dim to another, all else alike, is one
    all_to_all; otherwise each dim whose placement changes is gathered
    whole over its axes and the rank's block of ``dst`` is cut from it.
    ``fn`` maps the leaf so gathered to a new leaf whose ``dims`` may
    change size (the grown ring buffers): those dims are gathered whole
    first and cut after."""
    def entries(spec):
        return [_axes(spec[i]) if i < len(spec) else () for i in
                range(x.dim())]
    se, de = entries(src), entries(dst)
    if fn is None and se == de:
        return x
    moved = [i for i in range(x.dim()) if se[i] != de[i]]
    if (fn is None and len(moved) == 2 and all(len(se[i]) + len(de[i]) == 1
                                               for i in moved)):
        a, b = moved if se[moved[0]] else moved[::-1]
        if se[a] == de[b] and x.shape[b] % ctx.size(de[b]) == 0:
            return raw_all_to_all(ctx, x.contiguous(), se[a], b, a)
    change = sorted(set(moved) | set(dims))
    for i in change:
        if se[i]:
            x = raw_all_gather(ctx, x.contiguous(), se[i], i)
    if fn is not None:
        x = fn(x)
    for i in change:
        if de[i]:
            n = x.shape[i] // ctx.size(de[i])
            x = x.narrow(i, ctx.index(de[i]) * n, n)
    return x.contiguous()


def _split(ctx, axes):
    """``axes`` as (model axes, data axes): the model axis follows the
    replicated-cotangent rule, every other axis the exact transpose."""
    axes = _axes(axes)
    return (tuple(a for a in axes if a == ctx.tp_axis),
            tuple(a for a in axes if a != ctx.tp_axis))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim, dup):
        fctx.meta = (ctx, axes, dim, dup)
        return raw_all_gather(ctx, x, axes, dim)

    @staticmethod
    def backward(fctx, g):
        ctx, axes, dim, dup = fctx.meta
        if dup:
            return _my_chunk(ctx, g, axes, dim).contiguous(), \
                None, None, None, None
        return raw_reduce_scatter(ctx, g.contiguous(), axes, dim), \
            None, None, None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        fctx.meta = (ctx, axes)
        return raw_psum(ctx, x, axes)

    @staticmethod
    def backward(fctx, g):
        ctx, axes = fctx.meta
        _, data = _split(ctx, axes)
        return (raw_psum(ctx, g, data) if data else g), None, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes):
        fctx.meta = (ctx, axes)
        return x.view_as(x)

    @staticmethod
    def backward(fctx, g):
        ctx, axes = fctx.meta
        return raw_psum(ctx, g, axes), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim):
        fctx.meta = (ctx, axes, dim)
        return raw_reduce_scatter(ctx, x, axes, dim)

    @staticmethod
    def backward(fctx, g):
        ctx, axes, dim = fctx.meta
        return raw_all_gather(ctx, g.contiguous(), axes, dim), \
            None, None, None


class _Slice(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, dim):
        fctx.meta = (ctx, axes, dim, x.shape[dim])
        return _my_chunk(ctx, x, axes, dim).contiguous()

    @staticmethod
    def backward(fctx, g):
        ctx, axes, dim, n = fctx.meta
        model, data = _split(ctx, axes)
        if data:          # exact transpose: the rank's rows, zeros elsewhere
            full = g.new_zeros(g.shape[:dim] + (n,) + g.shape[dim + 1:])
            _my_chunk(ctx, full, axes, dim).copy_(g)
            return full, None, None, None
        return raw_all_gather(ctx, g.contiguous(), axes, dim), \
            None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axes, split_dim, concat_dim):
        fctx.meta = (ctx, axes, split_dim, concat_dim)
        return raw_all_to_all(ctx, x, axes, split_dim, concat_dim)

    @staticmethod
    def backward(fctx, g):
        ctx, axes, split_dim, concat_dim = fctx.meta
        return raw_all_to_all(ctx, g.contiguous(), axes, concat_dim,
                              split_dim), None, None, None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, axis, shift):
        fctx.meta = (ctx, axis, shift)
        return raw_permute(ctx, x, axis, shift)

    @staticmethod
    def backward(fctx, g):
        ctx, axis, shift = fctx.meta
        return raw_permute(ctx, g.contiguous(), axis, -shift), \
            None, None, None


def all_gather(x, ctx, axes, dim, dup=False):
    """Tiled all_gather over ``axes`` along ``dim`` (rank order). Its
    backward reduce-scatters, or with ``dup`` (every rank then does the
    same work with the result, over the model axis) takes the rank's
    slice."""
    if ctx.group(axes) is None:
        return x
    return _AllGather.apply(x, ctx, axes, dim, dup)


def psum(x, ctx, axes):
    """Sum over ``axes``, in rank order on ``x``'s device; backward: the
    identity over the model axis, a psum over the others."""
    if ctx.group(axes) is None:
        return x
    return _Psum.apply(x, ctx, axes)


def pvary(x, ctx, axes):
    """Identity forward, psum backward: a replicated value entering work
    that differs by rank along ``axes``."""
    if ctx.group(axes) is None:
        return x
    return _PVary.apply(x, ctx, axes)


def reduce_scatter(x, ctx, axes, dim):
    """Sum over ``axes``, keeping the rank's chunk of ``dim``; backward an
    all_gather."""
    if ctx.group(axes) is None:
        return x
    return _ReduceScatter.apply(x, ctx, axes, dim)


def slice_rank(x, ctx, axes, dim):
    """The rank's chunk of ``dim`` of a value every rank along ``axes``
    holds whole."""
    if ctx.size(axes) == 1:
        return x
    return _Slice.apply(x, ctx, axes, dim)


def all_to_all(x, ctx, axes, split_dim, concat_dim):
    """Tiled all_to_all (``jax.lax.all_to_all(..., tiled=True)``);
    backward the reverse all_to_all."""
    if ctx.group(axes) is None:
        return x
    return _AllToAll.apply(x, ctx, axes, split_dim, concat_dim)


def ppermute(x, ctx, axis, shift=1):
    """Ring shift by ``shift`` along ``axis`` (send/recv); backward the
    shift back."""
    if ctx.group(axis) is None:
        return x
    return _Permute.apply(x, ctx, axis, shift)


def make_groups(ctx, make_group):
    """Every gloo group a rank of ``ctx.mesh`` takes part in: one for each
    set of mesh axes with more than one rank, among the ranks that share
    their coordinates on the other axes. ``make_group(store_prefix,
    rank_in_group, size)`` builds one; every rank builds its groups in one
    order, so none waits on another."""
    names = ctx.mesh.axis_names
    groups = {}
    for k in range(1, len(names) + 1):
        for combo in itertools.combinations(names, k):
            size = ctx.size(combo)
            if size == 1:
                continue
            others = tuple(a for a in names if a not in combo)
            color = "-".join(str(ctx.index((a,))) for a in others)
            prefix = f"{'+'.join(combo)}/{color}"
            groups[combo] = make_group(prefix, ctx.index(combo), size)
    return groups


# ---------------------------------------------------------------------------
# placing global trees on a process mesh, and bringing them back
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Sharded:
    """A tree placed on the ranks of ``mesh`` (``device_put``): each rank
    holds its blocks under ``key`` in its states; ``shardings`` is the
    ``NamedSharding`` tree it was placed by. ``handle[name]`` is the
    subtree ``name`` (``path`` the keys down to it)."""
    mesh: object
    key: int
    shardings: dict
    path: tuple = ()

    def __getitem__(self, name):
        return Sharded(self.mesh, self.key, self.shardings[name],
                       self.path + (name,))

    def local(self, rctx):
        """This subtree's blocks on a rank (``rctx`` its ``RankContext``)."""
        tree = rctx.states[self.key]
        for k in self.path:
            tree = tree[k]
        return tree

    def drop(self):
        """Free the blocks on every rank."""
        self.mesh.drop(self.key)


def _tree_blocks(tree, shardings, ctx, coords):
    if isinstance(tree, dict):
        return {k: _tree_blocks(tree[k], shardings[k], ctx, coords)
                for k in tree}
    if not isinstance(tree, torch.Tensor) and hasattr(tree, "dequantize"):
        if shardings.spec:            # quantized leaves go whole
            raise ValueError(f"a quantized leaf placed as {shardings.spec}")
        return map_tensors(lambda t: t.detach().to("cpu").clone(), tree)
    t = torch.as_tensor(tree).detach().to("cpu")
    if tuple(t.shape) != tuple(shardings.shape):
        raise ValueError(f"leaf of shape {tuple(t.shape)} placed as "
                         f"{tuple(shardings.shape)}")
    return local_block(t, shardings.spec, ctx, coords).contiguous().clone()


def device_put(tree, shardings, mesh=None):
    """Place a global CPU tree on a ``spmd.ProcessMesh``: rank r receives,
    for each leaf, the block ``shardings`` (a ``NamedSharding`` tree of
    the tree's structure, ``tree_shardings``) gives it, on its device;
    the port's ``jax.device_put`` onto ``NamedSharding``s. Returns the
    ``Sharded`` handle."""
    mesh = mesh if mesh is not None else _first_mesh(shardings)
    ctx = from_mesh(mesh)
    per_rank = [(_tree_blocks(tree, shardings, ctx, mesh.coords(r)),)
                for r in range(mesh.size)]
    key = mesh.new_key()
    mesh.install(key, _install_blocks, per_rank)
    return Sharded(mesh, key, shardings)


def batch_blocks(ctx, batch, strict=True):
    """Each rank's batch rows of a global batch (a dict of numpy arrays or
    tensors, batch-major) as ``per_rank`` arguments of a mesh call, in rank
    order; refused where the batch does not divide over the data-parallel
    axes (every rank would then see all of it), unless ``strict`` is off:
    serving then gives every rank the whole batch, as the resolver
    replicates a ``batch`` dim that does not divide."""
    out = []
    for r in range(ctx.mesh.size):
        coords = ctx.mesh.coords(r)
        part = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            spec = resolve_spec(("batch",), t.shape[:1], ctx)
            if strict and ctx.dp_size > 1 and not spec:
                raise ValueError(f"batch[{k!r}] has {t.shape[0]} rows, "
                                 f"which do not divide over dp = "
                                 f"{ctx.dp_size}")
            part[k] = local_block(t, spec, ctx, coords).contiguous()
        out.append((part,))
    return out


def _first_mesh(shardings):
    while isinstance(shardings, dict):
        shardings = next(iter(shardings.values()))
    return shardings.mesh


def _install_blocks(rctx, tree):
    return map_tensors(lambda t: t.to(rctx.device), tree)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _fetch_blocks(rctx, sharded):
    return _map(lambda t: t.detach().to("cpu"), sharded.local(rctx))


def _plain(sharded):
    """The handle without its mesh and placements (sent to the ranks)."""
    return dataclasses.replace(sharded, mesh=None, shardings=None)


def _assemble(blocks, shardings, ctx):
    """A global leaf (tree) from every rank's blocks, in rank order."""
    if isinstance(shardings, dict):
        return {k: _assemble([b[k] for b in blocks], shardings[k], ctx)
                for k in shardings}
    first = blocks[0]
    out = first.new_empty(shardings.shape)
    for r, blk in enumerate(blocks):
        local_block(out, shardings.spec, ctx,
                    ctx.mesh.coords(r)).copy_(blk)
    return out


def gather(sharded: Sharded):
    """The global CPU tree of a ``Sharded`` one (``device_put``'s
    inverse): every rank's blocks brought to rank 0 and put in place."""
    mesh = sharded.mesh
    blocks = mesh.gather(_fetch_blocks, _plain(sharded))
    return _assemble(blocks, sharded.shardings, from_mesh(mesh))
