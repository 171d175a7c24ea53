"""One process a rank: the port's stand-in for ``shard_map`` and ``jit``.

PyTorch has no single-process SPMD, so a mesh is the calling process,
rank 0, plus one worker process for each further rank, spawned (a fork
after CUDA initialisation breaks). The ranks join a gloo process group
over a ``file://`` store in a temp dir (no port to clash over) and each
holds a ``TPShard`` on it. A tensor-parallel mesh
(``launch.mesh.make_tp_mesh``) is 1-D; a ``ProcessMesh``
(``launch.mesh.make_host_mesh``) has named axes of any number, and each
rank also holds a ``ParallelContext`` with its coordinates and a gloo
group for every set of axes it shares with other ranks (``par``).

The control plane stays on rank 0 alone: an engine's scheduler,
allocator, block tables, sampling decisions, deadlines and overload
control run there, as in the reference. A dispatch is a message from rank
0 to every worker, over a pipe: a function of this package and its
arguments (the dispatch kind, the host control arrays: tokens, positions,
block-table rows, slots, ...). Every rank, rank 0 included, then runs
that function on its own state, with the collectives inside the model
code, and the outputs come out replicated: rank 0 keeps its own, the
workers send back an acknowledgement. Time-dependent decisions are made
once, on rank 0, so the ranks never disagree.

An engine installs its rank-local state on every rank (``install``):
each rank's slices of the weights (CPU tensors sent to a worker through
shared memory; the worker moves them to its device) and its own KV pools
or caches, under a key; ``drop`` frees them. Several engines may use one
mesh in turn.

Failure: a worker whose function raises sends the error back and exits,
so any rank waiting on it in a collective fails at once (its peer closed)
and every collective runs under the group's timeout otherwise. The
controller raises the worker's error (``RankError``), the mesh is broken
from then on and ``close`` leaves no process behind. An error on rank 0
breaks the mesh the same way (its workers may be waiting in a
collective), after stopping them.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
import shutil
import tempfile
import threading
import time
import traceback
import weakref

import torch

from .sharding import (GlooGroup, MeshShape, TPShard, from_mesh,
                       make_groups, mesh_coords)


# seconds any collective, and rank 0's wait for a worker's reply, may take
# before the call fails
TIMEOUT_S = 120.0


class RankError(RuntimeError):
    """A rank of a tensor-parallel mesh failed (its traceback in the
    message), or the mesh was broken by an earlier failure."""


def _gloo(store, rank, size):
    import torch.distributed as dist
    opts = dist.ProcessGroupGloo._Options()
    opts._timeout = datetime.timedelta(seconds=TIMEOUT_S)
    opts._devices = [dist.ProcessGroupGloo.create_device(
        hostname="127.0.0.1")]
    return GlooGroup(dist.ProcessGroupGloo(store, rank, size, opts))


def join_mesh(store_path, rank, size, mesh_shape, device):
    """A rank's groups over the ``file://`` store, on the loopback
    interface (the ranks share one host): (the world group, the rank's
    ``ParallelContext`` or None). ``mesh_shape``: None for a 1-D
    tensor-parallel mesh, else (shape, axis_names), the ranks row-major
    over it."""
    import torch.distributed as dist
    store = dist.FileStore(store_path, size)
    world = _gloo(store, rank, size)
    if mesh_shape is None:
        return world, None
    shape, names = mesh_shape
    par = dataclasses.replace(from_mesh(MeshShape(shape, names)),
                              coords=mesh_coords(shape, rank),
                              device=device)
    groups = make_groups(par, lambda prefix, r_, n_: _gloo(
        dist.PrefixStore(prefix, store), r_, n_))
    return world, dataclasses.replace(par, groups=groups)


class RankContext:
    """What a rank holds: its ``TPShard``, its ``ParallelContext`` on an
    N-D mesh (``par``, else None), its device and the rank-local states
    by key."""

    def __init__(self, tp: TPShard, device: torch.device, par=None):
        self.tp = tp
        self.par = par
        self.device = device
        self.states = {}


def _worker_main(rank, size, store_path, device, threads, conn,
                 mesh_shape=None):
    """A worker rank: join the groups, then run each function rank 0
    sends until told to exit or its pipe closes."""
    torch.set_num_threads(threads)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    try:
        group, par = join_mesh(store_path, rank, size, mesh_shape, dev)
    except BaseException:
        conn.send(("err", traceback.format_exc()))
        return
    ctx = RankContext(TPShard(size=size, rank=rank, group=group), dev, par)
    conn.send(("ready", None))
    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            return                        # the controller is gone
        except BaseException:             # a message it cannot unpickle
            conn.send(("err", traceback.format_exc()))
            return
        if msg is None:
            return
        fn, args, reply = msg
        try:
            out = fn(ctx, *args)
        except BaseException:
            conn.send(("err", traceback.format_exc()))
            return                        # peers waiting on us fail at once
        conn.send(("ok", out if reply else None))


class TPMesh:
    """A tensor-parallel mesh of ``len(devices)`` ranks: this process is
    rank 0 on ``devices[0]``, worker processes the others. Made by
    ``launch.mesh.make_tp_mesh``; engines take it as ``mesh=``.

    ``run(fn, *args)`` runs ``fn(ctx, *args)`` on every rank (sent to the
    workers first, then run on rank 0) and returns rank 0's result;
    ``gather`` returns every rank's. ``fn`` must be a module-level
    function of an importable module (it is sent by name)."""

    def __init__(self, devices, mesh_shape=None):
        import torch.multiprocessing as tmp   # shares CPU tensors' memory
        self.devices = [torch.device(d) for d in devices]
        self.size = len(self.devices)
        if mesh_shape is None:        # the reference's ("model",) mesh
            self.shape = {"model": self.size}
            self.axis_names = ("model",)
        self._broken = None
        self._next_key = 0
        self._dir = tempfile.mkdtemp(prefix="repro_tp_")
        store = os.path.join(self._dir, "store")
        mp = tmp.get_context("spawn")
        self._conns, self._procs = [], []
        # stops the workers when the mesh is closed, broken, collected or
        # the interpreter exits
        self._finalizer = weakref.finalize(self, TPMesh._stop_procs,
                                           self._conns, self._procs,
                                           self._dir)
        try:
            for r in range(1, self.size):
                parent, child = mp.Pipe()
                # a rank on a card computes there: one host thread, so
                # ranks sharing a host do not oversubscribe its cores; a
                # CPU rank takes its share of them
                n = (1 if self.devices[r].type == "cuda"
                     else max(1, torch.get_num_threads() // self.size))
                proc = mp.Process(
                    target=_worker_main, daemon=True,
                    args=(r, self.size, store, str(self.devices[r]), n,
                          child, mesh_shape))
                proc.start()
                child.close()
                self._conns.append(parent)
                self._procs.append(proc)
            group, par = self._join(store, mesh_shape)
            for r in range(1, self.size):
                self._recv(r)
        except BaseException:
            self._finalizer()
            raise
        self.ctx = RankContext(TPShard(size=self.size, rank=0, group=group),
                               self.devices[0], par)

    def _join(self, store, mesh_shape):
        """Rank 0's process group, made while watching the workers: one
        that exits before joining fails the mesh at once, with its error,
        instead of after the store's timeout."""
        box = {}

        def join():
            try:
                box["group"] = join_mesh(store, 0, self.size, mesh_shape,
                                         self.devices[0])
            except BaseException as exc:
                box["error"] = exc

        thread = threading.Thread(target=join, daemon=True)
        thread.start()
        while thread.is_alive():
            thread.join(0.2)
            for r, proc in enumerate(self._procs, 1):
                if not proc.is_alive() and thread.is_alive():
                    raise self._sent_error(r, 0) or RankError(
                        f"rank {r} exited with code {proc.exitcode} before "
                        "joining the process group")
        if "error" in box:
            raise box["error"]
        return box["group"]

    @property
    def shard(self) -> TPShard:
        """Rank 0's ``TPShard``."""
        return self.ctx.tp

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def new_key(self):
        """A key no engine on this mesh has used."""
        self._next_key += 1
        return self._next_key

    # -- protocol ------------------------------------------------------------
    def _recv(self, r):
        """Rank ``r``'s reply: its result, or ``RankError`` with its
        traceback when it raised, died or outlived the timeout."""
        conn, proc = self._conns[r - 1], self._procs[r - 1]
        deadline = time.monotonic() + TIMEOUT_S + 10.0
        while not conn.poll(0.2):
            if not proc.is_alive() and not conn.poll(0):
                raise RankError(f"rank {r} exited with code {proc.exitcode}")
            if time.monotonic() > deadline:
                raise RankError(f"rank {r}: no reply in {TIMEOUT_S} s")
        try:
            status, out = conn.recv()
        except (EOFError, OSError):
            raise RankError(f"rank {r} exited with code "
                            f"{proc.exitcode}") from None
        if status == "err":
            raise RankError(f"rank {r} raised:\n{out}")
        return out

    def _sent_error(self, r, wait_s=1.0):
        """Rank ``r``'s error if it sent one within ``wait_s`` seconds."""
        conn = self._conns[r - 1]
        try:
            if conn.poll(wait_s):
                status, out = conn.recv()
                if status == "err":
                    return RankError(f"rank {r} raised:\n{out}")
        except (EOFError, OSError):
            pass
        return None

    def _call(self, fn, args, per_rank, reply):
        if self._broken is not None:
            raise RankError(f"the mesh is broken: {self._broken}")
        try:
            for r in range(1, self.size):
                extra = () if per_rank is None else tuple(per_rank[r])
                self._conns[r - 1].send((fn, args + extra, reply))
            extra = () if per_rank is None else tuple(per_rank[0])
            try:
                out0 = fn(self.ctx, *(args + extra))
            except BaseException as exc:
                # a worker's failure shows here as a closed peer: the
                # worker's own error, sent before it exited, names the cause
                for r in range(1, self.size):
                    err = self._sent_error(r)
                    if err is not None:
                        raise err from exc
                raise
            outs = [out0] + [self._recv(r) for r in range(1, self.size)]
        except BaseException as exc:
            self._broken = f"{type(exc).__name__}: {exc}".splitlines()[0]
            self._finalizer()
            raise
        return outs

    def run(self, fn, *args, per_rank=None):
        """``fn(ctx, *args, *per_rank[r])`` on every rank r; returns rank
        0's result (the workers' are dropped)."""
        return self._call(fn, args, per_rank, False)[0]

    def gather(self, fn, *args, per_rank=None):
        """As ``run``, returning every rank's result, in rank order."""
        return self._call(fn, args, per_rank, True)

    # -- engines' state ------------------------------------------------------
    def install(self, key, fn, per_rank, *args):
        """Install an engine's rank-local state under ``key``:
        ``fn(ctx, *args, *per_rank[r])`` on rank r returns it. Tensors of
        a worker's ``per_rank`` entry must lie on the CPU (sent through
        shared memory)."""
        self.run(_install, key, fn, *args, per_rank=per_rank)

    def drop(self, key):
        """Free the state installed under ``key`` on every rank (a no-op on
        a broken or closed mesh)."""
        if self._broken is None:
            self.run(_drop, key)
        else:
            self.ctx.states.pop(key, None)

    # -- teardown -------------------------------------------------------------
    @staticmethod
    def _stop_procs(conns, procs, tmpdir):
        for conn, proc in zip(conns, procs):
            if proc.is_alive():
                try:
                    conn.send(None)
                except (OSError, ValueError):
                    pass
        for proc in procs:
            proc.join(5)
            if proc.is_alive():
                proc.terminate()
                proc.join(5)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for conn in conns:
            conn.close()
        shutil.rmtree(tmpdir, ignore_errors=True)

    def close(self):
        """Stop every worker and free the mesh; later calls raise."""
        if self._broken is None:
            self._broken = "closed"
        self.ctx.states.clear()
        self._finalizer()


# -- functions every rank runs ----------------------------------------------

def _install(ctx, key, fn, *args):
    ctx.states[key] = fn(ctx, *args)


def _drop(ctx, key):
    ctx.states.pop(key, None)
    if ctx.device.type == "cuda":
        # the ranks may share a card: give the freed memory back to it
        torch.cuda.synchronize(ctx.device)
        torch.cuda.empty_cache()


class ProcessMesh(TPMesh):
    """A mesh with named axes: ``shape`` maps each axis name to its size
    (in mesh order, as ``jax.sharding.Mesh.shape``) and ``axis_names``
    lists them; rank r sits at the row-major coordinates of r, on
    ``devices[r]``. Every rank holds a ``ParallelContext`` (``ctx.par``)
    with its coordinates and groups. Made by ``launch.mesh.
    make_host_mesh``; runs functions as ``TPMesh`` does."""

    def __init__(self, shape, axis_names, devices):
        shape = tuple(int(n) for n in shape)
        self.shape = MeshShape(shape, axis_names).shape
        self.axis_names = tuple(axis_names)
        if len(devices) != math.prod(shape):
            raise ValueError(f"mesh {shape} needs {math.prod(shape)} "
                             f"devices, got {len(devices)}")
        super().__init__(devices, mesh_shape=(shape, self.axis_names))

    def coords(self, rank):
        """Rank ``rank``'s index along each axis (row-major)."""
        return mesh_coords(tuple(self.shape.values()), rank)

    def __repr__(self):
        return (f"ProcessMesh({tuple(self.shape.values())}, "
                f"{self.axis_names})")
