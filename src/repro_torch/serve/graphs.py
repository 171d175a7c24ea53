"""The continuous engine's dispatch set, captured as CUDA graphs.

Port of the reference's module-level jits (``_paged_step``,
``_paged_prefill_packed`` and ``_paged_horizon_step`` in
``repro.serve.continuous``) and of their trace probe. Every dispatch of a
``ContinuousEngine`` has a key ``(kind, size)``: ``prefill_packed`` (size =
bucket length), ``prefill`` (size = prefill_chunk, packing off),
``decode`` and ``decode_horizon`` (size = batch bucket). The key fixes
every shape, as a jit trace's avals do.

On the card each key is one ``torch.cuda.CUDAGraph`` with static device
inputs and static outputs. The int32 inputs live in one device buffer,
filled from one pinned staging buffer by one host-to-device copy; the
block-table rows are copied from the tensor ``PagedKVCache.table_rows``
returns. A key is captured the first time it is dispatched, always from
the all-pad dummy inputs of ``serve/warmup.py`` (``q_pos``, ``seg_ids`` and
``slots`` -1, ``kv_lens`` 0, the scratch block table), after one eager
all-pad iteration on a side stream that settles lazy kernel builds and the
allocator. All-pad inputs write only scratch page 0 (and hot row 0 of
quantized pools), so a capture never commits a request's page twice. The
real inputs are then copied in and the graph replayed. A capture or replay
that fails raises: nothing runs a dispatch eagerly on the card instead.

Graphs are per engine: they bind the engine's pools and params by address,
where the reference's jit caches are shared by every engine of a model.
An engine's graphs share one memory pool, so a dispatch's outputs must be
read before the next dispatch replays. A closed dispatch set refuses every
dispatch: a step that a supervisor abandoned and that returns into its
discarded engine ends with an error instead of capturing.

The kernel wrappers count launches in Python, which runs once, at capture.
So a capture takes back what it counted, and every replay adds it.

On the CPU there is no graph: a dispatch runs eagerly from the host arrays,
and the first dispatch of each key counts as its capture.

On a tensor-parallel mesh (``TPDispatch``) there is no graph either: the
model code's gloo collectives go through the host and cannot be captured.
Each dispatch runs eagerly on every rank (``parallel/spmd.py``), and the
first dispatch of a key counts as its capture, as on the CPU.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Tuple

import numpy as np
import torch

from ..kernels.msb_matmul.ops import (msb_matmul, msb_matmul_experts,
                                      msb_unembed)
from ..kernels.paged_attention.ops import (paged_attention_decode,
                                           paged_attention_decode_quant)

# the wrappers a dispatch reaches; a replay advances each one's
# ``.launches`` by its capture's count
_WRAPPERS = (msb_matmul, msb_matmul_experts, msb_unembed,
             paged_attention_decode, paged_attention_decode_quant)

# every input of the all-pad dummy dispatch (serve/warmup.py)
PAD = {"tokens": 0, "seg_ids": -1, "q_pos": -1, "kv_lens": 0, "slots": -1,
       "last_idx": 0, "seg_off": 0, "start_pos": -1, "n_left": 0, "eos": -1}

_N_CAPTURES = 0


# the side stream each capture's eager pass runs on, one a device: cuBLAS
# keeps a workspace (32 MiB on the H100) for every stream it runs on, so a
# new stream a capture left one behind each time, and every rebuilt
# engine's warm-up grew the device memory in use
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device):
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def jit_trace_count() -> int:
    """Dispatch-graph captures so far in this process (monotonic): on the
    CPU, first dispatches of a key. The reference's trace probe under its
    name — after ``warmup()`` a serving run inside the engine's shape
    envelope must leave it unchanged (``msb_traces_compiled_total``)."""
    return _N_CAPTURES


def _note_capture():
    global _N_CAPTURES
    _N_CAPTURES += 1


def input_shapes(kind, size, max_batch):
    """(block-table rows, {input name: shape}) of dispatch key (kind,
    size), in the order the inputs are staged."""
    if kind == "prefill_packed":
        s = max_batch
        return s, {"tokens": (size,), "seg_ids": (size,), "q_pos": (size,),
                   "kv_lens": (s,), "slots": (s,), "last_idx": (s,),
                   "seg_off": (s,)}
    if kind == "prefill":
        return 1, {"tokens": (1, size), "q_pos": (1, size), "kv_lens": (1,),
                   "slots": (1,)}
    if kind == "decode":
        return size, {"tokens": (size, 1), "q_pos": (size, 1),
                      "kv_lens": (size,), "slots": (size,)}
    if kind == "decode_horizon":
        return size, {"tokens": (size,), "start_pos": (size,),
                      "n_left": (size,), "eos": (size,), "slots": (size,)}
    raise ValueError(f"unknown dispatch kind {kind!r}")


def pad_inputs(kind, size, max_batch):
    """The all-pad dummy dispatch of a key: (slots whose ``table_rows`` is
    the scratch block table, {input name: int32 array})."""
    rows, shapes = input_shapes(kind, size, max_batch)
    return [-1] * rows, {name: np.full(shape, PAD[name], np.int32)
                         for name, shape in shapes.items()}


def dispatch_forward(model, params, kv_bits, horizon, kind, x, bt, pools,
                     parallel=None):
    """One dispatch of ``kind`` through ``model``: inputs ``x`` (tensors,
    names as ``input_shapes``), block-table rows ``bt``, ``pools`` written
    in place; ``parallel`` a rank's ``TPShard`` on a mesh. Returns
    (outputs, the pools the model returned)."""
    slots = x["slots"] if kv_bits < 16 else None
    if kind == "prefill_packed":
        logits, pools = model.paged_prefill_packed(
            params, pools, x["tokens"], x["seg_ids"], x["q_pos"],
            x["kv_lens"], bt, x["slots"], x["last_idx"], x["seg_off"],
            kv_bits=kv_bits, parallel=parallel)
        return (logits,), pools
    if kind == "decode_horizon":
        tok, valid, pools = model.paged_decode_horizon(
            params, pools, x["tokens"], x["start_pos"], bt, x["n_left"],
            x["eos"], horizon, kv_bits=kv_bits, slots=slots,
            parallel=parallel)
        return (tok, valid), pools
    logits, pools = model.paged_step(params, pools, x["tokens"], x["q_pos"],
                                     x["kv_lens"], bt, kv_bits=kv_bits,
                                     slots=slots, parallel=parallel)
    return (logits,), pools


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _launch_counts():
    return [fn.launches for fn in _WRAPPERS]


class _Graph:
    """One captured key: static inputs (one int32 device buffer and its
    pinned staging twin, the block-table rows), the graph, its outputs and
    the launches each wrapper counted while it was captured."""

    def __init__(self, shapes, rows, width, device):
        n = sum(math.prod(s) for s in shapes.values())
        self.staging = torch.empty(n, dtype=torch.int32, pin_memory=True)
        self.buf = torch.empty(n, dtype=torch.int32, device=device)
        self.host: Dict[str, np.ndarray] = {}
        self.inputs: Dict[str, torch.Tensor] = {}
        staged, off = self.staging.numpy(), 0
        for name, shape in shapes.items():
            k = math.prod(shape)
            self.host[name] = staged[off:off + k].reshape(shape)
            self.inputs[name] = self.buf[off:off + k].view(shape)
            off += k
        self.bt = torch.zeros((rows, width), dtype=torch.int32, device=device)
        self.copied = torch.cuda.Event()
        self.graph = None
        self.outputs = None
        self.launches = None

    def load(self, inputs, bt):
        """Stage ``inputs`` (host arrays) and copy them and ``bt`` into the
        static buffers, on the current stream."""
        self.copied.synchronize()       # the last copy out of staging is done
        for name, dst in self.host.items():
            dst[...] = inputs[name]
        self.buf.copy_(self.staging, non_blocking=True)
        self.copied.record()
        self.bt.copy_(bt)


class DispatchGraphs:
    """The dispatch set of one ``ContinuousEngine``: ``run`` dispatches a
    key, capturing it first if it was never dispatched. Holds what the
    dispatches read (model, params, the cache whose pools they write in
    place), not the engine."""

    def __init__(self, engine):
        self.model = engine.model
        self.params = engine.params
        self.cache = engine.cache
        self.kv_bits = engine.kv_bits
        self.horizon = engine.decode_horizon
        self.max_batch = engine.max_batch
        self.device = engine.device
        self._entries: Dict[Tuple[str, int], object] = {}
        self._closed = False
        self._pool = None               # the graphs' memory pool, on first use
        # why dispatches run eagerly, or None where they are graphs
        self.eager_reason = (None if self.device.type == "cuda"
                             else "no CUDA graphs on the CPU")
        self.capture_seconds = 0.0      # Python time of the captured forwards
        self.instantiate_seconds = 0.0  # capture_end: graph instantiation

    def forward(self, kind, x, bt, pools):
        """One dispatch of ``kind`` through the model, eagerly: inputs ``x``
        (tensors, names as ``input_shapes``), block-table rows ``bt``, and
        ``pools``, written in place. What a graph captures (on the cache's
        pools); tests replay a graph against it on a copy of the pools.
        Returns (outputs, the pools the model returned)."""
        return dispatch_forward(self.model, self.params, self.kv_bits,
                                self.horizon, kind, x, bt, pools)

    def _check_pools(self, pools):
        """The model writes the pools in place: the tree it returns must
        hold the very tensors the cache owns (a graph binds addresses)."""
        got, own = list(_leaves(pools)), list(_leaves(self.cache.pools))
        if len(got) != len(own) or any(a is not b for a, b in zip(got, own)):
            raise RuntimeError("a dispatch returned new pool tensors; the "
                               "pools must be written in place")

    def run(self, kind, size, inputs, bt):
        """Dispatch key (kind, size) on host int32 ``inputs`` (names as
        ``input_shapes``) and block-table rows ``bt`` (a device tensor).
        Returns the outputs on the device — logits, or (tokens, valid) for
        ``decode_horizon`` — valid until the next ``run``."""
        key = (kind, size)
        self.check_open()
        if self.device.type != "cuda":
            x = {name: torch.from_numpy(np.ascontiguousarray(a, np.int32))
                 for name, a in inputs.items()}
            outputs, pools = self.forward(kind, x, bt, self.cache.pools)
            self.check_open()          # closed during the forward
            if key not in self._entries:
                self._check_pools(pools)
                self._entries[key] = None
                _note_capture()
            return outputs
        entry = self._entries.get(key)
        if entry is None:
            entry = self._capture(kind, size)
        entry.load(inputs, bt)
        entry.graph.replay()
        for fn, n in zip(_WRAPPERS, entry.launches):
            fn.launches += n
        return entry.outputs

    def check_open(self):
        """Raise if ``close`` was called."""
        if self._closed:
            raise RuntimeError("dispatch on a closed engine")

    def _capture(self, kind, size):
        rows, shapes = input_shapes(kind, size, self.max_batch)
        entry = _Graph(shapes, rows, self.cache.max_pages_per_seq,
                       self.device)
        slots, pads = pad_inputs(kind, size, self.max_batch)
        entry.load(pads, self.cache.table_rows(slots))
        stream = torch.cuda.current_stream(self.device)
        side = _side_stream(self.device)
        side.wait_stream(stream)
        with torch.cuda.stream(side):   # eager all-pad iteration
            self.forward(kind, entry.inputs, entry.bt, self.cache.pools)
        stream.wait_stream(side)
        self.check_open()              # closed during the eager pass
        before = _launch_counts()
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, pool=self._pool,
                              capture_error_mode="thread_local"):
            outputs, pools = self.forward(kind, entry.inputs, entry.bt,
                                          self.cache.pools)
            t1 = time.perf_counter()
        self.capture_seconds += t1 - t0
        self.instantiate_seconds += time.perf_counter() - t1
        entry.launches = [a - b for a, b in zip(_launch_counts(), before)]
        for fn, n in zip(_WRAPPERS, before):
            fn.launches = n             # a capture launches nothing
        self._check_pools(pools)
        self.check_open()              # closed during the capture
        entry.graph, entry.outputs = graph, outputs
        self._entries[(kind, size)] = entry
        _note_capture()
        return entry

    @property
    def keys(self):
        """Keys dispatched (on the card: captured) so far."""
        return list(self._entries)

    @property
    def n_graphs(self):
        """CUDA graphs the set holds."""
        return sum(e is not None for e in self._entries.values())

    def graph_launches(self, kind, size):
        """{wrapper name: launches one replay of the key counts}."""
        entry = self._entries[(kind, size)]
        return {fn.__name__: n for fn, n in zip(_WRAPPERS, entry.launches)}

    def pool_bytes(self):
        """Bytes the caching allocator holds in this engine's graph pool
        (``None`` on the CPU or before the first capture)."""
        if self._pool is None:
            return None
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def close(self):
        """Drop every graph, its outputs and the pool they share; every
        later ``run`` raises."""
        self._closed = True
        self._entries.clear()
        self._pool = None


class TPDispatch:
    """The dispatch set of a ``ContinuousEngine`` on a tensor-parallel mesh:
    the interface of ``DispatchGraphs``, each dispatch run eagerly on every
    rank. ``run`` sends the key, the host inputs and the block-table rows
    to the workers (``TPMesh.run``) and runs the same forward on rank 0
    over the engine's own pools; the outputs are rank 0's."""

    eager_reason = ("a mesh's gloo collectives cannot be captured in a "
                    "CUDA graph")
    n_graphs = 0
    capture_seconds = 0.0
    instantiate_seconds = 0.0

    def __init__(self, mesh, key):
        self.mesh, self.key = mesh, key
        self._keys = []
        self._closed = False

    def run(self, kind, size, inputs, bt):
        """Dispatch key (kind, size) on host int32 ``inputs`` and
        block-table rows ``bt`` on every rank. Returns rank 0's outputs."""
        self.check_open()
        rows = np.ascontiguousarray(bt.cpu().numpy(), np.int32)
        outputs = self.mesh.run(_tp_dispatch, self.key, kind, inputs, rows)
        self.check_open()              # closed during the forward
        if (kind, size) not in self._keys:
            self._keys.append((kind, size))
            _note_capture()
        return outputs

    def check_open(self):
        """Raise if ``close`` was called."""
        if self._closed:
            raise RuntimeError("dispatch on a closed engine")

    @property
    def keys(self):
        """Keys dispatched so far."""
        return list(self._keys)

    def pool_bytes(self):
        return None

    def close(self):
        """Free the engine's state on every rank; every later ``run``
        raises."""
        if not self._closed:
            self._closed = True
            self.mesh.drop(self.key)


class TPPagedRank:
    """One rank's state of a ``ContinuousEngine`` on a mesh: the model, the
    rank's localized weights, its pools, the pools' precision, the decode
    horizon and the ``parallel=`` its steps take (its ``TPShard``, or its
    ``ParallelContext`` under GSPMD serving)."""

    def __init__(self, model, params, pools, kv_bits, horizon, parallel):
        self.model, self.params, self.pools = model, params, pools
        self.kv_bits, self.horizon = kv_bits, horizon
        self.parallel = parallel


def tp_install_paged(ctx, model, kv_bits, horizon, pool_kw, gspmd, params,
                     pools):
    """Install function of a ``ContinuousEngine`` (``TPMesh.install``):
    ``params`` the rank's slices (moved to its device, then localized);
    ``pools`` rank 0's own, or None on a worker, which allocates its
    rank's pools from ``pool_kw``; ``gspmd``: the steps take the rank's
    ``ParallelContext``, else its ``TPShard``."""
    from ..models.model import install_slices
    params = install_slices(ctx, params)
    parallel = ctx.par if gspmd else ctx.tp
    if pools is None:
        pools = model.init_paged_pools(device=ctx.device, parallel=parallel,
                                       **pool_kw)
    return TPPagedRank(model, params, pools, kv_bits, horizon, parallel)


def _tp_dispatch(ctx, key, kind, inputs, rows):
    st = ctx.states[key]
    dev = ctx.device
    x = {name: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
         for name, a in inputs.items()}
    bt = torch.from_numpy(rows).to(dev)
    outputs, _ = dispatch_forward(st.model, st.params, st.kv_bits,
                                  st.horizon, kind, x, bt, st.pools,
                                  parallel=st.parallel)
    return outputs


def tp_pool_copy(ctx, key, kind, src, dst):
    """A fork's pool copy (``paged_cache.copy_pool_page``) on the workers'
    pools; rank 0's cache made its own."""
    if ctx.tp.rank > 0:
        from .paged_cache import copy_pool_page
        copy_pool_page(ctx.states[key].pools, kind, src, dst)
