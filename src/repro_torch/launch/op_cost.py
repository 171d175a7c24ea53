"""Per-op cost model of the port's dry-run: FLOPs, HBM bytes, collective
wire bytes and peak live memory of one call, counted op by op as torch
dispatches it.

Port of ``repro.launch.hlo_cost``. The reference reads these numbers
out of compiled HLO text and multiplies each ``while`` body by its trip
count. Torch has no HLO, and eager torch has no while loops: every layer
runs as Python, so counting each op at its dispatch counts every layer
as it runs, with no multipliers. ``count(fn, ...)`` runs ``fn`` under
``CostMode``, a ``TorchDispatchMode``, and returns a ``Cost`` with the
keys and units of ``hlo_cost.Cost``:

* **FLOPs.** The matmul family (``mm``, ``bmm``, ``addmm``, ``baddbmm``,
  convolution and SDPA, as ``torch.utils.flop_counter`` reckons them)
  counts ``2 * out * contracted``; data movement (views, copies, casts'
  copies, ``cat``, indexing, gathers and scatters, padding, factories)
  counts none; every other op counts 1 per output element. That is
  hlo_cost's rule (dots, then elementwise and reductions).
* **Bytes.** The tensor inputs and outputs of every op that
  materialises; views and ``empty`` write nothing and count none. An op
  that reads a slice of an operand (``index_select``, ``gather``,
  ``embedding``, ``index``) is charged the slice, and an in-place write
  into part of a buffer (``index_copy_``, ``index_put_``, ``scatter_``)
  the part written, as hlo_cost charges a dynamic slice or update.
  Eager torch has no fusion, so each op is an HBM round trip: this is an
  upper bound on what a fused program reads.
* **Collectives.** Each one is counted once, at its call, as the op it
  is, with ``roofline.py``'s wire factors: the raw collectives of
  ``parallel/sharding.py`` (and the autograd Functions built on them)
  call the dry-run's ``RecordingGroup`` in place of a ``GlooGroup``,
  which logs (op, result bytes, ranks) and returns a stand-in of the
  result's shape. A psum the port stages through an all-gather and a fold counts
  as the all-reduce it is. On a real mesh nothing of this runs.
* **Peak memory.** The largest sum of bytes live at once in storages
  that ops created during the call (the arguments' own storages
  excluded): temporaries and outputs alike.

The dry-run (``launch/dryrun.py``) runs the kernels' plain versions on
fake CPU tensors (``FakeTensorMode``), as the reference's dry-run
compiles its jnp path: no kernel launches, and no real tensor ever goes
through this path.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..core.quantize import map_tensors
from .roofline import parse_collectives

# ops that move data and compute nothing (hlo_cost counts no FLOPs for
# copies, concatenates, slices, gathers, scatters, pads or constants)
_MOVEMENT = frozenset("""
    clone copy copy_ _copy_from _copy_from_and_resize cat stack
    index index_select gather embedding take narrow_copy slice_copy
    index_put index_put_ _index_put_impl_ index_copy index_copy_
    scatter scatter_ slice_scatter select_scatter diagonal_scatter
    as_strided_scatter masked_scatter masked_scatter_ constant_pad_nd
    repeat expand_copy flip roll tril_indices triu_indices
    empty empty_like empty_strided new_empty new_empty_strided zeros
    zeros_like new_zeros ones ones_like new_ones full full_like new_full
    fill fill_ zero_ arange linspace scalar_tensor lift_fresh
    lift_fresh_copy _unsafe_view alias detach _to_copy to
    resize_ set_ _local_scalar_dense
""".split())
# ops that write nothing: a fresh buffer's contents are left undefined
_NO_WRITE = frozenset("empty empty_like empty_strided new_empty "
                      "new_empty_strided _unsafe_view alias detach "
                      "lift_fresh set_ resize_ _local_scalar_dense".split())
# ops that read a slice of their first operand: charged what they return
_READ_SLICE = frozenset("index index_select gather embedding take "
                        "narrow_copy slice_copy".split())
# in-place ops that write part of their first operand: charged their
# other operands (the part written and its indices)
_WRITE_PART = frozenset("index_put_ _index_put_impl_ index_copy_ "
                        "scatter_ scatter_add_ scatter_reduce_ index_add_ "
                        "masked_scatter_ index_fill_".split())


@dataclasses.dataclass
class Cost:
    """What ``count`` measured: ``flops``, HBM ``bytes``, ``coll`` per
    collective op {count, result_bytes, wire_bytes} (hlo_cost's keys),
    and ``peak_bytes``, the most bytes live at once in storages made
    during the call."""
    flops: float = 0.0
    bytes: float = 0.0
    coll: Dict[str, dict] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0

    @property
    def wire_bytes(self):
        return sum(r["wire_bytes"] for r in self.coll.values())


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def leaf_tensors(trees):
    """Every tensor of a sequence of params-like trees (``QTensor`` and
    ``PackedQTensor`` leaves opened)."""
    out = []
    for tree in trees:
        if isinstance(tree, (list, tuple)):
            out += leaf_tensors(tree)
        else:
            map_tensors(lambda t: out.append(t) or t, tree)
    return out


def _nbytes(t):
    return t.numel() * t.element_size()


def op_flops(func, args, kwargs, out):
    """FLOPs of one aten op, by the module's rule."""
    packet = func._overloadpacket
    if packet in flop_registry:
        return float(flop_registry[packet](*args, out_val=out, **kwargs))
    name = packet.__name__
    if func.is_view or name in _MOVEMENT:
        return 0.0
    return float(sum(t.numel() for t in _tensors(out)))


def op_bytes(func, args, kwargs, out):
    """HBM bytes of one aten op, by the module's rule."""
    name = func._overloadpacket.__name__
    if func.is_view or name in _NO_WRITE:
        return 0.0
    ins = _tensors((args, kwargs))
    outs = _tensors(out)
    if not outs:               # a query of metadata (device, size)
        return 0.0
    if name in _READ_SLICE and ins:
        return float(2 * sum(map(_nbytes, outs))
                     + sum(map(_nbytes, ins[1:])))
    if name in _WRITE_PART and ins:
        return float(2 * sum(map(_nbytes, ins[1:])))
    mutated = func._schema.arguments[0].alias_info if \
        func._schema.arguments else None
    if mutated is not None and mutated.is_write and ins:
        # self read (unless overwritten whole) and written once
        reads = ins[1:] if name in ("copy_", "fill_", "zero_") else ins
        return float(sum(map(_nbytes, reads)) + _nbytes(ins[0]))
    return float(sum(map(_nbytes, ins)) + sum(map(_nbytes, outs)))


class CostMode(TorchDispatchMode):
    """Counts every aten op dispatched inside it (``Cost``); ``known``
    are trees of tensors whose storages already exist (the call's
    arguments), which the live-bytes count leaves out."""

    def __init__(self, known=()):
        super().__init__()
        self.cost = Cost()
        self._seen = weakref.WeakSet()
        self._refs = {}
        self._live = 0
        for t in leaf_tensors(known):
            self._seen.add(t.untyped_storage())

    def _freed(self, nbytes, ref):
        self._live -= nbytes
        self._refs.pop(id(ref), None)

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            ref = weakref.ref(st, lambda r, n=n: self._freed(n, r))
            self._refs[id(ref)] = ref
            self._live += n
        self.cost.peak_bytes = max(self.cost.peak_bytes, self._live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.cost.flops += op_flops(func, args, kwargs, out)
        self.cost.bytes += op_bytes(func, args, kwargs, out)
        self._track(out)
        return out


def count(fn, *args, log=None, **kwargs):
    """``fn(*args, **kwargs)`` under a ``CostMode``: (its result, the
    ``Cost``). ``log`` is the list the call's ``dryrun.RecordingGroup``s
    append their collectives to."""
    mode = CostMode(known=(args, kwargs))
    with mode:
        out = fn(*args, **kwargs)
    mode.cost.coll = parse_collectives(log or [])
    return out, mode.cost
