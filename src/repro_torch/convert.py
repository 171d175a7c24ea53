"""Carry a params, page-pool or cache tree of the JAX package across to the
port.

``from_reference(tree, device)`` turns the reference's params tree (nested
dicts of arrays and ``QTensor`` / ``PackedQTensor`` leaves) into the port's,
a page-pool tree from ``Model.init_paged_pools`` into the port's pools, and
a static ring cache (``Model.prefill`` / ``init_cache``: ``layers/s0/attn/
{k,v}`` and int32 ``pos``) into the port's cache, with each leaf's dtype
kept (kv16 pools and caches; or int8/uint8 codes, f32/bf16 scales and hot
rows of quantized pools). ``from_reference_state`` carries a train state
({"params", "opt": {"m", "v", "step"}}, f32 or int8 moments) across, so
the two packages' steps, sharded or not, start from the same numbers.
Leaves are duck-typed on their attributes — ``codes/scales/bits/block`` or
``packed/scales/n/kblocked`` — and read with ``numpy.asarray``, so this
module imports neither ``jax`` nor ``repro``. bf16 arrays come out of numpy
as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` rejects; they go
through float32 (exact) and then to ``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.quantize import PackedQTensor, QTensor
from .device import resolve_device

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "int8": torch.int8, "uint8": torch.uint8,
                 "int32": torch.int32}


def torch_dtype(dtype) -> torch.dtype:
    """A numpy/jnp dtype (or dtype-like scalar type) -> torch dtype."""
    return _TORCH_DTYPES[np.dtype(dtype).name]


def to_tensor(a, device) -> torch.Tensor:
    """Array-like -> torch tensor on ``device``, dtype preserved."""
    arr = np.asarray(a)
    dt = torch_dtype(arr.dtype)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(
        device=device, dtype=dt)


def from_reference(tree, device=None):
    """The reference's params (or page-pool) tree as the port's, on
    ``device`` (``None`` = the card)."""
    dev = resolve_device(device)

    def visit(node):
        if isinstance(node, dict):
            return {k: visit(v) for k, v in node.items()}
        if all(hasattr(node, a) for a in ("packed", "scales", "n",
                                          "kblocked")):
            return PackedQTensor(to_tensor(node.packed, dev),
                                 to_tensor(node.scales, dev), int(node.bits),
                                 int(node.block), torch_dtype(node.dtype),
                                 int(node.n), bool(node.kblocked),
                                 getattr(node, "shard", None))
        if all(hasattr(node, a) for a in ("codes", "scales", "bits",
                                          "block")):
            return QTensor(to_tensor(node.codes, dev),
                           to_tensor(node.scales, dev), int(node.bits),
                           int(node.block), torch_dtype(node.dtype),
                           getattr(node, "shard", None))
        return to_tensor(node, dev)

    return visit(tree)


def from_reference_state(state, device=None):
    """The reference's train state as the port's: params and f32 moments
    as tensors, int8 moments as {"q" int8 | uint8 codes, "s" bf16 | f32
    scales} (the reference's ``-inf`` log-max of an all-zero block kept),
    ``step`` a 0-d int32 tensor; on ``device`` (``None`` = the card)."""
    out = from_reference(state, device)
    if out["opt"]["step"].dtype != torch.int32:
        raise ValueError("the train state's step must be int32")
    return out
