"""Quantization policy: apply MSB PTQ to a params tree.

Port of ``repro.core.policy`` (tensor parallelism aside). A params tree is
a nested dict of tensors; paths are the ``/``-joined dict keys, exactly as
in the reference, so ``QuantPolicy`` regexes select the same leaves.
Block-wise, stacked per-layer params (leading ``L`` dim) quantize as one
batch of blocks — blocks never straddle rows, so the grouping equals
per-layer quantization. Per-tensor (``block=-1``), a stacked leaf gets one
codebook per leading-dim slice, scales ``(L, 1, g)``, as the reference's
``vmap`` gives.
"""
from __future__ import annotations

import dataclasses
import re

import torch

from ..device import resolve_device
from .quantize import (PackedQTensor, QTensor, dequantize, double_quantize,
                       map_tensors, pack_qtensor, quantize_blockwise,
                       quantize_pertensor)


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    bits: int = 4
    block: int = 64              # -1 => per-tensor
    solver: str = "dp"           # dp | kmeans | wdp | wgm | gg | dg | wgm_lo
    lam: float = 0.0
    include: str = r".*"
    exclude: str = (r".*(norm|scale_param|bias|ln|rope|router|conv_w|"
                    r"dt_bias|a_log|d_skip|f_bias|w_rec).*")
    min_size: int = 1 << 12      # skip tiny leaves (norm scales etc.)
    double_quant: bool = False

    def selects(self, path: str, leaf) -> bool:
        if (not isinstance(leaf, torch.Tensor) or leaf.dim() < 2
                or leaf.numel() < self.min_size):
            return False
        if re.match(self.exclude, path, re.I):
            return False
        if self.block != -1 and leaf.shape[-1] % abs(self.block):
            return False
        return re.match(self.include, path, re.I) is not None


def _walk(tree, visit, path=""):
    if isinstance(tree, dict):
        return {k: _walk(v, visit, f"{path}/{k}" if path else str(k))
                for k, v in tree.items()}
    return visit(path, tree)


def quantize_params(params, policy: QuantPolicy = QuantPolicy(), *,
                    device=None, verbose=False):
    """Rewrite matching leaves of ``params`` as ``QTensor``, solving on
    ``device`` (``None`` = the card). Every tensor of the returned tree
    lies on that device. Per-tensor (``block=-1``) maps the ``"dp"`` solver
    to ``"wdp"``; ``double_quant`` quantizes each scale table once more.
    Returns (tree, report)."""
    dev = resolve_device(device)
    report = {}

    def visit(path, leaf):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.to(dev)
        if isinstance(leaf, (QTensor, PackedQTensor)) or not policy.selects(
                path, leaf):
            return map_tensors(lambda t: t.to(dev), leaf)
        if policy.block == -1:
            q = _quantize_pertensor_stacked(leaf, policy)
        else:
            q = quantize_blockwise(leaf, bits=policy.bits,
                                   block=policy.block, solver=policy.solver,
                                   lam=policy.lam)
        if policy.double_quant:
            q = double_quantize(q)
        report[path] = (tuple(leaf.shape), policy.bits)
        if verbose:
            print(f"  quantized {path}: {tuple(leaf.shape)} -> "
                  f"{policy.bits}b/"
                  f"{'tensor' if policy.block == -1 else policy.block}")
        return q

    return _walk(params, visit), report


def _quantize_pertensor_stacked(leaf, policy):
    """Per-tensor MSB of one leaf; a leaf with ``ndim >= 3`` (stacked
    layers) gets one codebook per leading-dim slice, scales (L, 1, g)."""
    solver = "wdp" if policy.solver == "dp" else policy.solver
    if leaf.dim() < 3:
        return quantize_pertensor(leaf, bits=policy.bits, solver=solver,
                                  lam=policy.lam)
    qs = [quantize_pertensor(w, bits=policy.bits, solver=solver,
                             lam=policy.lam) for w in leaf]
    return QTensor(torch.stack([q.codes for q in qs]),
                   torch.stack([q.scales for q in qs]), policy.bits, -1,
                   leaf.dtype)


def pack_params(params, *, device=None, verbose=False):
    """QTensor leaves -> PackedQTensor, once at load (packed execution).

    The ``unembed`` table packs *transposed* (k-blocked scales) so the
    unembedding projection runs through the msb_matmul kernel; ``embed``
    packs in natural orientation for the row-gather path. Leaves the pass
    cannot pack (other bit-widths, plain tensors) stay as they are. The
    tree lands on ``device`` (``None`` = the card). Returns (tree, report).
    """
    dev = resolve_device(device)
    report = {}

    def visit(path, leaf):
        leaf = map_tensors(lambda t: t.to(dev), leaf)
        if not isinstance(leaf, QTensor):
            return leaf
        if leaf.bits != 4 or leaf.block != 64:
            return leaf
        transpose = path == "unembed" and leaf.codes.dim() == 2
        pq = pack_qtensor(leaf, transpose=transpose)
        report[path] = (leaf.shape, "kblocked" if transpose else "nblocked")
        if verbose:
            print(f"  packed {path}: {leaf.shape} -> "
                  f"{'transposed/kblocked' if transpose else 'nblocked'} "
                  f"uint8 {tuple(pq.packed.shape)}")
        return pq

    return _walk(params, visit), report


def dequantize_params(params, dtype=None):
    """Materialize all quantized leaves back to dense tensors. Packed
    leaves come back in their original orientation."""
    def visit(_path, leaf):
        if isinstance(leaf, PackedQTensor):
            w = leaf.dequantize()
            if leaf.kblocked:
                w = w.t()
        elif isinstance(leaf, QTensor):
            w = dequantize(leaf)
        else:
            return leaf
        return w.to(dtype) if dtype is not None else w
    return _walk(params, visit)


def param_bits(params):
    """Total storage bits of a (possibly mixed) params tree. Packed leaves
    report their allocated footprint: uint8 packed codes (8 bits a byte)
    plus the scale table, N-padding included; QTensor leaves count
    ``bits`` per code."""
    total = 0

    def visit(_path, leaf):
        nonlocal total
        if isinstance(leaf, PackedQTensor):
            total += (leaf.packed.numel() * 8
                      + leaf.scales.numel() * leaf.scales.element_size() * 8)
        elif isinstance(leaf, QTensor):
            total += (leaf.codes.numel() * leaf.bits
                      + leaf.scales.numel() * leaf.scales.element_size() * 8)
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size() * 8
        return leaf

    _walk(params, visit)
    return total
