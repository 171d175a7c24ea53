"""Quantization policy: apply MSB PTQ to a params tree.

Port of ``repro.core.policy``, with its tensor-parallel planner
(``tp_partition_params``, ``tp_localize``) and ``tp_shard``, which cuts a
rank's slices (the counterpart of the reference's ``device_put`` with
``NamedSharding``s). A params tree is
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
                       quantize_pertensor, tp_pad_packed_k, tp_pad_packed_n,
                       tp_pad_q_k, tp_pad_q_n)


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


# ---------------------------------------------------------------------------
# Tensor-parallel planner (DESIGN.md Sec. 10)
# ---------------------------------------------------------------------------

def _is_q(x):
    return isinstance(x, (QTensor, PackedQTensor))


def _storage_n(leaf):
    """Stored output-dim width (incl. pack padding)."""
    return leaf.n_pad if isinstance(leaf, PackedQTensor) else \
        leaf.codes.shape[-1]


def _storage_k(leaf):
    a = leaf.packed if isinstance(leaf, PackedQTensor) else leaf.codes
    return a.shape[-2]


def _roundup(x, m):
    return -(-x // m) * m


def _leaf_spec(leaf, kind):
    """The spec subtree of one (marked) leaf: each tensor's sharded dim, or
    None where it is replicated. For a quantized leaf it is the same
    dataclass with its tensor fields replaced by those dims, so a spec tree
    walks leaf for leaf beside the params tree; the reference's
    ``PartitionSpec`` puts the mesh axis at the same dims."""
    if isinstance(leaf, PackedQTensor):
        pd, sd = leaf.packed.dim(), leaf.scales.dim()
        dims = {None: (None, None), "n": (pd - 1, sd - 2),
                "k": (pd - 2, sd - 3), "e": (pd - 3, sd - 4)}[kind]
        return dataclasses.replace(leaf, packed=dims[0], scales=dims[1])
    if isinstance(leaf, QTensor):
        cd, sd = leaf.codes.dim(), leaf.scales.dim()
        dims = {None: (None, None), "n": (cd - 1, sd - 2),
                "k": (cd - 2, sd - 3), "v": (cd - 2, sd - 3),
                "e": (cd - 3, sd - 4)}[kind]
        return dataclasses.replace(leaf, codes=dims[0], scales=dims[1])
    if kind == "n" and isinstance(leaf, torch.Tensor):   # column bias
        return leaf.dim() - 1
    return None


def _repl(node):
    if isinstance(node, dict):
        return {k: _repl(v) for k, v in node.items()}
    return _leaf_spec(node, None)


def _n_shardable_exact(leaf, tp):
    """Can this leaf's output dim split into whole per-rank blocks with NO
    padding (required for head-sharded attention projections)?"""
    if isinstance(leaf, PackedQTensor):
        return (not leaf.kblocked and leaf.n == leaf.n_pad
                and leaf.n_pad % (64 * tp) == 0)
    if isinstance(leaf, QTensor):
        return leaf.block == 64 and leaf.codes.shape[-1] % (64 * tp) == 0
    return False


def tp_partition_params(params, tp_size, cfg=None, verbose=False):
    """Partition a (quantized or packed) params tree for tensor parallelism:
    the reference's Megatron-style plan on MSB storage.

      * attention ``wq/wk/wv`` (and qkv biases) column-parallel along
        heads, ``wo`` row-parallel with a psum, only when every projection
        is quantized and the head counts divide ``tp_size`` with
        64-block-aligned per-rank widths (no padding inside a head);
        otherwise the layer replicates, and the paged path slices the
        computed heads of a head-sharded pool.
      * MLP ``wg/wi`` column-parallel, ``wo`` row-parallel; the hidden width
        is padded to a multiple of ``64 * tp_size`` with exact zeros.
      * MoE experts shard along the expert dim when it divides ``tp_size``
        (each rank runs its resident experts; the combine is a psum); the
        router replicates.
      * ``unembed`` shards along vocab (column-parallel logits, then an
        all-gather); ``embed`` and everything else replicates.

    Marks each sharded leaf's ``shard`` ("n", "k", "e" or "v") so the
    model code knows where to psum or gather. Returns ``(params, specs,
    report)``: ``specs`` names each tensor's sharded dim (``_leaf_spec``)
    and walks leaf for leaf beside ``params``; ``report`` maps group paths
    to what was done. ``tp_size == 1`` returns the tree unchanged."""
    report = {}
    tp = int(tp_size)

    def mark(leaf, kind):
        return dataclasses.replace(leaf, shard=kind) if _is_q(leaf) else leaf

    def attn_group(group, path):
        names = ("wq", "wk", "wv", "wo")
        ok = (tp > 1 and cfg is not None and not cfg.is_encdec
              and cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
              and all(_is_q(group.get(nm)) for nm in names)
              and all(_n_shardable_exact(group[nm], tp)
                      for nm in ("wq", "wk", "wv"))
              and _storage_k(group["wo"]) % tp == 0)
        if not ok:
            return dict(group), _repl(group)
        new, spec = {}, {}
        for key, leaf in group.items():
            kind = {"wq": "n", "wk": "n", "wv": "n", "wo": "k",
                    "bq": "n", "bk": "n", "bv": "n"}.get(key)
            new[key] = mark(leaf, kind)
            spec[key] = _leaf_spec(new[key], kind)
        report[path] = "heads"
        return new, spec

    def mlp_group(group, path):
        ws = ("wg", "wi", "wo")
        if tp <= 1 or not all(_is_q(group.get(w)) for w in ws) or any(
                isinstance(group[w], QTensor) and group[w].block != 64
                for w in ws):
            return dict(group), _repl(group)
        f_to = _roundup(max(_storage_n(group["wg"]), _storage_n(group["wi"])),
                        64 * tp)
        new, spec = {}, {}
        for key, leaf in group.items():
            if key in ("wg", "wi"):
                leaf = (tp_pad_packed_n(leaf, f_to)
                        if isinstance(leaf, PackedQTensor)
                        else tp_pad_q_n(leaf, f_to))
                kind = "n"
            elif key == "wo":
                leaf = (tp_pad_packed_k(leaf, f_to)
                        if isinstance(leaf, PackedQTensor)
                        else tp_pad_q_k(leaf, f_to))
                kind = "k"
            else:
                kind = None
            new[key] = mark(leaf, kind)
            spec[key] = _leaf_spec(new[key], kind)
        report[path] = f"column/row hidden->{f_to}"
        return new, spec

    def moe_group(group, path):
        ws = ("wg", "wi", "wo")
        ok = (tp > 1 and all(_is_q(group.get(w)) for w in ws)
              and all((group[w].codes if isinstance(group[w], QTensor)
                       else group[w].packed).dim() >= 3 for w in ws))
        if ok:
            wg = group["wg"]
            e = (wg.packed if isinstance(wg, PackedQTensor)
                 else wg.codes).shape[-3]
            ok = e % tp == 0
        if not ok:
            return dict(group), _repl(group)
        new, spec = {}, {}
        for key, leaf in group.items():
            kind = "e" if key in ws else None
            new[key] = mark(leaf, kind)
            spec[key] = _leaf_spec(new[key], kind)
        report[path] = "experts"
        return new, spec

    def unembed_leaf(leaf, path):
        if tp <= 1 or not _is_q(leaf):
            return leaf, _leaf_spec(leaf, None)
        if isinstance(leaf, PackedQTensor):
            if not leaf.kblocked:
                return leaf, _leaf_spec(leaf, None)
            v_to = _roundup(leaf.n_pad, 64 * tp)
            leaf = tp_pad_packed_n(leaf, v_to)
            kind = "n"
        else:
            if leaf.block == -1:
                return leaf, _leaf_spec(leaf, None)
            v_to = _roundup(leaf.codes.shape[-2], tp)
            leaf = tp_pad_q_k(leaf, v_to)
            kind = "v"
        report[path] = f"vocab->{v_to}"
        leaf = mark(leaf, kind)
        return leaf, _leaf_spec(leaf, kind)

    def walk(node, path):
        if not isinstance(node, dict):
            return node, _repl(node)
        new, spec = {}, {}
        for key, val in node.items():
            p = f"{path}/{key}" if path else key
            if key in ("attn", "xattn") and isinstance(val, dict):
                new[key], spec[key] = attn_group(val, p)
            elif key == "mlp" and isinstance(val, dict):
                new[key], spec[key] = mlp_group(val, p)
            elif key == "moe" and isinstance(val, dict):
                new[key], spec[key] = moe_group(val, p)
            elif key == "unembed":
                new[key], spec[key] = unembed_leaf(val, p)
            else:
                new[key], spec[key] = walk(val, p)
        return new, spec

    new_params, specs = walk(params, "")
    if verbose:
        for p, what in sorted(report.items()):
            print(f"  tp-sharded {p}: {what}")
    return new_params, specs, report


def tp_shard(params, specs, rank, size):
    """Rank ``rank``'s tree of ``size``: every sharded tensor cut to its
    ``rank``-th contiguous slice along the dim its spec names, as a
    contiguous copy (the kernels want contiguous, 16-byte aligned storage;
    a slice of the last dim is a strided view). Replicated tensors are the
    tree's own. Aux fields are kept: run ``tp_localize`` on the result."""
    def cut(t, dim):
        if dim is None:
            return t
        n = t.shape[dim] // size
        return t.narrow(dim, rank * n, n).clone(
            memory_format=torch.contiguous_format)

    def visit(node, spec):
        if isinstance(node, dict):
            return {k: visit(v, spec[k]) for k, v in node.items()}
        if isinstance(node, QTensor):
            return dataclasses.replace(node, codes=cut(node.codes, spec.codes),
                                       scales=cut(node.scales, spec.scales))
        if isinstance(node, PackedQTensor):
            return dataclasses.replace(
                node, packed=cut(node.packed, spec.packed),
                scales=cut(node.scales, spec.scales))
        if isinstance(node, torch.Tensor):
            return cut(node, spec)
        return node

    return visit(params, specs)


def tp_localize(params):
    """Rebind each n-sharded PackedQTensor's ``n`` to its local width (a
    rank's slice keeps the global padded width in aux), so
    ``packed_matmul`` does not slice past the shard. K-, expert- and
    vocab-sharded leaves keep their aux (their ``n`` is not the sharded
    dim)."""
    def visit(_path, leaf):
        if isinstance(leaf, PackedQTensor) and leaf.shard == "n":
            return dataclasses.replace(leaf, n=leaf.packed.shape[-1] * 2)
        return leaf
    return _walk(params, visit)
