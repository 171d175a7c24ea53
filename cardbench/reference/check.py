"""The reference's side of the correctness check.

``quantize_and_compare`` works the MSB codes and codebooks out again from
the raw weights (``msb.py``), packs them as the kernels' format states,
and counts every byte of codes and every codebook entry in which the
program's packed leaf differs; it returns the reference's dense f32
weights for the forward (``model.py``). The program's leaves are only
read, to be judged.
"""
from __future__ import annotations

import torch

from . import msb

EXCLUDE = ("norm", "router")


def quantized(path, t, block):
    return (t.dim() >= 2 and not any(x in path for x in EXCLUDE)
            and t.shape[-1] % block == 0)


def _unpack_by_slice(packed, scales, n, kblocked):
    """Dense f32 weights of a packed leaf, one leading slice at a time so
    the int64 levels of a stacked leaf never exist whole."""
    if packed.dim() <= 2:
        return msb.unpack(packed, scales, n, kblocked)
    return torch.stack([_unpack_by_slice(p, s, n, kblocked)
                        for p, s in zip(packed, scales)])


def quantize_and_compare(raw, program_leaves, bits=4, block=64):
    """(mismatches, missing, dense weights): the bytes of packed codes
    plus the codebook entries in which the program's leaves differ from
    the reference's, the quantized leaves the program does not hold, and
    the reference's f32 weights {path: tensor} in matmul orientation
    (the untied table as ``unembed_dv``, (D, V_padded))."""
    mismatches, missing, W = 0, 0, {}
    for path, t in raw.items():
        if not quantized(path, t, block):
            W[path] = t.to(torch.float32)
            continue
        codes, scales = msb.quantize(t, bits, block)
        transpose = path == "unembed" and t.dim() == 2
        packed, scales, n = msb.pack(codes, scales, transpose)
        del codes
        prog = program_leaves.get(path)
        if prog is None:
            missing += 1
        else:
            pp, ps = prog[0], prog[1]
            if pp.shape != packed.shape or ps.shape != scales.shape:
                mismatches += packed.numel() + scales.numel()
            else:
                mismatches += int((pp != packed).sum()) + int(
                    (ps != scales).sum())
        W["unembed_dv" if transpose else path] = _unpack_by_slice(
            packed, scales, n, transpose)
        del packed, scales
    return mismatches, missing, W
