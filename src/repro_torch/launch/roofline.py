"""Roofline terms of a dry-run cell, for the H100.

Port of ``repro.launch.roofline``. Three terms per (arch x shape x
mesh), each in seconds, from one rank's counts (``launch/op_cost.py``):

    compute    = FLOPs a rank / PEAK_FLOPS_BF16
    memory     = HBM bytes a rank / HBM_BW
    collective = collective wire bytes a rank / ICI_BW

with the H100 SXM5's datasheet figures (``launch/mesh.py``). These are
modelled times, not measured ones. Collective wire bytes follow the
reference's per-op factors:

    all-reduce          2 (n-1)/n * size
    all-gather          (n-1)/n * output size
    reduce-scatter      (n-1)   * output size     (input = n * output)
    all-to-all          (n-1)/n * size
    collective-permute  1       * size

The reference also keeps XLA's own ``cost_analysis()`` figures as
``xla_*`` cross-checks. Torch has no compiler cost analysis to compare
with, so the port's ``xla_*`` values are None (null in the record).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .mesh import HBM_BW, ICI_BW, PEAK_FLOPS_BF16


def wire_bytes(op, size, n):
    """The bytes one rank sends for collective ``op`` with a result of
    ``size`` bytes over ``n`` ranks."""
    n = max(n, 2)
    if op == "all-reduce":
        return 2.0 * size * (n - 1) / n
    if op in ("all-gather", "all-to-all"):
        return size * (n - 1) / n
    if op == "reduce-scatter":
        return float(size) * (n - 1)
    return float(size)          # collective-permute


def parse_collectives(log) -> Dict[str, dict]:
    """Per-op result bytes and wire bytes from a recorder's log of
    (op, result bytes, ranks) entries (``dryrun.RecordingGroup``): the
    port's counterpart of the reference's parse of the compiled HLO."""
    out: Dict[str, dict] = {}
    for op, size, n in log:
        rec = out.setdefault(op, {"count": 0, "result_bytes": 0,
                                  "wire_bytes": 0.0})
        rec["count"] += 1
        rec["result_bytes"] += size
        rec["wire_bytes"] += wire_bytes(op, size, n)
    return out


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    collectives: Dict[str, dict]
    model_flops_total: float
    chips: int
    xla_flops_per_chip: Optional[float] = None
    xla_bytes_per_chip: Optional[float] = None

    @property
    def compute_s(self):
        return self.flops_per_chip / PEAK_FLOPS_BF16

    @property
    def memory_s(self):
        return self.bytes_per_chip / HBM_BW

    @property
    def collective_s(self):
        return self.wire_bytes_per_chip / ICI_BW

    @property
    def bottleneck(self):
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self):
        """MODEL_FLOPS / counted FLOPs: recompute and dispatch waste."""
        total = self.flops_per_chip * self.chips
        return self.model_flops_total / total if total else 0.0

    @property
    def roofline_fraction(self):
        """Useful compute time over the largest term (perfect overlap)."""
        bound = max(self.compute_s, self.memory_s, self.collective_s)
        ideal = (self.model_flops_total / self.chips) / PEAK_FLOPS_BF16
        return ideal / bound if bound else 0.0

    def to_dict(self):
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "collectives": self.collectives,
            "model_flops_total": self.model_flops_total,
            "chips": self.chips,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "xla_flops_per_chip": self.xla_flops_per_chip,
            "xla_bytes_per_chip": self.xla_bytes_per_chip,
        }


def build(cost, model_flops_total, chips):
    """The ``Roofline`` of one rank's ``op_cost.Cost``."""
    return Roofline(flops_per_chip=cost.flops, bytes_per_chip=cost.bytes,
                    wire_bytes_per_chip=cost.wire_bytes,
                    collectives=cost.coll,
                    model_flops_total=model_flops_total, chips=chips)
