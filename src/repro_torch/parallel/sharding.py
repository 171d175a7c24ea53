"""The manual tensor-parallel context and its collectives.

Port of ``repro.parallel.sharding.TPShard``. Where the reference runs the
serving data plane inside one ``shard_map`` (one process, collectives
between devices), the port runs one process a rank (``parallel/spmd.py``)
and each rank's model code issues its own collectives on a gloo process
group: ``psum`` after a row-parallel (K-sharded) matmul and over the MoE
combine, ``all_gather`` over heads or vocab shards. A model function that
gets a ``TPShard`` as ``parallel=`` runs on its rank's shard of the
weights and of the KV pools.

Gloo's collectives run through host memory: a CUDA tensor is staged
through it explicitly (a copy to the host, the collective, a copy back).
The arithmetic stays on the tensor's device: ``psum`` gathers the ranks'
partial tensors (exact copies) and adds them there, in rank order, so the
sum is bit-identical on every rank and does not depend on gloo's
reduction order. Every collective runs under the process group's timeout:
a rank that died fails the call instead of hanging it.
"""
from __future__ import annotations

import dataclasses

import torch


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

    def _gather(self, x):
        """Every rank's ``x`` as host tensors, in rank order."""
        h = x.detach().to("cpu").contiguous()
        parts = [torch.empty_like(h) for _ in range(self.size)]
        self.group.allgather([parts], [h]).wait()
        return parts

    def all_gather(self, x, dim=-1):
        """Tiled all-gather: the ranks' ``x`` concatenated along ``dim``
        in rank order, on ``x``'s device."""
        if self.size == 1:
            return x
        return torch.cat([p.to(x.device) for p in self._gather(x)],
                         dim=dim)

    def psum(self, x):
        """The sum of every rank's ``x`` (same shape and dtype), added on
        ``x``'s device in rank order: identical on every rank."""
        if self.size == 1:
            return x
        parts = self._gather(x)
        total = parts[0].to(x.device)
        for part in parts[1:]:
            total = total + part.to(x.device)
        return total
