"""Parallelism of the port (``repro.parallel``): the manual tensor-
parallel data plane of serving (``TPShard``), the GSPMD-style context of
training (``ParallelContext``, the resolver, placements and the
collectives with their transposes), GPipe pipelining, and the
controller/worker protocol that runs them one process a rank
(``spmd``)."""
from .pipeline import pipeline_forward
from .sharding import (NamedSharding, ParallelContext, Sharded, TPShard,
                       constraint, device_put, from_mesh, gather,
                       resolve_spec, tree_shardings)

__all__ = ["NamedSharding", "ParallelContext", "Sharded", "TPShard",
           "constraint", "device_put", "from_mesh", "gather",
           "pipeline_forward", "resolve_spec", "tree_shardings"]
