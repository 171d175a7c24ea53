"""Tensor parallelism for serving: the manual data plane (``TPShard``) and
the controller/worker protocol that runs it one process a rank
(``spmd``). Port of the manual-TP half of ``repro.parallel``."""
from .sharding import TPShard

__all__ = ["TPShard"]
