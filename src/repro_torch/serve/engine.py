"""Execution-mode resolution shared by the serving engines.

Port of ``repro.serve.engine.resolve_execution``. The port has one
execution mode, ``"packed"``: QTensor leaves are rewritten once at load
into kernel-layout ``PackedQTensor``s, so every forward streams 4-bit codes
through the msb_matmul kernel. The static ``ServeEngine`` is ROADMAP
item 10.
"""
from __future__ import annotations


def resolve_execution(execution, params, device):
    """Resolve ``execution`` (``None`` = ``"packed"``) and pack ``params``
    onto ``device``. Returns (execution, params)."""
    if execution is None:
        execution = "packed"
    if execution == "simulated":
        raise NotImplementedError(
            "execution='simulated' (per-call dequantize) is not ported; "
            "ROADMAP item 6 lists it with the engine's remaining options")
    if execution != "packed":
        raise ValueError(f"execution must be 'packed', got {execution!r}")
    from ..core.policy import pack_params
    params, _ = pack_params(params, device=device)
    return execution, params
