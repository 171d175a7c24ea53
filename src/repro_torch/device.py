"""Explicit device choice for the port's entry points.

The port runs on the card unless the caller asks for the CPU: ``None``
resolves to ``"cuda"`` and raises when there is no CUDA device, so no entry
point ever drops to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; any other value is taken as given.

    Raises ``RuntimeError`` naming the missing CUDA device when a CUDA
    device is asked for (explicitly or by default) and none exists.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch entry points run on the card "
            "unless called with device='cpu'")
    return dev
