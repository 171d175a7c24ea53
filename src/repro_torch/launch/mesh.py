"""The serving engines' tensor-parallel mesh.

Port of ``repro.launch.mesh.make_tp_mesh``: a 1-D ``("model",)`` mesh of
``tp_size`` ranks, one process a rank (``parallel/spmd.py``). This
process is rank 0; the others are worker processes it spawns. The
production and host meshes of the reference (``make_production_mesh``,
``make_host_mesh``) belong to its GSPMD path (ROADMAP §1 item 11).
"""
from __future__ import annotations

import torch

from ..parallel.spmd import TPMesh


def make_tp_mesh(tp_size, devices=None) -> TPMesh:
    """A mesh of ``tp_size`` ranks. ``devices=None`` puts rank r on card r
    and refuses when there are fewer cards, as the reference refuses
    ("tp=N needs N devices"); an explicit list places the ranks, e.g.
    ``["cpu"] * tp`` or two ranks on one card, ``["cuda:0", "cuda:0"]``.
    Nothing chooses the CPU on its own. Every kernel is built here, before
    the workers start, so two ranks on one card never run nvcc at once. A
    worker on a card runs one intra-op host thread (its work is on the
    card), one on the CPU this process's count."""
    tp_size = int(tp_size)
    if tp_size < 1:
        raise ValueError(f"tp_size must be >= 1, got {tp_size}")
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if tp_size > have:
            raise ValueError(f"tp={tp_size} needs {tp_size} devices, "
                             f"have {have} CUDA devices (pass devices= to "
                             "place the ranks)")
        devices = [f"cuda:{r}" for r in range(tp_size)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != tp_size:
        raise ValueError(f"tp={tp_size} needs {tp_size} devices, got "
                         f"{len(devices)}")
    for d in devices:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for rank on {d}")
    if any(d.type == "cuda" for d in devices):
        from ..kernels import _build
        _build.build_all()
    return TPMesh(devices)
