"""Meshes of the port, one process a rank (``parallel/spmd.py``).

Port of ``repro.launch.mesh``:

* ``make_tp_mesh``: the serving engines' 1-D ``("model",)`` mesh;
* ``make_host_mesh``: a small mesh with named axes over the cards (or
  CPU ranks) of this host, the reference's default shape rule; training
  under a ``ParallelContext`` runs on it;
* ``make_production_mesh``: the reference's single-pod (16, 16)
  ("data", "model") and multi-pod (2, 16, 16) ("pod", "data", "model")
  meshes, which need 256 and 512 cards and refuse with fewer.

This process is rank 0 of every mesh; the others are worker processes it
spawns. Nothing chooses the CPU on its own.

The dry-run's roofline (``launch/roofline.py``) reads the card's rates
below: NVIDIA H100 SXM5 80GB at 700 W, from NVIDIA's H100 Tensor Core GPU
datasheet. ``ICI_BW`` keeps the reference's name for its one
interconnect figure; here it is NVLink 4's, between the cards of one
host. A mesh across hosts goes over InfiniBand, which is slower (NDR
400 Gb/s, 50 GB/s a port), and the figure then overstates its rate.
"""
from __future__ import annotations

import math

import torch

from ..parallel.spmd import ProcessMesh, TPMesh


def _cards():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _place(n, devices, what):
    """``n`` rank devices: card r for rank r when ``devices`` is None
    (refused with fewer cards), else ``devices`` as given."""
    if devices is None:
        have = _cards()
        if n > have:
            raise ValueError(f"{what} needs {n} devices, have {have} CUDA "
                             "devices (pass devices= to place the ranks)")
        devices = [f"cuda:{r}" for r in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{what} needs {n} devices, got {len(devices)}")
    for d in devices:
        if d.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for rank on {d}")
    if any(d.type == "cuda" for d in devices):
        from ..kernels import _build
        _build.build_all()
    return devices


def make_tp_mesh(tp_size, devices=None) -> TPMesh:
    """A mesh of ``tp_size`` ranks. ``devices=None`` puts rank r on card r
    and refuses when there are fewer cards, as the reference refuses
    ("tp=N needs N devices"); an explicit list places the ranks, e.g.
    ``["cpu"] * tp`` or two ranks on one card, ``["cuda:0", "cuda:0"]``.
    Every kernel is built here, before the workers start, so two ranks on
    one card never run nvcc at once. A worker on a card runs one intra-op
    host thread (its work is on the card), one on the CPU this process's
    threads divided by the ranks (the ranks share the host)."""
    tp_size = int(tp_size)
    if tp_size < 1:
        raise ValueError(f"tp_size must be >= 1, got {tp_size}")
    return TPMesh(_place(tp_size, devices, f"tp={tp_size}"))


def make_host_mesh(shape=None, axes=("data", "model"),
                   devices=None) -> ProcessMesh:
    """A mesh with named ``axes`` over this host. ``shape`` None takes the
    reference's rule over the ranks available: ``len(devices)``, else the
    cards here. ``devices`` places the ranks (row-major over ``shape``),
    e.g. ``["cpu"] * 4`` or four ranks on one card; None puts rank r on
    card r and refuses with fewer cards. A CPU worker rank runs this
    process's intra-op threads divided by the ranks (the ranks share the
    host), a card's one."""
    if shape is None:       # the reference's rule: (n // 2, 2), or (1, 1)
        n = len(devices) if devices is not None else _cards()
        shape = (max(n // 2, 1), 2) if n >= 2 else (1, 1)
    shape = tuple(int(x) for x in shape)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not fit axes {axes}")
    n = math.prod(shape)
    return ProcessMesh(shape, axes, _place(n, devices, f"mesh {shape}"))


def make_production_mesh(*, multi_pod: bool = False) -> ProcessMesh:
    """The reference's production mesh: (16, 16) ("data", "model"), or
    with ``multi_pod`` (2, 16, 16) ("pod", "data", "model"); one card a
    rank, refused where there are fewer cards ("needs 256 devices, have
    N")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    have = _cards()
    if n > have:
        raise ValueError(f"make_production_mesh{shape} needs {n} devices, "
                         f"have {have}")
    return make_host_mesh(shape, axes)


# NVIDIA H100 SXM5 80GB (700 W), NVIDIA's H100 datasheet: the roofline's
# rates for one card
PEAK_FLOPS_BF16 = 989.4e12      # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # HBM3 bytes/s
ICI_BW = 450e9                  # NVLink 4 bytes/s a direction: 18 x 25 GB/s
