"""Shared set-up of the GSPMD tests (``tests/test_torch_gspmd*.py``): the
port's CPU meshes, one alive at a time (``mesh(shape)`` closes the last
one when another shape is asked for; ``close_meshes`` at a module's end),
the reference's mesh of a shape over the first N host devices, the smoke
configs (MoE at 8 experts) and batches."""
import dataclasses

import jax
import numpy as np

from repro.configs import smoke_config as j_smoke_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.launch.mesh import make_host_mesh

B, S = 8, 32
_MESH = {}


def mesh(shape, axes=("data", "model")):
    """The port's CPU mesh of ``shape`` (the last one closed first)."""
    key = (tuple(shape), tuple(axes))
    if key not in _MESH:
        close_meshes()
        _MESH[key] = make_host_mesh(shape, axes,
                                    devices=["cpu"] * int(np.prod(shape)))
    return _MESH[key]


def close_meshes():
    for m in _MESH.values():
        m.close()
    _MESH.clear()


def j_mesh(shape, axes=("data", "model")):
    """The reference's mesh of ``shape`` over the first N host devices."""
    n = int(np.prod(shape))
    return jax.make_mesh(shape, axes, devices=jax.devices()[:n],
                         axis_types=(jax.sharding.AxisType.Auto,) * len(axes))


def smoke(arch):
    """(the reference's, the port's) smoke config, MoE at 8 experts."""
    jc, tc = j_smoke_config(arch), t_smoke_config(arch)
    if jc.n_experts:
        jc = dataclasses.replace(jc, n_experts=8)
        tc = dataclasses.replace(tc, n_experts=8)
    return jc, tc


def batch(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32)}


def leaves(tree, path=()):
    """(path tuple, leaf) of a nested dict in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree
