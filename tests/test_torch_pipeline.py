"""The port's GPipe ``pipeline_forward`` on a CPU process mesh of four
stages, against the reference's ``shard_map`` schedule on four host
devices and against the sequential application of the stages, within
1e-5. The stage function runs on the ranks, so it is sent by name from
``tests/test_torch_gspmd_ranks.py`` (torch only)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import test_torch_gspmd_ranks as ranks
from repro.parallel.pipeline import pipeline_forward as j_pipeline_forward
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.parallel import pipeline_forward

N_STAGES, MB, D = 4, 2, 8


@pytest.fixture(scope="module")
def mesh():
    m = make_host_mesh((N_STAGES,), ("stage",), devices=["cpu"] * N_STAGES)
    yield m
    m.close()


@pytest.mark.parametrize("n_micro", [1, 6])
def test_pipeline_matches_reference_and_sequential(mesh, n_micro):
    rng = np.random.default_rng(n_micro)
    ws = (rng.standard_normal((N_STAGES, D, D)) * 0.3).astype(np.float32)
    xs = rng.standard_normal((n_micro, MB, D)).astype(np.float32)
    jmesh = jax.make_mesh((N_STAGES,), ("stage",),
                          devices=jax.devices()[:N_STAGES],
                          axis_types=(jax.sharding.AxisType.Auto,))
    with jmesh:
        want = np.asarray(jax.jit(lambda w, x: j_pipeline_forward(
            lambda wl, xl: jnp.tanh(xl @ wl), w, x, jmesh))(
                jax.device_put(jnp.asarray(ws),
                               NamedSharding(jmesh, P("stage"))),
                jnp.asarray(xs)))
    got = pipeline_forward(ranks.stage_tanh, torch.from_numpy(ws),
                           torch.from_numpy(xs), mesh).numpy()
    seq = torch.from_numpy(xs)
    for s in range(N_STAGES):
        seq = ranks.stage_tanh(torch.from_numpy(ws[s]), seq)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, seq.numpy(), atol=1e-5, rtol=1e-5)
