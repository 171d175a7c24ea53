"""GSPMD-style training of the port on CPU process meshes, against the
reference's GSPMD results on the host devices ``tests/conftest.py``
forces.

The port's meshes are CPU ranks (``make_host_mesh(shape,
devices=["cpu"] * n)``), one process a rank; functions the ranks run live
in ``tests/test_torch_gspmd_ranks.py`` (torch only). One mesh is alive at
a time (``torch_gspmd_setup.mesh``); the reference's mesh of a shape
takes the first N host devices. Both sides start from the reference's
numbers (``repro_torch.convert``). The train step is held in
``tests/test_torch_gspmd_train.py``.

* ``resolve_spec`` and the state's axes trees equal the reference's,
  entry for entry, over its rule cases and every param leaf of every
  arch's full config on (4, 2), (2, 2), (1, 3) and (2, 16, 16) (shapes
  only: the resolver reads a mesh's axis sizes);
* ``Model.loss`` under a ``ParallelContext`` within 1e-5 relative of the
  reference's jitted GSPMD loss at the same mesh shape: qwen, granite-moe
  (8 experts, the expert-parallel all_to_all) and jamba on (2, 2), and
  internlm2 on (1, 4), where ``n_kv_heads = 2`` does not divide the four
  ranks and S = 128 passes ``use_cp``: context-parallel attention;
* the expert-parallel ``moe_layer`` within 1e-5 of the largest |y| of the
  reference's, and within the reference test's 5e-4 / 5e-3 of the port's
  one-device layer;
* ``psum_compressed`` on a ("data",) mesh of 4 ranks: the mean bitwise
  the reference's under ``shard_map`` on 4 devices (the residual within
  1e-6 of max |g|: XLA fuses its multiply-subtract);
* SP: the residual stream between blocks is S/tp rows long on each rank
  where S % tp == 0, whole otherwise.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

import test_torch_gspmd_ranks as ranks
import torch_gspmd_setup as setup
from repro.configs import get_config as j_get_config
from repro.configs import list_archs
from repro.configs import smoke_config as j_smoke_config
from repro.models import Model as JModel
from repro.models.moe import moe_layer as j_moe_layer
from repro.parallel import from_mesh as j_from_mesh
from repro.parallel import resolve_spec as j_resolve_spec
from repro.parallel import tree_shardings as j_tree_shardings
from repro.train import AdamW as JAdamW
from repro.train import OptConfig as JOptConfig
from repro.train.compression import psum_compressed as j_psum_compressed
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import smoke_config as t_smoke_config
from repro_torch.convert import from_reference
from repro_torch.launch.mesh import make_production_mesh, make_tp_mesh
from repro_torch.models import Model as TModel
from repro_torch.models.moe import moe_layer
from repro_torch.parallel import sharding as shd
from repro_torch.train import AdamW, OptConfig, state_axes

@pytest.fixture(autouse=True, scope="module")
def _close_meshes():
    yield
    setup.close_meshes()


# -- the resolver ---------------------------------------------------------

RULE_CASES = [  # the reference's tests/test_distributed.py cases on (4, 2)
    (("fsdp", "tp"), (8, 16)), (("fsdp", "tp"), (3, 16)),
    (("batch", "kv_seq"), (8, 64)), (("batch", "kv_seq"), (1, 64)),
    (("batch", "kv_seq"), (8, 3)),
    (("batch", None, "heads", "head_dim"), (8, 4, 3, 16)),
]
MESHES = {"4x2": ((4, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "1x3": ((1, 3), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _contexts(name):
    mesh = shd.MeshShape(*MESHES[name])
    return shd.from_mesh(mesh), j_from_mesh(mesh)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolve_spec_matches_reference(mesh):
    """Every rule case and every param leaf of every arch's full config:
    the port's spec is ``tuple`` of the reference's ``PartitionSpec``."""
    tctx, jctx = _contexts(mesh)
    assert (tctx.dp_axes, tctx.tp_axis, tctx.fsdp_axis) == \
        (jctx.dp_axes, jctx.tp_axis, jctx.fsdp_axis)
    assert (tctx.dp_size, tctx.tp_size, tctx.n_devices) == \
        (jctx.dp_size, jctx.tp_size, jctx.n_devices)
    for axes, shape in RULE_CASES:
        assert shd.resolve_spec(axes, shape, tctx) == \
            tuple(j_resolve_spec(axes, shape, jctx)), (axes, shape)
    for arch in list_archs():
        jm, tm = JModel(j_get_config(arch)), TModel(t_get_config(arch))
        jax_ = dict(setup.leaves(jm.param_axes()))
        shapes = dict(setup.leaves(jax.tree_util.tree_map(
            lambda s: tuple(s.shape), jm.param_shapes())))
        assert dict(setup.leaves(tm.param_axes())) == jax_
        assert dict(setup.leaves(tm.param_shapes())) == shapes
        for path, axes in jax_.items():
            assert shd.resolve_spec(axes, shapes[path], tctx) == tuple(
                j_resolve_spec(axes, shapes[path], jctx)), (arch, path)


def test_production_mesh_refuses_without_its_cards():
    """The reference's signature contract, and the port's refusal on a
    machine with fewer than 256 (512) cards; a ``make_tp_mesh`` mesh is
    the reference's ``("model",)`` mesh (no data axes)."""
    assert make_production_mesh.__kwdefaults__ == {"multi_pod": False}
    tp_mesh = make_tp_mesh(1, devices=["cpu"])
    ctx = shd.from_mesh(tp_mesh)
    tp_mesh.close()
    assert (ctx.dp_axes, ctx.tp_axis, ctx.fsdp_axis) == ((), "model", None)
    with pytest.raises(ValueError, match="needs 256 devices, have"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 devices, have"):
        make_production_mesh(multi_pod=True)


@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_state_axes_match_reference(moments):
    """``moment_axes`` / ``state_axes`` trees as the reference's, and the
    resolved state specs on (2, 2) and (2, 16, 16)."""
    jc, tc = j_get_config("internlm2-1.8b"), t_get_config("internlm2-1.8b")
    jm, tm = JModel(jc), TModel(tc)
    kw = dict(moment_dtype=moments)
    jopt, topt = JAdamW(JOptConfig(**kw)), AdamW(OptConfig(**kw))
    want = {"params": jm.param_axes(),
            "opt": jopt.moment_axes(jm.param_axes(), jm.param_shapes())}
    got = state_axes(tm, topt)
    assert got == want
    n_scales = sum(path[-1] == "s"
                   for path, _ in setup.leaves(got["opt"]["m"]))
    assert (n_scales > 0) == (moments == "int8")
    for name in ("2x2", "2x16x16"):
        tctx, jctx = _contexts(name)
        shapes = {"params": tm.param_shapes(),
                  "opt": topt.moment_shapes(tm.param_shapes())}
        specs = shd.tree_shardings(tctx, got, shapes)
        for path, ns in setup.leaves(specs):
            axes = got
            for k in path:
                axes = axes[k]
            assert ns.spec == tuple(j_resolve_spec(axes, ns.shape, jctx))


# -- the sharded loss -------------------------------------------------------

def _j_loss(jm, params, batch, shape):
    """The reference's jitted GSPMD loss on its mesh of ``shape``."""
    mesh = setup.j_mesh(shape)
    ctx = j_from_mesh(mesh)
    psh = j_tree_shardings(ctx, jm.param_axes(), jm.param_shapes())
    params_s = jax.device_put(params, psh)
    batch_s = jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                             JNamedSharding(mesh, P("data", None)))
    with mesh:
        loss, _ = jax.jit(lambda p, b: jm.loss(p, b, ctx))(params_s, batch_s)
    return float(loss)


LOSS_CASES = {  # arch: (mesh shape, S)
    "qwen1.5-0.5b": ((2, 2), setup.S),
    "granite-moe-3b-a800m": ((2, 2), setup.S),
    "jamba-v0.1-52b": ((2, 2), setup.S),
    "internlm2-1.8b": ((1, 4), 128),
}


@pytest.mark.parametrize("arch", list(LOSS_CASES))
def test_sharded_loss_matches_reference(arch):
    """The port's loss on its process mesh against the reference's GSPMD
    loss at the same mesh shape (MoE: the same token layout, so the same
    per-rank capacity), both from the reference's params."""
    shape, s = LOSS_CASES[arch]
    jc, tc = setup.smoke(arch)
    jm, tm = JModel(jc), TModel(tc)
    params = jm.init(jax.random.PRNGKey(0))
    batch = setup.batch(jc, setup.B, s)
    want = _j_loss(jm, params, batch, shape)
    mesh = setup.mesh(shape)
    ctx = shd.from_mesh(mesh)
    placed = shd.device_put(from_reference(params, "cpu"), shd.tree_shardings(
        ctx, tm.param_axes(), tm.param_shapes()), mesh)
    loss, metrics = tm.loss(placed, batch, ctx)
    placed.drop()
    assert abs(float(loss) / want - 1) <= 1e-5, (float(loss), want)
    assert np.isfinite(float(metrics["ce"]))


def test_cached_steps_refuse_a_parallel_context():
    """The cached steps under a ``ParallelContext`` (ROADMAP item 11, now
    served) equal the unsharded ones: ``prefill`` then two
    ``decode_step``s on (2, 2) from the controller, logits within 1e-5 of
    their largest and the gathered cache within 1e-5, and a foreign
    ``parallel=`` object is still refused."""
    _, tc = setup.smoke("internlm2-1.8b")
    tm = TModel(tc)
    params = tm.init(torch.Generator().manual_seed(0), "cpu")
    mesh = setup.mesh((2, 2))
    ctx = shd.from_mesh(mesh)
    placed = shd.device_put(params, tm.param_shardings(ctx), mesh)
    tokens = torch.from_numpy(setup.batch(tc, 4, 8)["tokens"])
    with torch.no_grad():
        want, cache = tm.prefill(params, {"tokens": tokens})
    got, handle = tm.prefill(placed, {"tokens": tokens}, parallel=ctx)
    cur = torch.full((4,), 8, dtype=torch.int32)
    for _ in range(3):
        fin = torch.isfinite(want)
        assert (got[fin] - want[fin]).abs().max() <= \
            1e-5 * want[fin].abs().max()
        tok = torch.argmax(want, -1).to(torch.int32)[:, None]
        with torch.no_grad():
            want, cache = tm.decode_step(params, cache, tok, cur)
        got, handle = tm.decode_step(placed, handle, tok, cur, parallel=ctx)
        cur = cur + 1
    for path, leaf in setup.leaves(shd.gather(handle)):
        ref = cache
        for k in path:
            ref = ref[k]
        assert (leaf.double() - ref.double()).abs().max() <= \
            1e-5 * max(ref.double().abs().max(), 1e-30)
    handle.drop()
    placed.drop()
    with pytest.raises(TypeError, match="TPShard or a ParallelContext"):
        tm.prefill(params, {"tokens": tokens}, parallel=object())


def test_sp_holds_the_residual_stream_in_rows():
    """On (2, 2) every block leaves the rank S/2 rows of its 4 batch rows
    at S = 32 (SP), and the whole sequence at S = 31."""
    jc, tc = setup.smoke("internlm2-1.8b")
    tm = TModel(tc)
    mesh = setup.mesh((2, 2))
    ctx = shd.from_mesh(mesh)
    params = from_reference(JModel(jc).init(jax.random.PRNGKey(0)), "cpu")
    placed = shd.device_put(params, shd.tree_shardings(
        ctx, tm.param_axes(), tm.param_shapes()), mesh)
    for s, want in ((32, (4, 16, 64)), (31, (4, 31, 64))):
        seen = mesh.gather(ranks.residual_shapes, tm, placed.key,
                           per_rank=shd.batch_blocks(
                               ctx, setup.batch(jc, setup.B, s)))
        assert [len(r) for r in seen] == [tc.n_layers] * 4
        assert {x for r in seen for x in r} == {(want, s == 32)}
    placed.drop()


# -- expert parallelism -----------------------------------------------------

def test_moe_ep_matches_reference_and_local():
    """``test_moe_ep_matches_local``'s config (8 experts, top-2, capacity
    factor 8: no drops) on (2, 2): the port's expert-parallel layer
    against the reference's (1e-5 of the largest |y|) and against the
    port's one-device layer (the reference test's 5e-4 / 5e-3)."""
    jc = dataclasses.replace(j_smoke_config("granite-moe-3b-a800m"),
                             n_experts=8, n_experts_active=2,
                             capacity_factor=8.0)
    tc = dataclasses.replace(t_smoke_config("granite-moe-3b-a800m"),
                             n_experts=8, n_experts_active=2,
                             capacity_factor=8.0)
    rng = np.random.default_rng(0)
    d, e, f = jc.d_model, jc.n_experts_padded, jc.d_ff
    p = {"router": rng.standard_normal((d, e)).astype(np.float32),
         "wg": (rng.standard_normal((e, d, f)) * 0.05).astype(np.float32),
         "wi": (rng.standard_normal((e, d, f)) * 0.05).astype(np.float32),
         "wo": (rng.standard_normal((e, f, d)) * 0.05).astype(np.float32)}
    x = rng.standard_normal((8, 16, d)).astype(np.float32)
    jmesh = setup.j_mesh((2, 2))
    jctx = j_from_mesh(jmesh)
    wsh = JNamedSharding(jmesh, P("model", "data", None))
    p_s = {"router": jnp.asarray(p["router"])}
    p_s.update({k: jax.device_put(jnp.asarray(p[k]), wsh)
                for k in ("wg", "wi", "wo")})
    x_s = jax.device_put(jnp.asarray(x),
                         JNamedSharding(jmesh, P("data", "model", None)))
    with jmesh:
        want, want_aux = jax.jit(lambda pp, xx: j_moe_layer(pp, xx, jc, jctx))(
            p_s, x_s)
    want = np.asarray(want)
    mesh = setup.mesh((2, 2))
    ctx = shd.from_mesh(mesh)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    outs = mesh.gather(ranks.moe_block, tp, torch.from_numpy(x), tc)
    got = torch.empty(x.shape)
    spec = shd.resolve_spec(("batch", "sp", None), x.shape, ctx)
    for r, (y, aux) in enumerate(outs):
        shd.local_block(got, spec, ctx, mesh.coords(r)).copy_(y)
        assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(
            float(want_aux))
    got = got.numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    local, _ = moe_layer(tp, torch.from_numpy(x), tc)
    np.testing.assert_allclose(got, local.numpy(), atol=5e-4, rtol=5e-3)


# -- compressed all-reduce ---------------------------------------------------

def test_psum_compressed_matches_reference():
    """Four ranks on a ("data",) mesh, each a row of g: the mean and the
    residuals against the reference's ``shard_map`` on 4 devices."""
    rng = np.random.default_rng(0)
    g = rng.standard_normal((4, 600)).astype(np.float32)
    jmesh = setup.j_mesh((4,), ("data",))

    def f(gl, rl):
        avg, res = j_psum_compressed(gl[0], rl[0], "data")
        return avg[None], res[None]

    shard_map = getattr(jax, "shard_map", None)
    with jmesh:
        avg, res = jax.jit(shard_map(
            f, mesh=jmesh, in_specs=(P("data", None), P("data", None)),
            out_specs=(P("data", None), P("data", None))))(
                jnp.asarray(g), jnp.zeros_like(jnp.asarray(g)))
    mesh = setup.mesh((4,), ("data",))
    outs = mesh.gather(ranks.compressed_row, torch.from_numpy(g), "data")
    for r, (a, res_r) in enumerate(outs):
        np.testing.assert_array_equal(a.numpy(), np.asarray(avg)[r])
        # XLA fuses the residual's g - q * s into one rounding
        np.testing.assert_allclose(res_r.numpy(), np.asarray(res)[r],
                                   rtol=0, atol=1e-6 * np.abs(g).max())
