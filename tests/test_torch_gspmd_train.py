"""One GSPMD-style train step of the port on a CPU process mesh, against
the reference's jitted GSPMD step on the host devices
``tests/conftest.py`` forces, from the same state
(``repro_torch.convert.from_reference_state``).

On (2, 2): loss and grad norm within 1e-5 relative; f32 moments (after
one step m = 0.1 g and v = 0.05 g^2: every gradient element) within 1e-5
of each leaf's largest; params within 1e-5 of each leaf's largest update
where the gradient is at least 1e-2 of its leaf's largest (Adam's first
step divides g by |g| + eps, so a gradient near 0 moves its update far
more than its own error: the reference's own GSPMD step on (2, 2) is
4.2e-3 of the update from its one-device step there, measured on the
internlm2 smoke config with f32 moments); int8 codes counted where they
differ (by one; at most 1 in 1000 codes). internlm2 with f32 and int8
moments, granite-moe (8 experts) through the expert-parallel all_to_all.
Then ``train_loop`` on (2, 2) resumed from a checkpoint against the run
without the break.
"""
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

import torch_gspmd_setup as setup
from repro.models import Model as JModel
from repro.parallel import from_mesh as j_from_mesh
from repro.parallel import tree_shardings as j_tree_shardings
from repro.train import AdamW as JAdamW
from repro.train import OptConfig as JOptConfig
from repro.train import init_state as j_init_state
from repro.train import make_train_step as j_make_train_step
from repro_torch.convert import from_reference_state
from repro_torch.models import Model as TModel
from repro_torch.parallel import sharding as shd
from repro_torch.train import (AdamW, Checkpointer, OptConfig,
                              make_train_step, train_loop)
from repro_torch.train.train_loop import place_state


@pytest.fixture(autouse=True, scope="module")
def _close_meshes():
    yield
    setup.close_meshes()


@pytest.mark.parametrize("arch,moments", [
    ("internlm2-1.8b", "f32"), ("internlm2-1.8b", "int8"),
    ("granite-moe-3b-a800m", "f32")])
def test_sharded_train_step_matches_reference(arch, moments):
    """One step of a smoke config on (2, 2) from the reference's state,
    against the reference's jitted GSPMD step. int8 moments take
    64-wide blocks from 1024 elements (``q_block=64, min_quant_size=
    1024``: at smoke widths no leaf has a 256-multiple last dim), so the
    codec runs on leaves whose last dim the ``model`` axis cuts inside a
    block (``wq``/``wk``/``wv``/``wg``/``wi``: 64 or 128 columns over two
    ranks) and on whole blocks; codes may differ where the unrounded
    value lies within f32 ulps of a half, and such flips are counted.
    granite-moe (8 experts): the gradients through the expert-parallel
    all_to_all and the router's mean-of-ranks load-balancing loss."""
    jc, tc = setup.smoke(arch)
    jm, tm = JModel(jc), TModel(tc)
    kw = dict(warmup_steps=1, moment_dtype=moments)
    if moments == "int8":
        kw.update(q_block=64, min_quant_size=1024)
    jopt, topt = JAdamW(JOptConfig(**kw)), AdamW(OptConfig(**kw))
    state = j_init_state(jm, jopt, jax.random.PRNGKey(0))
    start = from_reference_state(state, "cpu")
    batch = setup.batch(jc, setup.B, setup.S, seed=1)
    jmesh = setup.j_mesh((2, 2))
    jctx = j_from_mesh(jmesh)
    sh = j_tree_shardings(jctx, {"params": jm.param_axes(),
                                 "opt": jopt.moment_axes(jm.param_axes(),
                                                         jm.param_shapes())},
                          jax.eval_shape(lambda: state))
    with jmesh:
        j_state, j_metrics = jax.jit(j_make_train_step(jm, jopt, jctx))(
            jax.device_put(state, sh),
            jax.device_put({k: jnp.asarray(v) for k, v in batch.items()},
                           JNamedSharding(jmesh, P("data", None))))
    want = from_reference_state(jax.device_get(j_state), "cpu")
    mesh = setup.mesh((2, 2))
    ctx = shd.from_mesh(mesh)
    placed = place_state(tm, topt, start, mesh)
    _, metrics = make_train_step(tm, topt, ctx)(placed, batch)
    got = shd.gather(placed)
    placed.drop()
    for k in ("loss", "grad_norm"):
        assert abs(float(metrics[k]) / float(j_metrics[k]) - 1) <= 1e-5, k
    w_m = dict(setup.leaves(want["opt"]["m"]))
    for path, p in setup.leaves(got["params"]):
        w = dict(setup.leaves(want["params"]))[path]
        p0 = dict(setup.leaves(start["params"]))[path]
        step = float((w - p0).abs().max())
        if path + ("q",) in w_m:
            q, sc = w_m[path + ("q",)], w_m[path + ("s",)]
            m = (q.float().reshape(*sc.shape, -1)
                 * sc.float()[..., None]).reshape(p.shape)
        else:
            m = w_m[path]
        # beyond 4 ulps of the param: within 1e-5 of the largest update
        # where the gradient is at least 1e-2 of the leaf's largest. Adam's
        # first step divides g by |g| + eps, so a gradient near 0 moves its
        # update by far more than its own error (the reference's GSPMD
        # step is 4.2e-3 of the update from its one-device step there);
        # every element's gradient is held below, through the moments
        big = m.abs() >= 1e-2 * float(m.abs().max())
        d = (p - w).abs() - 4 * torch.finfo(torch.float32).eps * w.abs()
        assert float(d[big].max()) <= 1e-5 * step, path
    flips = total = 0
    for path, t in setup.leaves(got["opt"]):
        w = dict(setup.leaves(want["opt"]))[path]
        if t.dtype in (torch.int8, torch.uint8):
            diff = (t.to(torch.int32) - w.to(torch.int32)).abs()
            assert int(diff.max()) <= 1, path
            flips += int((diff > 0).sum())
            total += t.numel()
        elif path[-1] != "step":  # f32 moments (m = 0.1 g, v = 0.05 g^2
            # after one step: every gradient element); int8's scales
            bf16 = t.dtype == torch.bfloat16
            t, w = t.float(), w.float()
            fin = torch.isfinite(w)
            assert torch.equal(fin, torch.isfinite(t)), path
            assert torch.equal(t[~fin], w[~fin]), path
            if fin.any():
                top = float(w[fin].abs().max())
                tol = (1e-5 + (2 ** -8 if bf16 else 0.0)) * top
                assert float((t[fin] - w[fin]).abs().max()) <= tol, path
    if moments == "int8":
        print(f"int8 moments: {flips} of {total} codes differ by one")
        assert total > 0 and flips <= total // 1000, (flips, total)
    assert int(got["opt"]["step"]) == 1


def test_train_loop_resumes_a_sharded_run(tmp_path):
    """``train_loop`` on (2, 2) checkpoints after two steps (gathered to
    this process); a new loop restores that step onto the ranks and takes
    a third: the params and moments bit for bit those of three steps
    without the break."""
    _, tc = setup.smoke("internlm2-1.8b")
    tm = TModel(tc)
    topt = AdamW(OptConfig(warmup_steps=1))
    batches = [setup.batch(tc, setup.B, setup.S, seed=s) for s in range(3)]
    ctx = shd.from_mesh(setup.mesh((2, 2)))

    def run(steps, ckpt=None):
        state, _ = train_loop(
            tm, topt, iter(batches), steps=steps,
            generator=torch.Generator().manual_seed(0), parallel=ctx,
            checkpointer=ckpt, checkpoint_every=2, log_fn=lines.append)
        out = shd.gather(state)
        state.drop()
        return out

    lines = []
    whole = run(3)
    ckpt = Checkpointer(str(tmp_path))
    run(2, ckpt)
    assert ckpt.steps() == [2]
    batches.pop(0)
    batches.pop(0)
    lines.clear()
    resumed = run(3, Checkpointer(str(tmp_path)))
    assert lines[0] == "[train] resumed from step 2"
    for (path, a), (_, b) in zip(setup.leaves(whole),
                                 setup.leaves(resumed)):
        assert torch.equal(a, b), path
    assert int(resumed["opt"]["step"]) == 3
