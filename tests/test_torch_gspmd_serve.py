"""GSPMD serving of the port on CPU process meshes, against the
reference's GSPMD runs at the same mesh shape on the host devices
``tests/conftest.py`` forces.

The port's mesh is (2, 2) ("data", "model") of CPU ranks (``torch_gspmd_
setup.mesh``, one alive at a time, closed at the module's end); the
reference's the first four host devices. Both start from the reference's
numbers (``repro_torch.convert``).

* ``prefill`` then 4 ``decode_step``s under the context at B = 8 (batch
  over ``data``, the ``kv_seq`` ring over ``model``: each rank holds 4
  rows of S/2 positions) and at B = 1 (``kv_seq`` over the whole mesh, S/4
  positions a rank): logits within 1e-5 of each row's largest, every
  cache leaf gathered within 1e-5 of its largest, greedy tokens
  identical; internlm2, gemma2 (window, softcaps), granite-moe (8
  experts) and jamba (mamba state). The reference's GSPMD MoE cannot run
  at decode nor at a batch that does not divide over ``data`` (its
  expert-parallel ``shard_map`` refuses blocks that do not divide, ROADMAP
  §3): there the port is held against the reference without a context,
  as GSPMD changes no math;
* the flash-decode combine on a ring cut four ways, rows whose block sees
  no position included, against one device's ``decode_attention``;
* ``ServeEngine(parallel=)`` ``generate`` (greedy and sampled) and
  ``score`` against ``repro.serve.ServeEngine(parallel=)``, dense and
  ``QTensor`` params (quantized leaves whole on every rank);
* ``ContinuousEngine(parallel=)``, packed, kv16 and kv4 at horizons 8
  and 1, with preemption: tokens those of
  ``repro.serve.ContinuousEngine(parallel=)`` at the same kv_bits (one
  reference run a kv_bits: greedy tokens do not depend on the horizon);
* the paged steps from the controller (``place_paged``, pools on the
  ranks) against the unsharded steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gspmd_ranks as ranks
import torch_gspmd_setup as setup
from repro import core as j_core
from repro.models import Model as JModel
from repro.parallel import from_mesh as j_from_mesh
from repro.serve import ContinuousEngine as JEngine
from repro.serve import ServeEngine as JServe
from repro_torch.convert import from_reference
from repro_torch.models import Model as TModel
from repro_torch.models.attention import decode_attention
from repro_torch.parallel import sharding as shd
from repro_torch.serve import ContinuousEngine, ServeEngine

SHAPE = (2, 2)


@pytest.fixture(autouse=True, scope="module")
def _close_meshes():
    yield
    setup.close_meshes()


def _ctx():
    return shd.from_mesh(setup.mesh(SHAPE))


def _rowwise(got, want, tol=1e-5):
    """Logits within ``tol`` of each row's largest |value| (-inf where
    the vocab is padded, on both)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    scale = np.max(np.where(fin, np.abs(want), 0), axis=-1, keepdims=True)
    err = np.abs(np.where(fin, got, 0) - np.where(fin, want, 0))
    assert (err <= tol * scale).all(), float((err / scale).max())


def _caches_close(got, want):
    want = dict(setup.leaves(jax.tree_util.tree_map(np.asarray, want)))
    got = dict(setup.leaves(got))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape, path
        if w.dtype.kind == "i":
            np.testing.assert_array_equal(g, w, err_msg=str(path))
        else:
            assert np.abs(g - w).max() <= 1e-5 * max(np.abs(w).max(), 1e-30), \
                path


def _j_gspmd(fn, ctx, mesh):
    """``fn`` jitted under the reference's context, or without one where
    the reference's GSPMD path refuses the shapes (a ValueError from its
    expert-parallel ``shard_map``)."""
    gspmd = jax.jit(lambda *a: fn(*a, ctx))
    plain = jax.jit(fn)

    def call(*args):
        try:
            with mesh:
                return gspmd(*args)
        except ValueError as exc:
            assert "evenly divisible" in str(exc)
            return plain(*args)
    return call


STATIC = ["internlm2-1.8b", "gemma2-2b", "granite-moe-3b-a800m",
          "jamba-v0.1-52b"]


@pytest.mark.parametrize("b", [8, 1])
@pytest.mark.parametrize("arch", STATIC)
def test_prefill_decode_match_reference(arch, b):
    jc, tc = setup.smoke(arch)
    jm, tm = JModel(jc), TModel(tc)
    params = jm.init(jax.random.PRNGKey(0))
    toks = setup.batch(jc, b, setup.S)["tokens"]
    jmesh = setup.j_mesh(SHAPE)
    jctx = j_from_mesh(jmesh)
    j_prefill = _j_gspmd(lambda p, bt, c=None: jm.prefill(p, bt, c), jctx,
                         jmesh)
    j_decode = _j_gspmd(lambda p, c, t, pos, x=None: jm.decode_step(
        p, c, t, pos, x), jctx, jmesh)
    want, jcache = j_prefill(params, {"tokens": jnp.asarray(toks)})

    mesh = setup.mesh(SHAPE)
    ctx = shd.from_mesh(mesh)
    tp = from_reference(params, "cpu")
    placed = shd.device_put(tp, tm.param_shardings(ctx), mesh)
    got, cache = tm.prefill(placed, {"tokens": toks}, ctx)
    _rowwise(got, want)
    _caches_close(shd.gather(cache), jcache)
    # the ring's blocks: B = 8 cuts rows over data and positions over
    # model; B = 1 positions over the whole mesh
    blocks = mesh.gather(ranks.block_shapes, cache.key)
    kv = [s for p, s in blocks[0].items() if p[-1] == "k"][0]
    assert kv[1:3] == ((4, setup.S // 2) if b == 8 else (1, setup.S // 4))
    cur = np.full((b,), setup.S, np.int32)
    for _ in range(4):
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)
        np.testing.assert_array_equal(np.argmax(got.numpy(), -1), tok)
        want, jcache = j_decode(params, jcache, jnp.asarray(tok[:, None]),
                                jnp.asarray(cur))
        got, cache = tm.decode_step(placed, cache, torch.from_numpy(
            tok[:, None]), torch.from_numpy(cur), ctx)
        _rowwise(got, want)
        cur = cur + 1
    _caches_close(shd.gather(cache), jcache)
    cache.drop()
    placed.drop()


def test_kv_seq_combine_matches_one_device():
    """Rows at positions 2, 9 and 31 of a 32-entry ring cut four ways
    (8 positions a rank), one with a window of 4: blocks that see no
    position weigh 0 and nothing is NaN."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 1, 4, 16, generator=g)
    k = torch.randn(3, 32, 2, 16, generator=g)
    v = torch.randn(3, 32, 2, 16, generator=g)
    pos = torch.arange(32, dtype=torch.int32)[None].expand(3, 32).clone()
    pos[2, 20:] = -1
    cur = torch.tensor([2, 9, 31], dtype=torch.int32)
    want = decode_attention(q, k, v, pos, cur)
    outs = setup.mesh(SHAPE).gather(ranks.kv_seq_combine, q, k, v, pos, cur)
    for got in outs:
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def _quantized(jm, params):
    policy = j_core.QuantPolicy(bits=4, block=64, solver="kmeans",
                                min_size=1024)
    return jax.jit(lambda p: j_core.quantize_params(p, policy))(params)[0]


@pytest.mark.parametrize("params_kind", ["dense", "qtensor"])
def test_serve_engine_matches_reference(params_kind):
    jc, tc = setup.smoke("internlm2-1.8b")
    jm, tm = JModel(jc), TModel(tc)
    params = jm.init(jax.random.PRNGKey(0))
    if params_kind == "qtensor":
        params = _quantized(jm, params)
    rng = np.random.default_rng(3)
    prompts = rng.integers(0, jc.vocab_size, (8, 12)).astype(np.int32)
    tokens = rng.integers(0, jc.vocab_size, (8, 17)).astype(np.int32)
    jmesh = setup.j_mesh(SHAPE)
    ref = JServe(jm, params, max_seq=32, execution="simulated",
                 parallel=j_from_mesh(jmesh))
    with jmesh:
        want = np.asarray(ref.generate(jnp.asarray(prompts), n_tokens=8))
        ref_score = float(ref.score(jnp.asarray(tokens)))
    tq = from_reference(params, "cpu")
    eng = ServeEngine(tm, tq, max_seq=32, device="cpu",
                      execution="simulated", parallel=_ctx())
    np.testing.assert_array_equal(eng.generate(prompts, 8), want)
    one = ServeEngine(tm, tq, max_seq=32, device="cpu",
                      execution="simulated")
    np.testing.assert_array_equal(one.generate(prompts[:1], 8),
                                  eng.generate(prompts[:1], 8))
    np.testing.assert_array_equal(
        one.generate(prompts, 6, temperature=0.8,
                     generator=torch.Generator().manual_seed(3)),
        eng.generate(prompts, 6, temperature=0.8,
                     generator=torch.Generator().manual_seed(3)))
    got = eng.score(tokens)
    assert abs(got - ref_score) <= 1e-5 * abs(ref_score), (got, ref_score)
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.score(tokens)


ENGINE = dict(max_batch=4, page_size=4, max_seq=32, prefill_chunk=8)


def _requests(n=5, seed=1):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 64, (int(rng.integers(4, 12)),)).astype(
        np.int32), int(rng.integers(4, 10))) for _ in range(n)]


@pytest.fixture(scope="module")
def continuous():
    """The reference's quantized params (vocab 64), and its GSPMD
    engine's tokens at kv16 and kv4 (pool of 10 pages: preemption)."""
    jc = dataclasses.replace(setup.smoke("internlm2-1.8b")[0], vocab_size=64,
                             vocab_round=64)
    tc = dataclasses.replace(setup.smoke("internlm2-1.8b")[1], vocab_size=64,
                             vocab_round=64)
    jm = JModel(jc)
    params = jax.tree_util.tree_map(lambda p: p.astype(jnp.float32),
                                    jm.init(jax.random.PRNGKey(0)))
    jq = _quantized(jm, params)
    jmesh = setup.j_mesh(SHAPE)
    want = {}
    for kv_bits in (16, 4):
        eng = JEngine(jm, jq, execution="packed", num_pages=10,
                      kv_bits=kv_bits, parallel=j_from_mesh(jmesh), **ENGINE)
        for r in _requests():
            eng.submit(*r)
        with jmesh:
            want[kv_bits] = eng.run()
    return TModel(tc), from_reference(jq, "cpu"), want


@pytest.mark.parametrize("horizon", [8, 1])
@pytest.mark.parametrize("kv_bits", [16, 4])
def test_continuous_engine_matches_reference(continuous, kv_bits, horizon):
    tm, tq, want = continuous
    eng = ContinuousEngine(tm, tq, execution="packed", num_pages=10,
                           kv_bits=kv_bits, decode_horizon=horizon,
                           device="cpu", parallel=_ctx(), **ENGINE)
    rep = eng.warmup()
    assert rep["graphs"] == 0 and rep["eager"], rep
    for r in _requests():
        eng.submit(*r)
    got = eng.run()
    assert eng.scheduler.n_preemptions > 0
    eng.cache.check_invariants(expect_idle=True)
    eng.close()
    assert got.keys() == want[kv_bits].keys()
    for rid in got:
        np.testing.assert_array_equal(np.asarray(got[rid]),
                                      np.asarray(want[kv_bits][rid]))


def test_paged_steps_from_the_controller(continuous):
    """``paged_step``, ``paged_prefill_packed`` and
    ``paged_decode_horizon`` on every rank from the controller (params placed by ``place_paged``, pools allocated on the
    ranks): logits within 1e-5 of the unsharded step's, tokens identical,
    and every pool leaf gathered within 1e-5 (page 0, the scratch page,
    left out)."""
    tm, tq, _ = continuous
    ctx = _ctx()
    placed, report = tm.place_paged(tq, ctx)
    assert report
    toks = torch.tensor([[3, 4, 5, 6], [7, 8, 9, 0]], dtype=torch.int32)
    q_pos = torch.tensor([[0, 1, 2, 3], [0, 1, 2, -1]], dtype=torch.int32)
    lens = torch.tensor([4, 3], dtype=torch.int32)
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    slots = torch.tensor([0, 1], dtype=torch.int32)
    for kv_bits in (16, 4):
        pools = tm.init_paged_pools(8, 4, kv_bits=kv_bits, max_seqs=2,
                                    device="cpu")
        handle = tm.init_paged_pools(8, 4, kv_bits=kv_bits, max_seqs=2,
                                     parallel=ctx)
        kw = dict(kv_bits=kv_bits, slots=slots)
        with torch.no_grad():
            want, pools = tm.paged_step(tq, pools, toks, q_pos, lens, bt,
                                        **kw)
        got, handle = tm.paged_step(placed, handle, toks, q_pos, lens, bt,
                                    parallel=ctx, **kw)
        _rowwise(got, want)
        # a packed wave: one more token of each sequence, after its chunk
        packed = (torch.tensor([9, 10, -1, -1], dtype=torch.int32),
                  torch.tensor([0, 1, -1, -1], dtype=torch.int32),
                  torch.tensor([4, 3, -1, -1], dtype=torch.int32),
                  lens + 1, bt, slots, torch.tensor([0, 1]),
                  torch.tensor([0, 1]))
        with torch.no_grad():
            want, pools = tm.paged_prefill_packed(tq, pools, *packed,
                                                  kv_bits=kv_bits)
        got, handle = tm.paged_prefill_packed(placed, handle, *packed,
                                              kv_bits=kv_bits, parallel=ctx)
        _rowwise(got, want)
        args = (torch.tensor([1, 2], dtype=torch.int32),
                torch.tensor([5, 4], dtype=torch.int32), bt,
                torch.tensor([3, 3], dtype=torch.int32),
                torch.tensor([-1, -1], dtype=torch.int32), 3)
        with torch.no_grad():
            wt, wv, pools = tm.paged_decode_horizon(tq, pools, *args, **kw)
        gt, gv, handle = tm.paged_decode_horizon(placed, handle, *args,
                                                 parallel=ctx, **kw)
        assert torch.equal(gt, wt) and torch.equal(gv, wv)
        for path, g in setup.leaves(shd.gather(handle)):
            w = pools
            for k in path:
                w = w[k]
            assert g.shape == w.shape
            assert (g[:, 1:].double() - w[:, 1:].double()).abs().max() <= \
                1e-5 * max(w.double().abs().max(), 1e-30), path
        handle.drop()
    placed.drop()
