"""The port's quantizer surface against the JAX package: the objective
helpers, the kmeans / windowed-DP / choose_k solvers, ``solve_blocks`` and
``solve_flat``, the paper's numpy solvers, per-tensor MSB, the
nearest-scale refine, double quantization, the storage accounting, the
policy at ``block=-1`` and with ``double_quant``, and the engines on a
6-bit per-tensor tree. The same numpy inputs go through both packages.

Tolerances: solver boundaries, levels and scales are identical, except
where a near-tie picks other boundaries — then the grouping cost agrees
within 1e-6 relative and at least 95 % of rows are identical; the numpy
solvers are bit-identical; float helpers agree within 1e-6 relative and
the lambda bounds are bit-equal; ``score`` within 1e-4 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import grouping as jgrp
from repro.core import objective as jobj
from repro.core import policy as jpol
from repro.core import quantize as jq
from repro.core import reference as jref
from repro.models import Model as JModel
from repro.serve import ServeEngine as JServe
from repro_torch import configs as tcfg
from repro_torch.convert import from_reference
from repro_torch.core import grouping as tgrp
from repro_torch.core import objective as tobj
from repro_torch.core import policy as tpol
from repro_torch.core import quantize as tq
from repro_torch.models import Model as TModel
from repro_torch.serve import ServeEngine as TServe

REL = 1e-6


def _np(t):
    return t.detach().cpu().numpy()


def _blocks(seed):
    """The 300-block mix of ``test_torch_core``: ties, zeros, heavy tails."""
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((300, 64)).astype(np.float32)
    b[:20] = np.round(b[:20] * 4) / 4             # many exact ties
    b[20:30, :16] = 0.0                           # exact zeros
    b[30:40] = rng.standard_t(2, (10, 64))        # heavy tails
    return b


def _student_t(shape=(128, 2048), seed=0):
    """examples/quickstart.py's heavy-tailed weight (df 4, std 0.02)."""
    w = np.random.default_rng(seed).standard_t(4, size=shape).astype(
        np.float32)
    return w * (0.02 / w.std())


def _sorted_cost(v, b, lam=0.0):
    """Grouping cost of sorted rows ``v`` under boundaries ``b``, by the
    reference's own objective."""
    return np.array([float(jobj.grouping_cost(jnp.asarray(r), jnp.asarray(bb),
                                              lam=lam))
                     for r, bb in zip(v, b)])


def _assert_boundaries_match(v, jb, tb, lam=0.0):
    """Identical rows, or a near tie: the cost within 1e-6 relative."""
    same = (jb == tb).all(1)
    if not same.all():
        cj = _sorted_cost(v[~same], jb[~same], lam)
        ct = _sorted_cost(v[~same], tb[~same], lam)
        np.testing.assert_allclose(ct, cj, rtol=REL)
    assert same.mean() >= 0.95


def _assert_levels_match(blocks, jl, js, tl, ts):
    """Levels and scales identical per row, or the same SSE within 1e-6
    relative (a near tie), with at least 95 % of rows identical."""
    jl, js, tl, ts = map(np.asarray, (jl, js, tl, ts))
    blocks = blocks.reshape(jl.shape)
    same = (jl == tl).all(1) & (js == ts).all(1)
    for i in np.flatnonzero(~same):
        mag = np.abs(blocks[i]).astype(np.float64)
        sse_j = np.sum((mag - js[i][jl[i]]) ** 2)
        sse_t = np.sum((mag - ts[i][tl[i]]) ** 2)
        assert abs(sse_j - sse_t) <= REL * max(sse_j, 1e-30)
    assert same.mean() >= 0.95


# -- objective ---------------------------------------------------------------

def test_lambda_bounds_bit_equal():
    for a in (_blocks(0)[3], _student_t((16, 64)), np.float32([0.5])):
        assert tobj.lambda_bounds(torch.from_numpy(a)) == \
            jobj.lambda_bounds(a)
        assert tobj.lambda_bounds(a) == jobj.lambda_bounds(a)
        assert tobj.lambda_from_tilde(torch.from_numpy(a), 0.3) == \
            jobj.lambda_from_tilde(a, 0.3)


@pytest.mark.parametrize("lam,normalized", [(0.0, False), (0.05, False),
                                            (0.05, True)])
def test_grouping_and_interval_cost_match(lam, normalized):
    blocks = _blocks(1)
    v = np.sort(np.abs(blocks), axis=1)
    tb, _ = tgrp.dp_boundaries(torch.from_numpy(v), 8)
    b = _np(tb)
    want = np.array([float(jobj.grouping_cost(
        jnp.asarray(r), jnp.asarray(bb), lam=lam, normalized=normalized))
        for r, bb in zip(blocks, b)])
    # batched: rows of (unsorted) weights with (B, g+1) boundaries
    got = _np(tobj.grouping_cost(torch.from_numpy(blocks), tb, lam=lam,
                                 normalized=normalized))
    np.testing.assert_allclose(got, want, rtol=REL)
    # unbatched: 1-D boundaries treat the whole input as one vector
    one = float(tobj.grouping_cost(torch.from_numpy(blocks[7]), b[7],
                                   lam=lam, normalized=normalized))
    np.testing.assert_allclose(one, want[7], rtol=REL)
    s1, s2 = jobj.prefix_sums(jnp.asarray(v[7]))
    t1, t2 = tobj.prefix_sums(torch.from_numpy(v))
    n_total = 64 if normalized else None
    for i, j in ((0, 64), (3, 17), (40, 41)):
        np.testing.assert_allclose(
            float(tobj.interval_cost(i, j, t1[7], t2[7], lam, n_total)),
            float(jobj.interval_cost(i, j, s1, s2, lam, n_total)), rtol=REL)
    # batched interval costs over index tensors
    got = _np(tobj.interval_cost(tb[:, :1], tb[:, 1:2], t1, t2, lam,
                                 n_total))[:, 0]
    want = [float(jobj.interval_cost(int(bb[0]), int(bb[1]),
                                     *jobj.prefix_sums(jnp.asarray(r)),
                                     lam, n_total))
            for r, bb in zip(v[:20], b[:20])]
    np.testing.assert_allclose(got[:20], want, rtol=REL)


def test_sse_mse_and_xnor_match():
    a = _student_t((64, 128))
    a_hat = np.round(a * 50) / 50
    np.testing.assert_allclose(float(tobj.group_sse(torch.from_numpy(a))),
                               float(jobj.group_sse(a)), rtol=REL)
    np.testing.assert_allclose(
        float(tobj.reconstruction_mse(torch.from_numpy(a),
                                      torch.from_numpy(a_hat))),
        float(jobj.reconstruction_mse(a, a_hat)), rtol=REL)
    ta, tb = tobj.xnor_closed_form(torch.from_numpy(a))
    ja, jb = jobj.xnor_closed_form(a)
    np.testing.assert_allclose(float(ta), float(ja), rtol=REL)
    np.testing.assert_array_equal(_np(tb), np.asarray(jb))


def test_cumsum_keeps_xla_order_past_256():
    """The prefix sums stay bit-identical to ``jnp.cumsum`` at per-tensor
    lengths (XLA's CPU order recurses over blocks of 16)."""
    x = np.abs(np.random.default_rng(9).standard_normal((2, 70001))).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=1))(x))
    np.testing.assert_array_equal(_np(tobj._cumsum(torch.from_numpy(x))),
                                  want)


# -- solvers -----------------------------------------------------------------

SOLVERS = {
    "kmeans": (lambda v, g: jgrp.kmeans1d_boundaries(v, g),
               lambda v, g: tgrp.kmeans1d_boundaries(v, g)),
    "wdp": (lambda v, g: jgrp.windowed_dp_boundaries(v, g),
            lambda v, g: tgrp.windowed_dp_boundaries(v, g)),
    "dp_choose_k": (lambda v, g: jgrp.dp_boundaries(v, g, choose_k=True)[0],
                    lambda v, g: tgrp.dp_boundaries(v, g,
                                                    choose_k=True)[0]),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("g", [2, 8, 32])
@pytest.mark.parametrize("method", sorted(SOLVERS))
def test_solver_boundaries_match_reference(method, g, seed):
    v = np.sort(np.abs(_blocks(seed)), axis=1)
    jfn, tfn = SOLVERS[method]
    jb = np.asarray(jax.jit(jax.vmap(lambda x: jfn(x, g)))(jnp.asarray(v)))
    tb = _np(tfn(torch.from_numpy(v), g))
    _assert_boundaries_match(v, jb, tb)


@pytest.mark.parametrize("lam", [0.5, 2.0])
def test_dp_choose_k_with_lam_matches_reference(lam):
    """Eq. 2 with lam > 0: each row picks its own k* (rows with fewer
    groups keep n in their trailing boundaries), as the reference's
    unjitted-lam DP and the paper's Alg. 1 oracle pick it."""
    v = np.sort(np.abs(_blocks(0)), axis=1)
    tb, tc = tgrp.dp_boundaries(torch.from_numpy(v), 8, lam=lam,
                                choose_k=True)
    tb = _np(tb)
    jb, jc = jax.jit(jax.vmap(lambda x: jgrp.dp_boundaries(
        x, 8, lam=lam, choose_k=True)))(jnp.asarray(v))
    _assert_boundaries_match(v, np.asarray(jb), tb, lam)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=REL)
    assert len({int((r < 64).sum()) for r in tb[:, 1:]}) > 1
    for i in range(0, 300, 37):
        ob, _, _ = jref.dynamic_grouping(v[i], 8, lam=lam, choose_k=True)
        k = len(ob) - 1
        np.testing.assert_array_equal(tb[i, :k + 1], ob)
        assert (tb[i, k + 1:] == 64).all()


@pytest.mark.parametrize("method", ["dp", "kmeans", "wdp"])
def test_solve_blocks_matches_reference(method):
    blocks = _blocks(2)
    jl, js = jgrp.solve_blocks(jnp.asarray(blocks), 8, method=method,
                               iters=12)
    tl, ts = tgrp.solve_blocks(torch.from_numpy(blocks), 8, method=method,
                               iters=12, chunk=128)
    _assert_levels_match(blocks, jl, js, _np(tl), _np(ts))


@pytest.mark.parametrize("method", ["dp", "kmeans", "wdp"])
def test_solve_flat_matches_reference(method):
    a = _student_t((1, 4096), seed=3)[0] if method != "dp" else \
        _blocks(3)[50]
    jl, js = jgrp.solve_flat(jnp.asarray(a), 16, method=method, iters=20)
    tl, ts = tgrp.solve_flat(torch.from_numpy(a), 16, method=method,
                             iters=20)
    _assert_levels_match(a, np.asarray(jl)[None], np.asarray(js)[None],
                         _np(tl)[None], _np(ts)[None])


def test_solve_flat_with_lam_and_choose_k():
    """The reference's jitted ``solve_flat`` refuses any explicit ``lam``
    (its ``if lam:`` meets a tracer); the port computes the defined
    result, held against the unjitted reference DP and Alg. 1's oracle."""
    a = _blocks(0)[60]
    with pytest.raises(jax.errors.TracerBoolConversionError):
        jgrp.solve_flat(jnp.asarray(a), 8, method="dp", lam=2.0,
                        choose_k=True)
    tl, ts = tgrp.solve_flat(torch.from_numpy(a), 8, method="dp", lam=2.0,
                             choose_k=True)
    v = np.sort(np.abs(a))
    jb, _ = jgrp.dp_boundaries(jnp.asarray(v), 8, lam=2.0, choose_k=True)
    ob, order, _ = jref.dynamic_grouping(a, 8, lam=2.0, choose_k=True)
    k = len(ob) - 1
    np.testing.assert_array_equal(np.asarray(jb)[:k + 1], ob)
    _, olv, osc = jref.reconstruct(a, ob, order, n_levels=8)
    np.testing.assert_array_equal(_np(tl), olv)
    np.testing.assert_allclose(_np(ts), osc, rtol=REL)
    assert (_np(ts)[k:] == 0).all()


# -- the paper's numpy solvers -----------------------------------------------

NUMPY_SOLVERS = ["dg", "gg", "wgm", "wgm_lo"]


@pytest.mark.parametrize("solver", NUMPY_SOLVERS)
def test_numpy_solvers_bit_identical(solver):
    blocks = _blocks(4)
    w = np.concatenate([blocks[:8], blocks[20:24], blocks[30:34],
                        blocks[40:56]])           # ties, zeros, tails, normal
    jt = jq.quantize_blockwise(jnp.asarray(w), 4, solver=solver)
    tt = tq.quantize_blockwise(torch.from_numpy(w), 4, solver=solver)
    np.testing.assert_array_equal(_np(tt.codes), np.asarray(jt.codes))
    np.testing.assert_array_equal(_np(tt.scales), np.asarray(jt.scales))
    # heuristics never beat the exact DP, on zero-free blocks (an exact
    # zero reconstructs exactly, which the interval objective does not model)
    dp = tq.quantize_blockwise(torch.from_numpy(w), 4, solver="dp")
    err = ((_np(tq.dequantize(tt)) - w) ** 2).sum(1)
    err_dp = ((_np(tq.dequantize(dp)) - w) ** 2).sum(1)
    zero_free = (w != 0).all(1)
    assert zero_free.sum() >= 16
    assert (err >= err_dp * (1 - 1e-5))[zero_free].all()


def test_numpy_wgm_window_rule_per_tensor():
    """Above 4096 elements WGM starts from windows of n // 256."""
    w = _student_t((64, 128), seed=5)
    jt = jq.quantize_pertensor(jnp.asarray(w), 6, solver="wgm")
    tt = tq.quantize_pertensor(torch.from_numpy(w), 6, solver="wgm")
    np.testing.assert_array_equal(_np(tt.codes), np.asarray(jt.codes))
    np.testing.assert_array_equal(_np(tt.scales), np.asarray(jt.scales))


# -- quantize ----------------------------------------------------------------

@pytest.mark.parametrize("solver,refine,iters", [
    ("dp", True, 30), ("kmeans", False, 12), ("kmeans", True, 30),
    ("wdp", False, 30), ("wdp", True, 30), ("wgm", True, 30)])
def test_quantize_blockwise_solver_refine_iters(solver, refine, iters):
    w = _student_t() if solver != "wgm" else _student_t((4, 256))
    jt = jq.quantize_blockwise(jnp.asarray(w), 4, solver=solver,
                               iters=iters, refine=refine)
    tt = tq.quantize_blockwise(torch.from_numpy(w), 4, solver=solver,
                               iters=iters, refine=refine)
    g = 8
    _assert_levels_match(w.reshape(-1, 64),
                         np.abs(np.asarray(jt.codes)).reshape(-1, 64),
                         np.asarray(jt.scales).reshape(-1, g),
                         np.abs(_np(tt.codes)).reshape(-1, 64),
                         _np(tt.scales).reshape(-1, g))
    np.testing.assert_array_equal(np.sign(_np(tt.codes)), np.sign(w))


def test_nearest_refine_keeps_empty_groups_out():
    blocks = torch.tensor([[0.0, 0.1, 0.3, 2.0]])
    scales = torch.tensor([[0.0, 0.2, 2.0, 0.0]])
    lv = tq._nearest_refine(blocks, torch.zeros(1, 4, dtype=torch.int32),
                            scales)
    jlv = jq._nearest_refine(jnp.asarray(blocks.numpy()),
                             jnp.zeros((1, 4), jnp.int32),
                             jnp.asarray(scales.numpy()))
    np.testing.assert_array_equal(_np(lv), np.asarray(jlv))
    assert _np(lv).tolist() == [[0, 1, 1, 2]]


@pytest.mark.parametrize("solver", ["kmeans", "wdp"])
def test_quantize_pertensor_matches_reference(solver):
    w = _student_t()
    jt = jq.quantize_pertensor(jnp.asarray(w), 6, solver=solver)
    tt = tq.quantize_pertensor(torch.from_numpy(w), 6, solver=solver)
    assert tuple(tt.scales.shape) == jt.scales.shape == (1, 32)
    assert (tt.bits, tt.block) == (jt.bits, jt.block) == (6, -1)
    _assert_levels_match(w.reshape(1, -1),
                         np.abs(np.asarray(jt.codes)).reshape(1, -1),
                         np.asarray(jt.scales),
                         np.abs(_np(tt.codes)).reshape(1, -1),
                         _np(tt.scales))
    np.testing.assert_array_equal(_np(tq.dequantize(tt)),
                                  np.asarray(jq.dequantize(jt)))


def test_double_quantize_and_storage_bits():
    w = _student_t((64, 4096))
    jt = jq.quantize_blockwise(jnp.asarray(w), 4)
    tt = tq.quantize_blockwise(torch.from_numpy(w), 4)
    jd, td = jq.double_quantize(jt), tq.double_quantize(tt)
    assert tuple(td.scales.shape) == jd.scales.shape == (64, 64, 8)
    assert td.scales.dtype == torch.float32
    np.testing.assert_allclose(_np(td.scales), np.asarray(jd.scales),
                               rtol=REL, atol=REL * float(
                                   np.abs(np.asarray(jd.scales)).max()))
    np.testing.assert_array_equal(_np(td.codes), np.asarray(jd.codes))
    assert tq.storage_bits_per_weight(tt) == \
        jq.storage_bits_per_weight(jt) == 6.0
    assert tq.storage_bits_per_weight(td, double_quant=True) == \
        jq.storage_bits_per_weight(jd, double_quant=True) == 4.78125
    jp = jq.quantize_pertensor(jnp.asarray(w), 6)
    tp = tq.quantize_pertensor(torch.from_numpy(w), 6)
    assert tq.storage_bits_per_weight(tp) == jq.storage_bits_per_weight(jp)
    # packed: the allocated footprint, N-padding included
    wp = _student_t((200, 64))
    jpk = jq.pack_qtensor(jq.quantize_blockwise(jnp.asarray(wp), 4),
                          transpose=True)
    tpk = tq.pack_qtensor(tq.quantize_blockwise(torch.from_numpy(wp), 4),
                          transpose=True)
    assert tq.storage_bits_per_weight(tpk) == jq.storage_bits_per_weight(jpk)


# -- policy on smoke internlm2 ------------------------------------------------

@pytest.fixture(scope="module")
def smoke_params():
    cfg = jcfg.smoke_config("internlm2-1.8b")
    return JModel(cfg).init(jax.random.PRNGKey(0))


def _assert_tree_equal(jtree, ttree, wtree, path=""):
    """Trees equal leaf by leaf: plain arrays bit-identical; QTensors with
    the same metadata and scale shapes, codes identical and scales within
    1e-6 relative per scale row, or else (a near tie) the row's
    reconstruction SSE against the weights ``wtree`` within 1e-6, with at
    least 95 % of rows identical."""
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            _assert_tree_equal(jtree[k], ttree[k], wtree[k], f"{path}/{k}")
        return
    if not isinstance(jtree, jq.QTensor):
        np.testing.assert_array_equal(np.asarray(jtree), _np(ttree),
                                      err_msg=path)
        return
    assert isinstance(ttree, tq.QTensor), path
    assert (jtree.bits, jtree.block) == (ttree.bits, ttree.block), path
    assert jtree.scales.shape == tuple(ttree.scales.shape), path
    g = jtree.scales.shape[-1]
    rows = int(np.prod(jtree.scales.shape[:-1]))
    jc = np.asarray(jtree.codes).reshape(rows, -1)
    tc = _np(ttree.codes).reshape(rows, -1)
    js = np.asarray(jtree.scales).reshape(rows, g)
    ts = _np(ttree.scales).reshape(rows, g)
    same = (jc == tc).all(1) & np.isclose(ts, js, rtol=REL, atol=0).all(1)
    if not same.all():
        w = np.asarray(wtree, np.float64).reshape(rows, -1)
        jd = np.asarray(jq.dequantize(dataclasses.replace(
            jtree, dtype=jnp.float32))).reshape(rows, -1)
        td = _np(tq.dequantize(dataclasses.replace(
            ttree, dtype=torch.float32))).reshape(rows, -1)
        np.testing.assert_allclose(((td - w) ** 2).sum(1)[~same],
                                   ((jd - w) ** 2).sum(1)[~same], rtol=REL,
                                   err_msg=path)
    assert same.mean() >= 0.95, path


POLICIES = {
    "pertensor_6b": dict(bits=6, block=-1, min_size=1024),
    "pertensor_kmeans": dict(bits=6, block=-1, solver="kmeans",
                             min_size=1024),
    "dq_4b64": dict(bits=4, block=64, double_quant=True, min_size=1024),
    "pertensor_dq": dict(bits=6, block=-1, double_quant=True,
                         min_size=1024),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_quantize_params_matches_reference(smoke_params, name):
    policy = POLICIES[name]
    jpolicy = jpol.QuantPolicy(**policy)
    jqp, jrep = jax.jit(lambda p: jpol.quantize_params(p, jpolicy))(
        smoke_params)
    tqp, trep = tpol.quantize_params(from_reference(smoke_params, "cpu"),
                                     tpol.QuantPolicy(**policy),
                                     device="cpu")
    assert sorted(jrep) == sorted(trep)
    _assert_tree_equal(jqp, tqp, smoke_params)
    # stacked per-tensor leaves: one codebook per layer
    if policy["block"] == -1:
        wq = tqp["dec"]["s0"]["attn"]["wq"]
        assert tuple(wq.scales.shape) == (2, 1, 32)
    assert tpol.param_bits(tqp) == jpol.param_bits(jqp)


# -- engines on a 6-bit per-tensor tree ---------------------------------------

def _vocab64(smoke):
    return dataclasses.replace(smoke("internlm2-1.8b"), vocab_size=64,
                               vocab_round=64)


@pytest.fixture(scope="module")
def pertensor_engines():
    jm = JModel(_vocab64(jcfg.smoke_config))
    params = jm.init(jax.random.PRNGKey(1))
    qparams = jax.jit(lambda p: jpol.quantize_params(p, jpol.QuantPolicy(
        bits=6, block=-1, min_size=1024))[0])(params)
    rng = np.random.default_rng(13)
    prompts = rng.integers(0, 64, (3, 6)).astype(np.int32)
    scored = rng.integers(0, 64, (2, 17)).astype(np.int32)
    ref = {}
    for mode in ("packed", "simulated"):
        je = JServe(jm, qparams, max_seq=24, execution=mode)
        ref[mode] = (np.asarray(je.generate(jnp.asarray(prompts), 8)),
                     float(je.score(jnp.asarray(scored))))
    tqp, _ = tpol.quantize_params(from_reference(params, "cpu"),
                                  tpol.QuantPolicy(bits=6, block=-1,
                                                   min_size=1024),
                                  device="cpu")
    return TModel(_vocab64(tcfg.smoke_config)), tqp, prompts, scored, ref


@pytest.mark.parametrize("mode", ["packed", "simulated"])
def test_pertensor_tree_serves_reference_tokens(pertensor_engines, mode):
    model, tqp, prompts, scored, ref = pertensor_engines
    eng = TServe(model, tqp, max_seq=24, execution=mode, device="cpu")
    # 6-bit per-tensor leaves have no packed layout: both modes keep them
    assert all(isinstance(eng.params["dec"]["s0"]["attn"][k], tq.QTensor)
               for k in ("wq", "wk", "wv", "wo"))
    np.testing.assert_array_equal(eng.generate(prompts, 8), ref[mode][0])
    np.testing.assert_allclose(eng.score(scored), ref[mode][1], rtol=1e-4)
