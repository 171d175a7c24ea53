"""The port's model data plane against the JAX model on fp32 smoke params:
paged steps, packed ragged prefill and the decode horizon give the same
logits (1e-4) and pools (1e-5: the projections sum in another order than
XLA's dot) apart from scratch page 0, where pad rows write."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import QuantPolicy as JPolicy
from repro.core import pack_params as j_pack
from repro.core import quantize_params as j_quant
from repro.models import Model as JModel
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.models import Model as TModel

ARCH = "internlm2-1.8b"
PS, N_PAGES = 4, 16


@pytest.fixture(scope="module")
def models():
    jm, tm = JModel(j_smoke(ARCH)), TModel(t_smoke(ARCH))
    plain = jm.init(jax.random.PRNGKey(0))
    q, _ = j_quant(plain, JPolicy(bits=4, block=64, solver="dp",
                                  min_size=1024))
    packed, _ = j_pack(q)
    trees = {"plain": plain, "packed": packed}
    return jm, tm, {k: (v, from_reference(v, "cpu")) for k, v in trees.items()}


def _i32(a):
    return np.asarray(a, np.int32)


def _pools_equal_except_scratch(jpools, tpools):
    jl, tl = jpools["layers"]["s0"]["attn"], tpools["layers"]["s0"]["attn"]
    for name in ("k", "v"):
        a, b = np.asarray(jl[name]), tl[name].numpy()
        np.testing.assert_allclose(b[:, 1:], a[:, 1:], rtol=0, atol=1e-5)


def _run_both(jm, tm, jp, tp, fn_name, args, pools):
    jpools, tpools = pools
    jlog, jpools = getattr(jm, fn_name)(jp, jpools,
                                        *(jnp.asarray(a) for a in args))
    tlog, tpools = getattr(tm, fn_name)(tp, tpools,
                                        *(torch.from_numpy(a) for a in args))
    return np.asarray(jlog), tlog.numpy(), (jpools, tpools)


@pytest.mark.parametrize("kind", ["plain", "packed"])
def test_paged_step_prefill_then_decode(models, kind):
    jm, tm, trees = models
    jp, tp = trees[kind]
    pools = (jm.init_paged_pools(N_PAGES, PS),
             tm.init_paged_pools(N_PAGES, PS, device="cpu"))
    bt = _i32([[1, 2, 3, 4], [5, 6, 7, 8]])
    rng = np.random.default_rng(0)
    toks = _i32(rng.integers(0, 503, (2, 6)))
    q_pos = _i32([[0, 1, 2, 3, 4, 5], [0, 1, 2, 3, -1, -1]])
    jl, tl, pools = _run_both(jm, tm, jp, tp, "paged_step",
                              (toks, q_pos, _i32([6, 4]), bt), pools)
    np.testing.assert_allclose(tl, jl, rtol=0, atol=1e-4)
    _pools_equal_except_scratch(*pools)
    step = _i32(jl.argmax(-1))[:, None]
    jl2, tl2, pools = _run_both(jm, tm, jp, tp, "paged_step",
                                (step, _i32([[6], [4]]), _i32([7, 5]), bt),
                                pools)
    np.testing.assert_allclose(tl2, jl2, rtol=0, atol=1e-4)
    _pools_equal_except_scratch(*pools)


@pytest.mark.parametrize("kind", ["plain", "packed"])
def test_paged_prefill_packed(models, kind):
    jm, tm, trees = models
    jp, tp = trees[kind]
    pools = (jm.init_paged_pools(N_PAGES, PS),
             tm.init_paged_pools(N_PAGES, PS, device="cpu"))
    rng = np.random.default_rng(1)
    t = 16
    tokens = np.zeros(t, np.int32)
    seg = np.full(t, -1, np.int32)
    pos = np.full(t, -1, np.int32)
    tokens[:12] = rng.integers(0, 503, 12)
    seg[:5], seg[5:12] = 0, 1
    pos[:5], pos[5:12] = np.arange(5), np.arange(7)
    args = (tokens, seg, pos, _i32([5, 7, 0]),
            _i32([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]]),
            _i32([0, 1, -1]), _i32([4, 11, 0]), _i32([0, 5, 0]))
    jl, tl, pools = _run_both(jm, tm, jp, tp, "paged_prefill_packed", args,
                              pools)
    np.testing.assert_allclose(tl[:2], jl[:2], rtol=0, atol=1e-4)
    _pools_equal_except_scratch(*pools)


def test_decode_horizon_matches_reference(models):
    jm, tm, trees = models
    jp, tp = trees["packed"]
    pools = (jm.init_paged_pools(N_PAGES, PS),
             tm.init_paged_pools(N_PAGES, PS, device="cpu"))
    bt = _i32([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0], [0, 0, 0, 0]])
    rng = np.random.default_rng(2)
    toks = _i32(rng.integers(0, 503, (4, 5)))
    q_pos = _i32([[0, 1, 2, 3, 4], [0, 1, 2, -1, -1], [-1] * 5, [-1] * 5])
    jl, tl, (jpools, tpools) = _run_both(
        jm, tm, jp, tp, "paged_step", (toks, q_pos, _i32([5, 3, 0, 0]), bt),
        pools)
    first = _i32(jl.argmax(-1))
    np.testing.assert_array_equal(first[:2], tl.argmax(-1)[:2])   # live rows
    args = (first, _i32([5, 3, -1, -1]), bt, _i32([6, 2, 0, 0]),
            _i32([-1, -1, -1, -1]))
    jt, jv, _ = jm.paged_decode_horizon(jp, jpools,
                                        *(jnp.asarray(a) for a in args), 8)
    tt, tv, _ = tm.paged_decode_horizon(tp, tpools,
                                        *(torch.from_numpy(a) for a in args),
                                        8)
    np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())
    assert tv.numpy().sum(1).tolist() == [6, 2, 0, 0]


def test_param_shapes_match_reference(models):
    jm, tm, trees = models
    ours = tm.init(torch.Generator().manual_seed(0), device="cpu")

    def shapes(tree, out, path=""):
        for k, v in tree.items():
            p = f"{path}/{k}"
            if isinstance(v, dict):
                shapes(v, out, p)
            else:
                out[p] = tuple(v.shape)
        return out

    assert shapes(ours, {}) == shapes(trees["plain"][0], {})
