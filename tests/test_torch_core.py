"""The port's configs, MSB solver and storage formats against the JAX
package: same numpy inputs through both, byte- or bit-identical results."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core import grouping as jgrp
from repro.core import policy as jpol
from repro.core import quantize as jq
from repro.models import Model as JModel
from repro_torch import configs as tcfg
from repro_torch.convert import from_reference
from repro_torch.core import grouping as tgrp
from repro_torch.core import policy as tpol
from repro_torch.core import quantize as tq


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("arch", jcfg.list_archs())
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_reference(arch, smoke):
    a = jcfg.smoke_config(arch) if smoke else jcfg.get_config(arch)
    b = tcfg.smoke_config(arch) if smoke else tcfg.get_config(arch)
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    assert np.dtype(da.pop("dtype")).name == str(db.pop("dtype"))[6:]
    assert da == db
    assert (a.vocab_padded, a.head_dim_, a.n_params()) == \
        (b.vocab_padded, b.head_dim_, b.n_params())


def _blocks(seed):
    rng = np.random.default_rng(seed)
    b = rng.standard_normal((300, 64)).astype(np.float32)
    b[:20] = np.round(b[:20] * 4) / 4             # many exact ties
    b[20:30, :16] = 0.0                           # exact zeros
    b[30:40] = rng.standard_t(2, (10, 64))        # heavy tails
    return b


@pytest.mark.parametrize("seed", [0, 1])
def test_dp_solver_matches_reference(seed):
    blocks = _blocks(seed)
    jl, js = jgrp.solve_blocks(jnp.asarray(blocks), 8)
    tl, ts = tgrp.solve_blocks(torch.from_numpy(blocks), 8, chunk=128)
    jl, js, tl, ts = np.asarray(jl), np.asarray(js), _np(tl), _np(ts)
    same = (jl == tl).all(1) & (js == ts).all(1)
    # a near-tie may pick other boundaries; then the reconstruction SSE
    # must be equal within 1e-6 relative
    for i in np.flatnonzero(~same):
        mag = np.abs(blocks[i])
        sse_j = np.sum((mag - js[i][jl[i]]) ** 2)
        sse_t = np.sum((mag - ts[i][tl[i]]) ** 2)
        assert abs(sse_j - sse_t) <= 1e-6 * max(sse_j, 1e-30)
    assert same.mean() > 0.95


def test_dp_boundaries_are_the_exact_optimum():
    """Against brute force on tiny blocks: 3 groups over 7 sorted values."""
    import itertools
    rng = np.random.default_rng(5)
    v = np.sort(np.abs(rng.standard_normal((20, 7)))).astype(np.float32)
    bounds, cost = tgrp.dp_boundaries(torch.from_numpy(v), 3)
    for row, c in zip(v, _np(cost)):
        best = min(sum(np.sum((row[a:b] - row[a:b].mean()) ** 2)
                       for a, b in zip((0,) + cut, cut + (7,)))
                   for cut in itertools.combinations(range(1, 7), 2))
        assert abs(best - c) <= 1e-5


def test_quantize_blockwise_codes_and_scales_match():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((2, 64, 128)).astype(np.float32)
    jqt = jq.quantize_blockwise(jnp.asarray(w))
    tqt = tq.quantize_blockwise(torch.from_numpy(w))
    np.testing.assert_array_equal(np.asarray(jqt.codes), _np(tqt.codes))
    np.testing.assert_array_equal(np.asarray(jqt.scales), _np(tqt.scales))
    np.testing.assert_array_equal(np.asarray(jq.dequantize(jqt)),
                                  _np(tq.dequantize(tqt)))


@pytest.mark.parametrize("transpose", [False, True])
def test_pack_qtensor_bytes_match(transpose):
    rng = np.random.default_rng(3)
    # vocab 503 packs transposed to N = 503, padded to 512
    shape = (503, 64) if transpose else (2, 64, 128)
    w = rng.standard_normal(shape).astype(np.float32)
    w.reshape(-1)[:10] = 0.0                      # packed zeros -> +alpha_0
    jp = jq.pack_qtensor(jq.quantize_blockwise(jnp.asarray(w)),
                         transpose=transpose)
    tp = tq.pack_qtensor(tq.quantize_blockwise(torch.from_numpy(w)),
                         transpose=transpose)
    assert (jp.n, jp.n_pad, jp.kblocked) == (tp.n, tp.n_pad, tp.kblocked)
    np.testing.assert_array_equal(np.asarray(jp.packed), _np(tp.packed))
    np.testing.assert_array_equal(np.asarray(jp.scales), _np(tp.scales))
    np.testing.assert_array_equal(np.asarray(jq.packed_dequantize(jp)),
                                  _np(tq.packed_dequantize(tp)))


def test_packed_gather_bit_identical():
    rng = np.random.default_rng(4)
    w = rng.standard_normal((503, 64)).astype(np.float32)
    jp = jq.pack_qtensor(jq.quantize_blockwise(jnp.asarray(w[:448])))
    tp = tq.pack_qtensor(tq.quantize_blockwise(torch.from_numpy(w[:448])))
    idx = rng.integers(0, 448, (3, 5))
    np.testing.assert_array_equal(
        np.asarray(jq.packed_gather(jp, jnp.asarray(idx))),
        _np(tq.packed_gather(tp, torch.from_numpy(idx))))


def test_int4_codes_roundtrip_matches():
    rng = np.random.default_rng(6)
    codes = rng.integers(1, 9, (16, 64)) * rng.choice([-1, 1], (16, 64))
    codes = codes.astype(np.int8)
    jb = jq.pack_codes_int4(jnp.asarray(codes))
    tb = tq.pack_codes_int4(torch.from_numpy(codes))
    np.testing.assert_array_equal(np.asarray(jb), _np(tb))
    np.testing.assert_array_equal(_np(tq.unpack_codes_int4(tb, codes.shape)),
                                  codes)


@pytest.fixture(scope="module")
def smoke_params():
    import jax
    cfg = jcfg.smoke_config("internlm2-1.8b")
    return JModel(cfg).init(jax.random.PRNGKey(0))


def _assert_tree_equal(jtree, ttree, path=""):
    if isinstance(jtree, dict):
        assert set(jtree) == set(ttree), path
        for k in jtree:
            _assert_tree_equal(jtree[k], ttree[k], f"{path}/{k}")
        return
    if isinstance(jtree, jq.PackedQTensor):
        assert isinstance(ttree, tq.PackedQTensor), path
        assert (jtree.n, jtree.kblocked) == (ttree.n, ttree.kblocked), path
        pairs = [(jtree.packed, ttree.packed), (jtree.scales, ttree.scales)]
    elif isinstance(jtree, jq.QTensor):
        assert isinstance(ttree, tq.QTensor), path
        pairs = [(jtree.codes, ttree.codes), (jtree.scales, ttree.scales)]
    else:
        pairs = [(jtree, ttree)]
    for a, b in pairs:
        np.testing.assert_array_equal(np.asarray(a), _np(b), err_msg=path)


def test_quantize_and_pack_params_match_reference(smoke_params):
    policy = dict(bits=4, block=64, solver="dp", min_size=1024)
    jqp, jrep = jpol.quantize_params(smoke_params, jpol.QuantPolicy(**policy))
    tqp, trep = tpol.quantize_params(from_reference(smoke_params, "cpu"),
                                     tpol.QuantPolicy(**policy),
                                     device="cpu")
    assert sorted(jrep) == sorted(trep)
    _assert_tree_equal(jqp, tqp)
    jpk, _ = jpol.pack_params(jqp)
    tpk, _ = tpol.pack_params(tqp, device="cpu")
    _assert_tree_equal(jpk, tpk)
    # the reference's packed tree carried across equals the port's own
    _assert_tree_equal(jpk, from_reference(jpk, "cpu"))
    _assert_tree_equal(jpol.dequantize_params(jpk),
                       tpol.dequantize_params(tpk))
