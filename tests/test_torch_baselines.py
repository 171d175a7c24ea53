"""The port's baselines (``core.baselines``: RTN, NF4, HQQ, GPTQ, XNOR) and
kernel A's ``QTensor`` entry points (``qtensor_matmul``,
``to_kernel_layout``) against the JAX package, on the same numpy inputs.

Tolerances: RTN, NF4, HQQ (block-wise) and XNOR within 1e-6 relative
(Frobenius); per-tensor HQQ's reconstruction error within 1 % (see its
test); GPTQ, float64 inside, within 1e-9 relative; ``qtensor_matmul``
within 1e-5 of the reference's jnp path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import quantize as jq
from repro.kernels.msb_matmul import ops as jops
from repro_torch.core import baselines as tb
from repro_torch.core import quantize as tq
from repro_torch.kernels.msb_matmul import ops as tops


def _w(shape=(64, 256), seed=0):
    w = np.random.default_rng(seed).standard_t(4, size=shape).astype(
        np.float32)
    return w * (0.02 / w.std())


def _assert_rel(got, want, rel):
    got = got.detach().cpu().numpy().astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= rel * np.linalg.norm(want)


@pytest.mark.parametrize("bits,block,symmetric", [
    (4, 64, True), (4, 64, False), (6, -1, True), (3, -1, False)])
def test_rtn_matches_reference(bits, block, symmetric):
    w = _w()
    _assert_rel(tb.rtn_quantize(torch.from_numpy(w), bits, block, symmetric),
                jb.rtn_quantize(w, bits, block, symmetric), 1e-6)


@pytest.mark.parametrize("bits,block", [(4, 64), (4, -1), (3, 64)])
def test_nf_matches_reference(bits, block):
    w = _w(seed=1)
    np.testing.assert_array_equal(tb._normal_float_codebook(bits),
                                  np.asarray(jb._normal_float_codebook(bits)))
    _assert_rel(tb.nf4_quantize(torch.from_numpy(w), bits, block),
                jb.nf4_quantize(w, bits, block), 1e-6)


@pytest.mark.parametrize("bits", [4, 3])
def test_hqq_matches_reference(bits):
    w = _w(seed=2)
    _assert_rel(tb.hqq_quantize(torch.from_numpy(w), bits, 64),
                jb.hqq_quantize(w, bits, 64), 1e-6)


@pytest.mark.parametrize("seed", [2, 3])
def test_hqq_pertensor_error_matches_reference(seed):
    """Per tensor, HQQ's zero point is an f32 mean over the whole tensor,
    which the two packages sum in different orders; a one-ulp difference
    flips half-way roundings that the 20 iterations carry on, so the
    outputs are not held element by element. The reconstruction error
    (what the paper's tables report) agrees within 1 %."""
    w = _w((128, 1024), seed=seed)
    got = tb.hqq_quantize(torch.from_numpy(w), 4, -1).numpy()
    want = np.asarray(jb.hqq_quantize(w, 4, -1))
    err_t, err_j = ((got - w) ** 2).sum(), ((want - w) ** 2).sum()
    assert abs(err_t - err_j) <= 0.01 * err_j


@pytest.mark.parametrize("bits,block", [(4, 64), (4, -1)])
def test_gptq_matches_reference(bits, block):
    w = _w((32, 128), seed=3)
    _assert_rel(tb.gptq_quantize(torch.from_numpy(w), bits, block),
                jb.gptq_quantize(w, bits, block), 1e-9)


def test_xnor_matches_reference():
    w = _w(seed=4)
    _assert_rel(tb.xnor_quantize(torch.from_numpy(w)), jb.xnor_quantize(w),
                1e-6)
    _assert_rel(tb.blocked_xnor_quantize(torch.from_numpy(w)),
                jb.blocked_xnor_quantize(w), 1e-6)


def test_to_kernel_layout_matches_reference():
    w = _w((128, 256), seed=5)
    jp, js = jops.to_kernel_layout(jq.quantize_blockwise(jnp.asarray(w)))
    tp, ts = tops.to_kernel_layout(tq.quantize_blockwise(torch.from_numpy(w)))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    with pytest.raises(ValueError, match="4-bit block-64"):
        tops.to_kernel_layout(tq.quantize_pertensor(torch.from_numpy(w), 6))


def test_qtensor_matmul_matches_reference_and_packs_once(monkeypatch):
    w = _w((128, 256), seed=6)
    x = np.random.default_rng(7).standard_normal((3, 5, 128)).astype(
        np.float32)
    want = jops.qtensor_matmul(jnp.asarray(x),
                               jq.quantize_blockwise(jnp.asarray(w)),
                               use_kernel=False)
    q = tq.quantize_blockwise(torch.from_numpy(w))
    packs = []
    real = tops.pack_qtensor
    monkeypatch.setattr(tops, "pack_qtensor",
                        lambda qt: packs.append(qt) or real(qt))
    y = tops.qtensor_matmul(torch.from_numpy(x), q)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))
    y2 = tops.qtensor_matmul(torch.from_numpy(x), q)
    assert len(packs) == 1 and torch.equal(y, y2)
    # another scale buffer under the same codes is packed anew
    q2 = tq.QTensor(q.codes, q.scales.clone(), 4, 64, q.dtype)
    tops.qtensor_matmul(torch.from_numpy(x), q2)
    assert len(packs) == 2
