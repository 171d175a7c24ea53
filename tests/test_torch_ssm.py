"""The port's mamba block (``repro_torch.models.ssm``) against the JAX
package's on jamba's fp32 smoke config, the reference's params carried
across with ``convert.from_reference``: the causal depthwise conv with and
without a carried state, the chunked sequential scan against the
reference's ``_ssm_scan_seq`` and associative ``_ssm_scan``, ``mamba_layer``
in prefill (output and {conv, ssm} state) at an S of several chunks and at
a prime S (chunk 1), and a chain of single-step decodes that reproduces
the prefill's outputs and last state.

Tolerance: every f32 output and state within 1e-5 of the reference's
largest magnitude (``_close``): the port multiplies and sums in another
order than XLA (``torch.matmul``/``einsum`` against ``jnp.einsum``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import Model as JModel
from repro.models import ssm as jssm
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.models import ssm as tssm

ARCH = "jamba-v0.1-52b"
CHUNK = 4                       # mamba_chunk: S=12 runs 3 chunks, S=13 1s
RTOL = 1e-5


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def setup():
    """(reference config, port config, layer 0's mamba params in both
    packages, jitted reference layer fns)."""
    jcfg = dataclasses.replace(j_smoke(ARCH), mamba_chunk=CHUNK)
    tcfg = dataclasses.replace(t_smoke(ARCH), mamba_chunk=CHUNK)
    params = JModel(jcfg).init(jax.random.PRNGKey(0))
    jp = jax.tree_util.tree_map(lambda a: a[0], params["dec"]["s0"]["mamba"])
    jlayer = jax.jit(lambda p, x, c: jssm.mamba_layer(p, x, jcfg, c))
    jprefill = jax.jit(lambda p, x: jssm.mamba_layer(p, x, jcfg))
    return jcfg, tcfg, jp, from_reference(jp, "cpu"), jprefill, jlayer


def _x(s, d, seed=0, b=2):
    return np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 8)).astype(np.float32)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    st = rng.standard_normal((2, 3, 8)).astype(np.float32) if with_state \
        else None
    jy, jst = jssm._causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                  None if st is None else jnp.asarray(st))
    ty, tst = tssm._causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                  None if st is None else torch.from_numpy(st))
    _close(ty, jy)
    _close(tst, jst)


@pytest.mark.parametrize("s", [12, 13])
def test_chunked_scan_matches_reference_scans(s):
    """The port's sequential scan run chunk by chunk (chunk size as
    ``mamba_layer`` chooses it: 4 at S=12, 1 at the prime 13) against the
    reference's sequential scan over all of S and its associative scan;
    the port's associative-scan oracle too."""
    rng = np.random.default_rng(s)
    da = rng.uniform(0.5, 1.0, (2, s, 6, 4)).astype(np.float32)
    db = rng.standard_normal((2, s, 6, 4)).astype(np.float32)
    h0 = rng.standard_normal((2, 6, 4)).astype(np.float32)
    jhs, jh = jssm._ssm_scan_seq(jnp.asarray(da), jnp.asarray(db),
                                 jnp.asarray(h0))
    ahs, ah = jssm._ssm_scan(jnp.asarray(da), jnp.asarray(db),
                             jnp.asarray(h0))
    ck = tssm._chunk(s, CHUNK)
    assert ck == (4 if s == 12 else 1)
    h, hs = torch.from_numpy(h0), []
    for i in range(0, s, ck):
        part, h = tssm._ssm_scan_seq(torch.from_numpy(da[:, i:i + ck]),
                                     torch.from_numpy(db[:, i:i + ck]), h)
        hs.append(part)
    hs = torch.cat(hs, dim=1)
    for want_hs, want_h in ((jhs, jh), (ahs, ah)):
        _close(hs, want_hs)
        _close(h, want_h)
    ohs, oh = tssm._ssm_scan(torch.from_numpy(da), torch.from_numpy(db),
                             torch.from_numpy(h0))
    _close(ohs, ahs)
    _close(oh, ah)


@pytest.mark.parametrize("s", [12, 13])
def test_mamba_prefill_matches_reference(setup, s):
    """``mamba_layer`` without a cache: output and the {conv, ssm} state
    it returns, at S=12 (3 chunks) and S=13 (13 chunks of 1)."""
    jcfg, tcfg, jp, tp, jprefill, _ = setup
    x = _x(s, jcfg.d_model, seed=s)
    jy, jst = jprefill(jp, jnp.asarray(x))
    ty, tst = tssm.mamba_layer(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    for k in ("conv", "ssm"):
        _close(tst[k], jst[k])
    assert tst["ssm"].dtype == torch.float32


def test_mamba_decode_chain_reproduces_prefill(setup):
    """Single-step decodes from a zero state, one position at a time: each
    step's output and state against the reference's step, and the chain's
    outputs and last state against the prefill over the same 12
    positions."""
    jcfg, tcfg, jp, tp, jprefill, jlayer = setup
    s = 12
    x = _x(s, jcfg.d_model, seed=3)
    py, pst = tssm.mamba_layer(tp, torch.from_numpy(x), tcfg)
    shapes = tssm.mamba_cache_shapes(tcfg, 2)
    cache = {k: torch.zeros(shp, dtype=dt) for k, (shp, dt) in shapes.items()}
    jcache = {k: jnp.zeros(shp, jnp.float32) for k, (shp, _dt) in
              shapes.items()}
    ys = []
    for t in range(s):
        y, cache = tssm.mamba_layer(tp, torch.from_numpy(x[:, t:t + 1]),
                                    tcfg, cache)
        jy, jcache = jlayer(jp, jnp.asarray(x[:, t:t + 1]), jcache)
        _close(y, jy)
        for k in ("conv", "ssm"):
            _close(cache[k], jcache[k])
        ys.append(y)
    _close(torch.cat(ys, dim=1), py.numpy())
    for k in ("conv", "ssm"):
        _close(cache[k], pst[k].numpy())


def test_mamba_init_kinds():
    """The mamba leaves' init kinds: a_log log(1..N) on every row,
    conv_w and d_skip ones, dt_bias the inverse softplus of a draw in
    [1e-3, 0.1]."""
    from repro_torch.models import Model
    cfg = t_smoke(ARCH)
    p = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    m = p["dec"]["s0"]["mamba"]
    n = cfg.mamba_d_state
    want = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
    assert torch.equal(m["a_log"], want.expand_as(m["a_log"]))
    assert torch.equal(m["conv_w"], torch.ones_like(m["conv_w"]))
    assert torch.equal(m["d_skip"], torch.ones_like(m["d_skip"]))
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert dt.min() >= 1e-3 * (1 - 1e-5) and dt.max() <= 0.1 * (1 + 1e-5)
