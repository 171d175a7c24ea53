"""The port's xLSTM blocks (``repro_torch.models.xlstm``) against the JAX
package's on xlstm-125m's fp32 smoke config, the reference's params
carried across with ``convert.from_reference``: ``mlstm_layer`` and
``slstm_layer`` in prefill (output and every state leaf) at S=12 and at
the prime 13, and a chain of single-step decodes from the initial state
(stabilizer m = -1e30) that reproduces the prefill's outputs and last
state; the init of the mLSTM's forget bias and the sLSTM's recurrence.

Tolerance: every f32 output and state within 1e-5 of the reference's
largest magnitude (``_close``): the port multiplies and sums in another
order than XLA."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import Model as JModel
from repro.models import xlstm as jx
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.models import xlstm as tx

ARCH = "xlstm-125m"
RTOL = 1e-5
LAYERS = {"slstm": (tx.slstm_layer, jx.slstm_layer, "s0"),
          "mlstm": (tx.mlstm_layer, jx.mlstm_layer, "s1")}


def _close(got, want, rtol=RTOL):
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.fixture(scope="module")
def setup():
    """{kind: (reference params, port params, port fn, jitted reference
    prefill, jitted reference step)} for layer 0's sLSTM (slot 0) and
    mLSTM (slot 1), and the two configs."""
    jcfg, tcfg = j_smoke(ARCH), t_smoke(ARCH)
    params = JModel(jcfg).init(jax.random.PRNGKey(0))
    out = {}
    for kind, (tfn, jfn, slot) in LAYERS.items():
        jp = jax.tree_util.tree_map(lambda a: a[0],
                                    params["dec"][slot][kind])
        out[kind] = (jp, from_reference(jp, "cpu"), tfn,
                     jax.jit(lambda p, x, jfn=jfn: jfn(p, x, jcfg)),
                     jax.jit(lambda p, x, c, jfn=jfn: jfn(p, x, jcfg, c)))
    return jcfg, tcfg, out


def _x(s, d, seed):
    return np.random.default_rng(seed).standard_normal((2, s, d)).astype(
        np.float32)


@pytest.mark.parametrize("s", [12, 13])
@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_prefill_matches_reference(setup, kind, s):
    jcfg, tcfg, layers = setup
    jp, tp, tfn, jprefill, _ = layers[kind]
    x = _x(s, jcfg.d_model, seed=s)
    jy, jst = jprefill(jp, jnp.asarray(x))
    ty, tst = tfn(tp, torch.from_numpy(x), tcfg)
    _close(ty, jy)
    assert sorted(tst) == sorted(jst)
    for k in jst:
        _close(tst[k], jst[k])
        assert tst[k].dtype == torch.float32


@pytest.mark.parametrize("kind", sorted(LAYERS))
def test_decode_chain_reproduces_prefill(setup, kind):
    """Single-step decodes from the prefill's initial state (zeros, m =
    -1e30): each step against the reference's step, and the chain's
    outputs and last state against the port's prefill over the same 12
    positions."""
    jcfg, tcfg, layers = setup
    jp, tp, tfn, _, jstep = layers[kind]
    s = 12
    x = _x(s, jcfg.d_model, seed=4)
    py, pst = tfn(tp, torch.from_numpy(x), tcfg)
    shapes = tx.xlstm_cache_shapes(tcfg, 2, kind)
    cache = {k: (torch.full(shp, -1e30) if k == "m" else torch.zeros(shp))
             for k, (shp, _dt) in shapes.items()}
    jcache = {k: jnp.asarray(v.numpy()) for k, v in cache.items()}
    ys = []
    for t in range(s):
        y, cache = tfn(tp, torch.from_numpy(x[:, t:t + 1]), tcfg, cache)
        jy, jcache = jstep(jp, jnp.asarray(x[:, t:t + 1]), jcache)
        _close(y, jy)
        for k in jcache:
            _close(cache[k], jcache[k])
        ys.append(y)
    _close(torch.cat(ys, dim=1), py.numpy())
    for k in pst:
        _close(cache[k], pst[k].numpy())


def test_xlstm_init_kinds():
    """The mLSTM's forget bias is 3 and the sLSTM's recurrent weights
    0.1 N(0, 1), as the reference inits them."""
    from repro_torch.models import Model
    p = Model(t_smoke(ARCH)).init(torch.Generator().manual_seed(0),
                                  device="cpu")
    fb = p["dec"]["s1"]["mlstm"]["f_bias"]
    assert torch.equal(fb, torch.full_like(fb, 3.0))
    rec = p["dec"]["s0"]["slstm"]["w_rec"]
    assert 0.05 < float(rec.std()) < 0.15
