"""GSPMD static decode of the port with the cache cut over ``head_dim``,
against the reference's GSPMD runs at the same mesh shape on the host
devices ``tests/conftest.py`` forces.

On a (1, 4) ("data", "model") mesh the resolver cuts a K/V cache over
``head_dim`` when neither its ring nor its KV heads divide four ways:

* smoke internlm2 (2 KV heads, d = 16) with a ring of 37 entries;
* smoke whisper with ``n_kv_heads`` replaced by 2 in both configs, a
  13-token prompt and 15 encoder frames: the self-attention ring and the
  static cross-attention K/V both go over ``head_dim``.

Each runs ``prefill`` and 4 ``decode_step``s under the context: logits
within 1e-5 of each row's largest and every cache leaf within 1e-5 of
its largest, against the reference's GSPMD jit on the first four host
devices. ``ServeEngine(parallel=)`` with an odd ``max_seq`` gives the
tokens of one device.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gspmd_ranks as ranks
import torch_gspmd_setup as setup
from repro.models import Model as JModel
from repro.parallel import from_mesh as j_from_mesh
from repro_torch.convert import from_reference
from repro_torch.models import Model as TModel
from repro_torch.models.attention import decode_attention
from repro_torch.models.model import CacheLayout
from repro_torch.parallel import sharding as shd
from repro_torch.serve import ServeEngine

SHAPE = (1, 4)
CUT = (None, None, None, None, "model")     # a K/V leaf over head_dim


@pytest.fixture(autouse=True, scope="module")
def _close_meshes():
    yield
    setup.close_meshes()


def _rowwise(got, want, tol=1e-5):
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


def _configs(arch):
    jc, tc = setup.smoke(arch)
    if jc.is_encdec:             # GQA: KV heads that do not divide model
        jc = dataclasses.replace(jc, n_kv_heads=2)
        tc = dataclasses.replace(tc, n_kv_heads=2)
    return jc, tc


def _batch(cfg, b, s, s_enc=15):
    rng = np.random.default_rng(5)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
        np.int32)}
    if cfg.is_encdec:
        out["frames"] = rng.standard_normal(
            (b, s_enc, cfg.d_model)).astype(np.float32)
    return out


CASES = [("internlm2-1.8b", 37), ("whisper-large-v3", 13)]


@pytest.mark.parametrize("arch,s", CASES)
def test_head_dim_cut_decode_matches_reference(arch, s):
    jc, tc = _configs(arch)
    jm, tm = JModel(jc), TModel(tc)
    params = jm.init(jax.random.PRNGKey(0))
    b = 2
    batch = _batch(jc, b, s)
    mesh = setup.mesh(SHAPE)
    ctx = shd.from_mesh(mesh)
    # the cache really goes over head_dim: every K/V leaf, self and cross
    layout = tm.cache_layout(batch, b)
    specs = dict(setup.leaves(tm.cache_specs(ctx, layout)))
    kv = {p: sp for p, sp in specs.items() if p[-1] in ("k", "v")}
    assert kv and all(sp == CUT for sp in kv.values()), kv
    assert any("xattn" in p for p in kv) == jc.is_encdec

    jmesh = setup.j_mesh(SHAPE)
    jctx = j_from_mesh(jmesh)
    j_prefill = jax.jit(lambda p, bt: jm.prefill(p, bt, jctx))
    j_decode = jax.jit(lambda p, c, t, pos: jm.decode_step(p, c, t, pos,
                                                           jctx))
    with jmesh:
        want, jcache = j_prefill(params, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    placed = shd.device_put(from_reference(params, "cpu"),
                            tm.param_shardings(ctx), mesh)
    got, cache = tm.prefill(placed, batch, ctx)
    _rowwise(got, want)
    _caches_close(shd.gather(cache), jcache)
    blocks = mesh.gather(ranks.block_shapes, cache.key)
    hd = tc.head_dim_
    for blk in blocks:
        for p in kv:
            assert blk[p][-1] == hd // 4, (p, blk[p])
    cur = np.full((b,), s, np.int32)
    for _ in range(4):
        tok = np.argmax(np.asarray(want), -1).astype(np.int32)
        np.testing.assert_array_equal(np.argmax(got.numpy(), -1), tok)
        with jmesh:
            want, jcache = j_decode(params, jcache,
                                    jnp.asarray(tok[:, None]),
                                    jnp.asarray(cur))
        got, cache = tm.decode_step(placed, cache, torch.from_numpy(
            tok[:, None]), torch.from_numpy(cur), ctx)
        _rowwise(got, want)
        cur = cur + 1
    _caches_close(shd.gather(cache), jcache)
    cache.drop()
    placed.drop()


@pytest.mark.parametrize("cross", [False, True])
def test_head_dim_split_attention_matches_one_device(cross):
    """``spmd_attention_decode``'s pieces on a cache cut four ways over d
    (formerly refused with NotImplementedError): partial scores summed
    over ``head_dim`` before the softcap and the mask, the rank's slice
    of d gathered, against one device's ``decode_attention`` (a window of
    4 on the ring, row 1 seeing only part of it)."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(3, 1, 4, 16, generator=g)
    k = torch.randn(3, 12, 2, 16, generator=g)
    v = torch.randn(3, 12, 2, 16, generator=g)
    pos = torch.arange(12, dtype=torch.int32)[None].expand(3, 12).clone()
    pos[1, 7:] = -1
    cur = torch.tensor([11, 6, 11] if not cross else [11, 11, 11],
                       dtype=torch.int32)
    kw = dict(softcap=5.0, scale=0.25, window=0 if cross else 4)
    want = decode_attention(q, k, v, pos, cur, **kw)
    outs = setup.mesh(SHAPE).gather(ranks.head_dim_split, q, k, v, pos, cur,
                                    kw)
    for got in outs:
        assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_head_dim_cut_needs_the_heads_scale():
    """With a ``head_dim`` cut (``dsum``) the local d is a slice of the
    head's, so ``decode_attention`` refuses to take its scale from it."""
    q = torch.zeros(1, 1, 2, 4)
    kv = torch.zeros(1, 3, 2, 4)
    pos = torch.arange(3, dtype=torch.int32)[None]
    ctx = shd.from_mesh(shd.MeshShape(SHAPE, ("data", "model")))
    with pytest.raises(ValueError, match="head's scale"):
        decode_attention(q, kv, kv, pos, torch.tensor([2]),
                         dsum=(ctx, ("model",)))


def test_serve_engine_odd_max_seq_matches_one_device():
    """``ServeEngine(parallel=)`` grows the ring to ``max_seq`` 37 on
    (1, 4), which the resolver cuts over ``head_dim``: greedy tokens are
    one device's."""
    jc, tc = _configs("internlm2-1.8b")
    tm = TModel(tc)
    tp = from_reference(JModel(jc).init(jax.random.PRNGKey(1)), "cpu")
    ctx = shd.from_mesh(setup.mesh(SHAPE))
    assert tm.cache_specs(ctx, CacheLayout(4, 37))["layers"]["s0"][
        "attn"]["k"] == CUT
    prompts = np.random.default_rng(7).integers(
        0, tc.vocab_size, (4, 12)).astype(np.int32)
    eng = ServeEngine(tm, tp, max_seq=37, device="cpu",
                      execution="simulated", parallel=ctx)
    one = ServeEngine(tm, tp, max_seq=37, device="cpu",
                      execution="simulated")
    np.testing.assert_array_equal(eng.generate(prompts, 8),
                                  one.generate(prompts, 8))
