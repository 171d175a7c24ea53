"""The port's frontends and enc-dec stack against the JAX package's on
fp32 smoke configs, the reference's params carried across with
``convert.from_reference``:

* whisper-large-v3: the encoder's output over audio frames (sinusoidal
  positions, non-causal attention), the loss, ``prefill``'s logits and
  cache (the decoder's ``attn`` K/V, the cross-attention's ``xattn`` K/V
  over the encoder rows, ``pos``), and 4 decode steps (ring self-attention
  and cross-attention over the static encoder K/V) from the reference's
  grown cache;
* internvl2-76b: loss, ``prefill`` and 4 decode steps with patch
  embeddings before the tokens;
* ``cache_defs`` / ``init_cache`` of the four stacks with per-sequence
  state or a frontend against the reference's.

Tolerance: every f32 output, logit and cache leaf within 1e-5 of the
reference's largest magnitude (``_close``); the port multiplies and sums
in another order than XLA."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import Model as JModel
from repro.serve import ServeEngine as JServe
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference, torch_dtype
from repro_torch.models import Model as TModel
from repro_torch.serve import ServeEngine

STATE_ARCHS = ["jamba-v0.1-52b", "xlstm-125m", "whisper-large-v3",
               "internvl2-76b"]
RTOL = 1e-5
B, P, S_ENC, MAX_SEQ = 2, 7, 10, 16


def _close(got, want, rtol=RTOL):
    """Finite entries within ``rtol`` of the largest finite |want|; the
    padded vocabulary's -inf logits equal."""
    got = np.asarray(got.detach().cpu() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    err = np.abs(got[fin] - want[fin]).max()
    assert err <= rtol * np.abs(want[fin]).max(), (err,
                                                   np.abs(want[fin]).max())


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _close_trees(got, want):
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(g) == sorted(w)
    for path in w:
        if np.asarray(w[path]).dtype == np.int32:
            np.testing.assert_array_equal(g[path].numpy(),
                                          np.asarray(w[path]))
        else:
            _close(g[path], w[path])


FRONTEND_ARCHS = ["whisper-large-v3", "internvl2-76b"]


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(reference model, port model, reference params, port params, jitted
    reference loss / prefill / decode_step, a batch) of ``arch``."""
    jm, tm = JModel(j_smoke(arch)), TModel(t_smoke(arch))
    jp = jm.init(jax.random.PRNGKey(0))
    cfg = jm.cfg
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, P)).astype(
        np.int32)}
    extra = P
    if cfg.frontend == "vision":
        extra = P + cfg.n_frontend_tokens
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.standard_normal(
            (B, S_ENC, cfg.d_model)).astype(np.float32)
    batch["labels"] = rng.integers(0, cfg.vocab_size, (B, extra)).astype(
        np.int32)
    fns = (jax.jit(jm.loss), jax.jit(jm.prefill), jax.jit(jm.decode_step))
    return jm, tm, jp, from_reference(jp, "cpu"), fns, batch


def _j(batch, drop=()):
    return {k: jnp.asarray(v) for k, v in batch.items() if k not in drop}


def _t(batch, drop=()):
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if k not in drop}


def test_encoder_matches_reference():
    jm, tm, jp, tp, _, batch = _setup("whisper-large-v3")
    want = jax.jit(lambda p, b: jm._encoder(p, b, None))(jp, _j(batch))
    got = tm._encoder(tp, _t(batch))
    _close(got, want)


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_loss_matches_reference(arch):
    jm, tm, jp, tp, (jloss, _, _), batch = _setup(arch)
    jl, jmet = jloss(jp, _j(batch))
    tl, tmet = tm.loss(tp, _t(batch))
    _close(tl, jl)
    _close(tmet["ce"], jmet["ce"])


@pytest.mark.parametrize("arch", FRONTEND_ARCHS)
def test_prefill_and_decode_steps_match_reference(arch):
    """``prefill`` logits and every cache leaf, then 4 greedy decode steps
    that both sides start from their own grown caches (the reference's
    engine's ``_grow_cache`` and the port's): logits each step, and at the
    end every cache leaf (whisper's ``xattn`` still S_enc rows long)."""
    jm, tm, jp, tp, (_, jprefill, jdecode), batch = _setup(arch)
    jlog, jcache = jprefill(jp, _j(batch, ("labels",)))
    tlog, tcache = tm.prefill(tp, _t(batch, ("labels",)))
    _close(tlog, jlog)
    _close_trees(tcache, jcache)
    s0 = jcache["pos"].shape[1]
    jcache = JServe._grow_cache(type("E", (), {"max_seq": MAX_SEQ})(),
                                jcache, s0)
    tcache = ServeEngine(tm, {}, max_seq=MAX_SEQ, execution="simulated",
                         device="cpu")._grow_cache(tcache, s0)
    _close_trees(tcache, jcache)
    tok = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
    for i in range(4):
        pos = np.full((B,), s0 + i, np.int32)
        jlog, jcache = jdecode(jp, jcache, jnp.asarray(tok),
                               jnp.asarray(pos))
        tlog, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                      torch.from_numpy(pos))
        _close(tlog, jlog)
        tok = np.asarray(jlog).argmax(-1).astype(np.int32)[:, None]
    _close_trees(tcache, jcache)
    if jm.cfg.is_encdec:
        assert tcache["layers"]["s0"]["xattn"]["k"].shape[2] == S_ENC


@pytest.mark.parametrize("arch", STATE_ARCHS)
def test_cache_defs_and_init_cache_match_reference(arch):
    """Every leaf's shape and dtype, and ``init_cache``'s values: zeros for
    K/V and state alike, ``pos`` 0..S-1, no ``pos`` without attention
    (xlstm), whisper's ``xattn`` at ``seq_len`` rows."""
    jm, tm = JModel(j_smoke(arch)), TModel(t_smoke(arch))
    jflat = dict(_defs_flat(jm.cache_defs(3, 9)))
    tflat = dict(_defs_flat(tm.cache_defs(3, 9)))
    assert sorted(tflat) == sorted(jflat)
    for path, (shape, dt, _ax) in jflat.items():
        assert tflat[path] == (tuple(shape), torch_dtype(dt)), path
    assert ("pos" in tm.cache_defs(3, 9)) == (arch != "xlstm-125m")
    _close_trees(tm.init_cache(3, 9, device="cpu"), jm.init_cache(3, 9))


def _defs_flat(defs, path=()):
    """(path, leaf tuple) of a ``cache_defs`` tree, whose leaves are
    tuples."""
    for k in sorted(defs):
        v = defs[k]
        if isinstance(v, dict):
            yield from _defs_flat(v, path + (k,))
        else:
            yield path + (k,), v
