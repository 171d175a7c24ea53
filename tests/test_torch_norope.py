"""Paged serving of an attention stack without RoPE, the port against the
JAX package: internlm2's smoke config with ``use_rope=False`` (vocabulary
64, norms moved off 0), whose paged steps add the reference's sinusoidal
positions of ``q_pos`` to the embeddings and rope nothing
(``repro.models.model.Model.paged_step`` / ``paged_prefill_packed``,
``repro.models.layers.attention_layer``).

* ``paged_prefill_packed``, ``paged_step`` and ``paged_decode_horizon``
  over packed params at kv_bits 16, 8 and 4 against the reference
  engine's jitted dispatches: logits within 1e-5 of the reference's
  largest, horizon tokens and masks identical;
* ``ContinuousEngine`` greedy tokens identical to
  ``repro.serve.ContinuousEngine``'s at the same kv_bits;
* the sinusoid is a device computation of ``q_pos``: a row's logits do
  not depend on the other rows of its batch."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_families_setup as fam
from repro.configs import smoke_config as j_smoke
from repro.core import pack_params as j_pack
from repro.models import Model as JModel
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.models import Model as TModel
from repro_torch.serve import ContinuousEngine

ARCH = "internlm2-1.8b"
ENGINE = dict(max_batch=4, page_size=fam.PS, num_pages=64, max_seq=40,
              prefill_chunk=6, prefill_buckets=(24,), decode_horizon=8)
WIDTH = ENGINE["max_seq"] // fam.PS


def _i32(a):
    return np.asarray(a, np.int32)


@functools.lru_cache(maxsize=None)
def _setup():
    """(reference model, port model, reference quantized and packed trees,
    the port's) of the no-RoPE smoke stack."""
    kw = dict(vocab_size=fam.VOCAB, vocab_round=64, use_rope=False)
    jm = JModel(dataclasses.replace(j_smoke(ARCH), **kw))
    tm = TModel(dataclasses.replace(t_smoke(ARCH), **kw))
    plain = fam._perturb(jm.init(jax.random.PRNGKey(0)),
                         np.random.default_rng(1))
    quant = fam._quantize(plain)
    packed, _ = j_pack(quant)
    return (jm, tm, (quant, from_reference(quant, "cpu")),
            (packed, from_reference(packed, "cpu")))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_paged_paths_match_reference_without_rope(bits):
    """A packed prefill wave of two segments (11 and 7 tokens, pads
    behind), a paged decode step of both rows, then a decode horizon of 8
    (rows stopping after 4 and 3 tokens, two pad rows), each against the
    reference's dispatch at the same kv_bits."""
    from repro.serve import continuous as jc
    jm, tm, _, (jp, tp) = _setup()
    assert not tm.cfg.use_rope and tm.supports_paged()

    def quant(slots):
        return {} if bits == 16 else dict(slots=torch.from_numpy(slots))

    rng = np.random.default_rng(20 + bits)
    t = 24
    tokens, seg, pos = (np.zeros(t, np.int32), np.full(t, -1, np.int32),
                        np.full(t, -1, np.int32))
    tokens[:18] = rng.integers(0, fam.VOCAB, 18)
    seg[:11], seg[11:18] = 0, 1
    pos[:11], pos[11:18] = np.arange(11), np.arange(7)
    bt = np.zeros((4, WIDTH), np.int32)
    bt[0, :5], bt[1, :5] = np.arange(1, 6), np.arange(6, 11)
    slots = _i32([0, 2, -1, -1])
    wave = (tokens, seg, pos, _i32([11, 7, 0, 0]), bt, slots,
            _i32([10, 17, 0, 0]), _i32([0, 11, 0, 0]))
    jl, jpools = jc._paged_prefill_packed(
        jm, bits, jm.init_paged_pools(64, fam.PS, kv_bits=bits, max_seqs=4),
        jp, *[jnp.asarray(a) for a in wave])
    tl, tpools = tm.paged_prefill_packed(
        tp, tm.init_paged_pools(64, fam.PS, kv_bits=bits, max_seqs=4,
                                device="cpu"),
        *[torch.from_numpy(a) for a in wave], kv_bits=bits)
    _close(tl[:2], np.asarray(jl)[:2])
    step = (_i32(np.asarray(jl)[:2].argmax(-1))[:, None], _i32([[11], [7]]),
            _i32([12, 8]), bt[:2])
    jl, jpools = jc._paged_step(jm, bits, jpools, jp,
                                *[jnp.asarray(a) for a in step],
                                jnp.asarray(slots[:2]))
    tl, tpools = tm.paged_step(tp, tpools,
                               *[torch.from_numpy(a) for a in step],
                               kv_bits=bits, **quant(slots[:2]))
    _close(tl, jl)
    nxt = np.zeros(4, np.int32)
    nxt[:2] = np.asarray(jl).argmax(-1)
    start, n_left, eos = _i32([12, 8, -1, -1]), _i32([4, 3, 0, 0]), \
        _i32([-1] * 4)
    jt, jv, _ = jc._paged_horizon_step(jm, 8, bits, jpools, jp, *[
        jnp.asarray(a) for a in (nxt, start, n_left, eos, bt, slots)])
    tt, tv, _ = tm.paged_decode_horizon(
        tp, tpools, *[torch.from_numpy(a)
                      for a in (nxt, start, bt, n_left, eos)], 8,
        kv_bits=bits, **quant(slots))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_continuous_engine_tokens_match_reference_without_rope(bits):
    """``fam.requests`` (the first alone, so the second hits the prefix
    cache) through both packages' engines at the same kv_bits: greedy
    tokens identical, the same prefix hits."""
    from repro.serve import ContinuousEngine as JEngine
    jm, tm, (jq, tq), _ = _setup()

    def serve(eng):
        reqs = fam.requests()
        out = {}
        eng.submit(*reqs[0])
        out.update(eng.run())
        for r in reqs[1:]:
            eng.submit(*r)
        out.update(eng.run())
        return out, eng.n_prefix_hits

    want, j_hits = serve(JEngine(jm, jq, execution="packed", kv_bits=bits,
                                 **ENGINE))
    eng = ContinuousEngine(tm, tq, kv_bits=bits, device="cpu", **ENGINE)
    got, hits = serve(eng)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert hits == j_hits >= 1
    eng.close()


def test_sinusoid_follows_each_rows_position():
    """The same token at the same position gives the same logits whatever
    the other rows hold, and a different position gives others: the
    position signal comes from each row's own ``q_pos``."""
    _, tm, _, (_, tp) = _setup()
    pools = tm.init_paged_pools(16, fam.PS, device="cpu")
    bt = torch.tensor([[1, 2], [3, 4], [5, 6]], dtype=torch.int32)
    tok = torch.full((3, 1), 7, dtype=torch.int32)
    q_pos = torch.tensor([[0], [0], [5]], dtype=torch.int32)
    logits, _ = tm.paged_step(tp, pools, tok, q_pos,
                              torch.tensor([1, 1, 6], dtype=torch.int32), bt)
    assert torch.equal(logits[0], logits[1])
    assert not torch.allclose(logits[0], logits[2])
