"""The port's ContinuousEngine over MSB-quantized KV pools (kv_bits 8|4)
against the JAX engine at the same kv_bits, on smoke internlm2 with fp32
params: the model's paged step from one converted pool state, greedy
tokens over decode horizons 1 and 8 with the prefix cache on, forced
preemption and fork_request, and the allocator's quantization-frontier
audit (a port of tests/test_kv_quant.py's). Never compared with kv16: the
reference's own kv8 tokens differ from its kv16 ones."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import QuantPolicy
from repro.core import quantize_params as j_quantize_params
from repro.models import Model as JModel
from repro.serve import ContinuousEngine as JEngine
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.models import Model as TModel
from repro_torch.serve import ContinuousEngine as TEngine
from repro_torch.serve import PageStateError

PS = 4
ENGINE = dict(max_batch=4, page_size=4, num_pages=64, max_seq=40,
              prefill_chunk=6)
PREEMPT = dict(max_batch=4, page_size=2, num_pages=11, prefill_chunk=4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# model and pools
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(j_smoke("internlm2-1.8b"), vocab_size=64,
                              vocab_round=64)
    jm = JModel(cfg)
    params = jm.init(jax.random.PRNGKey(0))
    qparams, _ = j_quantize_params(params, QuantPolicy(
        bits=4, block=64, solver="dp", min_size=1024))
    tcfg = dataclasses.replace(t_smoke("internlm2-1.8b"), vocab_size=64,
                               vocab_round=64)
    return jm, qparams, TModel(tcfg), from_reference(qparams, "cpu")


@pytest.mark.parametrize("bits", [8, 4])
def test_pools_convert_with_dtypes_and_paged_step_matches(setup, bits):
    """A reference quantized pool tree converts to the port's layout with
    its dtypes kept; from that same state, a prefill step then a decode
    step give the reference's logits (1e-4) and pools: codes byte-equal,
    scales and hot rows within 1e-5 (the K/V they come from are
    projections summed in another order than XLA's)."""
    jm, jp, tm, tp = setup
    jpools = jm.init_paged_pools(12, PS, kv_bits=bits, max_seqs=3)
    tpools = from_reference(jpools, "cpu")
    own = tm.init_paged_pools(12, PS, kv_bits=bits, max_seqs=3, device="cpu")
    for name, leaf in own["layers"]["s0"]["attn"].items():
        got = tpools["layers"]["s0"]["attn"][name]
        assert (got.dtype, got.shape) == (leaf.dtype, leaf.shape), name
    rng = np.random.default_rng(50 + bits)
    bt = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    slots = np.asarray([0, 2], np.int32)
    steps = [(rng.integers(0, 64, (2, 6)), [[0, 1, 2, 3, 4, 5],
                                            [0, 1, 2, 3, 4, -1]], [6, 5]),
             (rng.integers(0, 64, (2, 1)), [[6], [5]], [7, 6])]
    for toks, q_pos, lens in steps:
        args = [np.asarray(a, np.int32) for a in (toks, q_pos, lens, bt)]
        jl, jpools = jm.paged_step(jp, jpools,
                                   *(jnp.asarray(a) for a in args),
                                   kv_bits=bits, slots=jnp.asarray(slots))
        tl, tpools = tm.paged_step(tp, tpools, *(_t(a) for a in args),
                                   kv_bits=bits, slots=_t(slots))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-4)
    jl_, tl_ = jpools["layers"]["s0"]["attn"], tpools["layers"]["s0"]["attn"]
    for name in jl_:
        a, b = np.asarray(jl_[name]), tl_[name]
        b = b.float().numpy() if b.dtype == torch.bfloat16 else b.numpy()
        a = a.astype(np.float32) if a.dtype == jnp.bfloat16 else a
        if name.endswith("_codes"):
            assert (a[:, 1:] != 0).any(), f"{name}: nothing committed"
            np.testing.assert_array_equal(b[:, 1:], a[:, 1:], err_msg=name)
        else:
            np.testing.assert_allclose(b[:, 1:], a[:, 1:], rtol=0,
                                       atol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# engine: greedy tokens against the reference engine at equal kv_bits
# ---------------------------------------------------------------------------

def _requests():
    rng = np.random.default_rng(5)
    shared = rng.integers(0, 64, 8)
    reqs = [(np.concatenate([shared, rng.integers(0, 64, n)]).astype(
        np.int32), 8) for n in (3, 5)]
    reqs += [(rng.integers(0, 64, int(rng.integers(3, 14))).astype(np.int32),
              int(rng.integers(2, 10))) for _ in range(3)]
    return reqs


def _busy_requests():
    """Three 13-token sequences: more than PREEMPT's 10 usable 2-token
    pages hold at once, and still live a few steps after admission."""
    rng = np.random.default_rng(6)
    return [(rng.integers(0, 64, 5).astype(np.int32), 8) for _ in range(3)]


def _serve(eng, reqs):
    """The first request alone (its pages register), then the rest."""
    out = {}
    eng.submit(*reqs[0])
    out.update(eng.run())
    for r in reqs[1:]:
        eng.submit(*r)
    out.update(eng.run())
    return out


def _fork(eng, prompt):
    rid = eng.submit(prompt, 8)
    for _ in range(4):
        eng.step()
    kids = eng.fork_request(rid, n=2)
    out = eng.run()
    return [out[r] for r in [rid] + kids], eng.n_forks


@pytest.fixture(scope="module")
def reference(setup):
    """The reference engine's outputs, computed once per (bits, case)."""
    jm, jp, _, _ = setup
    memo = {}

    def get(bits, case, horizon=1):
        key = (bits, case, horizon)
        if key not in memo:
            if case == "serve":
                eng = JEngine(jm, jp, execution="packed", kv_bits=bits,
                              decode_horizon=horizon, **ENGINE)
                memo[key] = (_serve(eng, _requests()), eng.n_prefix_hits)
            elif case == "preempt":
                eng = JEngine(jm, jp, execution="packed", kv_bits=bits,
                              **PREEMPT)
                for p, n in _busy_requests():
                    eng.submit(p, n)
                memo[key] = eng.run()
            else:
                eng = JEngine(jm, jp, execution="packed", kv_bits=bits,
                              **ENGINE)
                memo[key] = _fork(eng, _requests()[0][0])[0]
        return memo[key]

    return get


def _assert_same(out, ref):
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid])


@pytest.mark.parametrize("horizon", [1, 8])
@pytest.mark.parametrize("bits", [8, 4])
def test_engine_tokens_match_reference(setup, reference, bits, horizon):
    """Prefix cache on (the second request adopts the first's pages),
    packed prefill, decode horizon 1 and 8; clean page audit after."""
    _, _, tm, tp = setup
    ref, ref_hits = reference(bits, "serve", horizon)
    eng = TEngine(tm, tp, kv_bits=bits, decode_horizon=horizon,
                  device="cpu", **ENGINE)
    _assert_same(_serve(eng, _requests()), ref)
    assert eng.n_prefix_hits == ref_hits >= 1
    eng.close()
    eng.cache.check_invariants(expect_idle=True)


@pytest.mark.parametrize("horizon", [1, 8])
@pytest.mark.parametrize("bits", [8, 4])
def test_engine_forced_preemption_matches_reference(setup, reference, bits,
                                                    horizon):
    _, _, tm, tp = setup
    eng = TEngine(tm, tp, kv_bits=bits, decode_horizon=horizon,
                  device="cpu", **PREEMPT)
    for p, n in _busy_requests():
        eng.submit(p, n)
    _assert_same(eng.run(), reference(bits, "preempt"))
    assert eng.scheduler.n_preemptions > 0, "pool sized to force preemption"
    eng.close()
    c = eng.cache
    c.check_invariants(expect_idle=True)
    assert c.n_free_pages + c.n_cached_pages == c.num_pages - 1


@pytest.mark.parametrize("bits", [8, 4])
def test_engine_fork_matches_reference(setup, reference, bits):
    """fork_request on quantized pools shares committed pages and copies
    the parent's hot row: parent and children give the reference's
    tokens."""
    _, _, tm, tp = setup
    eng = TEngine(tm, tp, kv_bits=bits, device="cpu", **ENGINE)
    outs, n_forks = _fork(eng, _requests()[0][0])
    assert n_forks == 2
    for got, want in zip(outs, reference(bits, "fork")):
        np.testing.assert_array_equal(got, want)
    eng.close()
    eng.cache.check_invariants(expect_idle=True)


def test_engine_refuses_other_kv_bits(setup):
    _, _, tm, tp = setup
    with pytest.raises(ValueError, match="16, 8 or 4"):
        TEngine(tm, tp, kv_bits=2, device="cpu", **ENGINE)


# ---------------------------------------------------------------------------
# the quantization-frontier audit (port of tests/test_kv_quant.py)
# ---------------------------------------------------------------------------

def _live_engine(setup, bits, n_steps=4):
    _, _, tm, tp = setup
    eng = TEngine(tm, tp, kv_bits=bits, prefix_cache=False, device="cpu",
                  **ENGINE)
    for p, n in _busy_requests():
        eng.submit(p, n)
    for _ in range(n_steps):
        eng.step()
    return eng


def test_frontier_tracks_commits(setup):
    cache = _live_engine(setup, 4).cache
    live = [s for s in range(cache.max_seqs) if s not in cache._free_slots]
    assert live
    for s in live:
        assert int(cache._quant_frontier[s]) == \
            int(cache.seq_lens[s]) // cache.page_size
    cache.check_invariants()


@pytest.mark.parametrize("delta", [-1, 1])
def test_frontier_corruption_detected(setup, delta):
    """A frontier behind the commit = a committed page left unquantized;
    ahead = pages marked quantized that were never committed."""
    cache = _live_engine(setup, 4).cache
    live = [s for s in range(cache.max_seqs)
            if s not in cache._free_slots
            and int(cache.seq_lens[s]) // cache.page_size + delta >= 0]
    assert live
    cache._quant_frontier[live[0]] += delta
    with pytest.raises(PageStateError, match="quant"):
        cache.check_invariants()


def test_free_slot_frontier_detected(setup):
    cache = _live_engine(setup, 4).cache
    assert cache._free_slots
    cache._quant_frontier[cache._free_slots[0]] = 1
    with pytest.raises(PageStateError, match="free slot"):
        cache.check_invariants()


def test_native_pools_skip_frontier_audit(setup):
    """kv16 pools carry no frontier semantics: the same corruption passes
    the audit."""
    cache = _live_engine(setup, 16).cache
    live = [s for s in range(cache.max_seqs) if s not in cache._free_slots]
    cache._quant_frontier[live[0]] += 1
    cache.check_invariants()
