"""The port's ContinuousEngine against the JAX engine (execution="packed")
on the README quickstart: identical greedy tokens across decode horizons,
prefill packing, prefix caching and forced preemption, with a clean page
audit after every run."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as j_smoke
from repro.core import QuantPolicy, quantize_params
from repro.models import Model as JModel
from repro.serve import ContinuousEngine as JEngine
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.models import Model as TModel
from repro_torch.serve import ContinuousEngine as TEngine

QUICKSTART = ([1, 2, 3, 4], [5, 6, 7, 8, 9])
ENGINE = dict(max_batch=4, page_size=4, num_pages=64, max_seq=32)
PREEMPT = dict(max_batch=4, page_size=2, num_pages=11, prefill_chunk=4)


def _cfg(smoke):
    return dataclasses.replace(smoke("internlm2-1.8b"), vocab_size=64,
                               vocab_round=64)


def _prompts():
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 64, 8)
    return {
        "quickstart": [(np.asarray(p, np.int32), 8) for p in QUICKSTART],
        "preempt": [(rng.integers(0, 64, 4).astype(np.int32), 8)
                    for _ in range(2)],
        # sequential requests behind one page-aligned 8-token prefix
        "prefix": [(np.concatenate([shared, rng.integers(0, 64, n)]).astype(
            np.int32), 6) for n in (3, 5, 2)],
    }


def _serve(engine, reqs, sequential=False):
    out = {}
    if sequential:                   # each completes before the next arrives
        for p, n in reqs:
            engine.submit(p, n)
            out.update(engine.run())
    else:
        for p, n in reqs:
            engine.submit(p, n)
        out = engine.run()
    return out


@pytest.fixture(scope="module")
def setup():
    jm = JModel(_cfg(j_smoke))
    params = jm.init(jax.random.PRNGKey(0))
    qparams, _ = quantize_params(params, QuantPolicy(bits=4, block=64,
                                                     solver="dp",
                                                     min_size=1024))
    prompts = _prompts()
    ref = {
        "quickstart": _serve(JEngine(jm, qparams, execution="packed",
                                     **ENGINE), prompts["quickstart"]),
        "preempt": _serve(JEngine(jm, qparams, execution="packed",
                                  **PREEMPT), prompts["preempt"]),
    }
    jeng = JEngine(jm, qparams, execution="packed", **ENGINE)
    ref["prefix"] = _serve(jeng, prompts["prefix"], sequential=True)
    ref["prefix_hits"] = jeng.n_prefix_hits
    return TModel(_cfg(t_smoke)), from_reference(qparams, "cpu"), prompts, ref


def _assert_same(out, ref):
    assert sorted(out) == sorted(ref)
    for rid in ref:
        np.testing.assert_array_equal(out[rid], ref[rid])


@pytest.mark.parametrize("horizon", [1, 8])
@pytest.mark.parametrize("packing", [True, False])
@pytest.mark.parametrize("prefix_cache", [True, False])
def test_quickstart_tokens_match_reference(setup, horizon, packing,
                                           prefix_cache):
    model, params, prompts, ref = setup
    eng = TEngine(model, params, decode_horizon=horizon,
                  prefill_packing=packing, prefix_cache=prefix_cache,
                  device="cpu", **ENGINE)
    _assert_same(_serve(eng, prompts["quickstart"]), ref["quickstart"])
    eng.close()
    eng.cache.check_invariants(expect_idle=True)


@pytest.mark.parametrize("horizon", [1, 8])
def test_forced_preemption_matches_reference(setup, horizon):
    model, params, prompts, ref = setup
    eng = TEngine(model, params, decode_horizon=horizon, device="cpu",
                  **PREEMPT)
    _assert_same(_serve(eng, prompts["preempt"]), ref["preempt"])
    assert eng.scheduler.n_preemptions > 0, "pool sized to force preemption"
    eng.close()
    c = eng.cache
    c.check_invariants(expect_idle=True)
    assert c.n_free_pages + c.n_cached_pages == c.num_pages - 1


def test_prefix_hits_match_reference(setup):
    model, params, prompts, ref = setup
    eng = TEngine(model, params, device="cpu", **ENGINE)
    _assert_same(_serve(eng, prompts["prefix"], sequential=True),
                 ref["prefix"])
    assert eng.n_prefix_hits == ref["prefix_hits"] == 2
    assert eng.n_prefix_positions_saved == 2 * 8
    eng.close()
    eng.cache.check_invariants(expect_idle=True)


def test_fork_abort_and_stream(setup):
    """fork_request children replay the parent's greedy continuation,
    abort_request frees its request, stream_updates reports every token
    once and in order."""
    model, params, prompts, ref = setup
    eng = TEngine(model, params, device="cpu", **ENGINE)
    (p0, n0), (p1, n1) = prompts["quickstart"]
    r0, r1 = eng.submit(p0, n0), eng.submit(p1, n1)
    streamed = {}

    def drain():
        for rid, (toks, _fin) in eng.stream_updates().items():
            streamed.setdefault(rid, []).extend(toks)

    while eng._seqs[r0].state != "decode":
        eng.step()
        drain()
    kids = eng.fork_request(r0, 2, max_new_tokens=n0 - 1)
    assert eng.abort_request(r1)
    while eng.has_work:
        eng.step()
        drain()
    parent = ref["quickstart"][0]
    np.testing.assert_array_equal(streamed[r0], parent)
    for k in kids:
        np.testing.assert_array_equal(streamed[k], parent[1:])
    assert eng.n_forks == 2 and eng.n_aborts == 1
    eng.close()
    eng.cache.check_invariants(expect_idle=True)
