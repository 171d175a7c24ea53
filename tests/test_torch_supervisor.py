"""Supervision tests of the PyTorch port (src/repro_torch/serve/
supervisor.py), re-pointed from tests/test_supervisor.py at the port's
engine on the CPU.

Supervision layer tests: deterministic fault injection, crash recovery
with token-identical replay, watchdog hang containment, poison quarantine,
the abort-during-recovery race, drain, and metrics monotonicity across
engine rebuilds (DESIGN.md Sec. 14).

The acceptance bar: a mid-stream injected engine crash recovers with
output token-identical to the fault-free run, across execution modes and
decode horizons, with zero leaked pages.
"""
import dataclasses
import time

import jax
import numpy as np
import torch
import pytest

from repro.configs import smoke_config as j_smoke
from repro.core import QuantPolicy
from repro.core import quantize_params as j_quantize_params
from repro.models import Model as JModel
from repro.serve import ContinuousEngine as JEngine
from repro_torch.configs import smoke_config
from repro_torch.convert import from_reference
from repro_torch.models import Model
from repro_torch.serve import (ContinuousEngine, Draining, EngineSupervisor,
                         FaultEvent, FaultPlan, EngineDied, InjectedFault,
                         InjectedOOM, NO_FAULTS, PoisonedRequest,
                         ServeMetrics)
from repro_torch.serve.supervisor import Recovering, WatchdogTimeout

PROMPTS = [list(range(1, 9)), [3, 5, 7, 2], [10, 11, 12, 13, 14, 15]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, and beside other
    test workers and the server's own threads, spinning intra-op threads
    slow every process down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_setup():
    """The reference's smoke internlm2 (vocab 64), 4-bit quantized."""
    cfg = dataclasses.replace(j_smoke("internlm2-1.8b"), vocab_size=64,
                              vocab_round=64)
    jm = JModel(cfg)
    qparams, report = j_quantize_params(jm.init(jax.random.PRNGKey(0)),
                                        QuantPolicy(bits=4, block=64,
                                                    solver="dp",
                                                    min_size=1024))
    assert report
    return jm, qparams


@pytest.fixture(scope="module")
def qsetup(ref_setup):
    """The port's model over the reference's quantized params."""
    cfg = smoke_config("internlm2-1.8b")
    cfg = dataclasses.replace(cfg, vocab_size=64, vocab_round=64)
    return Model(cfg), from_reference(ref_setup[1], "cpu")


def _factory(model, params, faults=None, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("page_size", 4)
    kw.setdefault("num_pages", 64)
    kw.setdefault("prefill_chunk", 8)
    return lambda: ContinuousEngine(model, params, device="cpu", faults=faults, **kw)


def _reference(model, params, prompts, max_new=10, **kw):
    """Fault-free greedy outputs, one list per prompt."""
    eng = _factory(model, params, **kw)()
    rids = [eng.submit(np.asarray(p), max_new) for p in prompts]
    out = eng.run()
    eng.close()
    return [out[r].tolist() for r in rids]


def _jax_reference(ref_setup, prompts, max_new=10, execution="packed",
                   **kw):
    """The reference ContinuousEngine's greedy outputs under ``_factory``'s
    config, one list per prompt."""
    jm, jp = ref_setup
    kw = dict(dict(max_batch=4, page_size=4, num_pages=64, prefill_chunk=8),
              **kw)
    eng = JEngine(jm, jp, execution=execution, **kw)
    rids = [eng.submit(np.asarray(p, np.int32), max_new) for p in prompts]
    out = eng.run()
    return [out[r].tolist() for r in rids]


# -- FaultPlan -------------------------------------------------------------
def test_fault_plan_fires_at_scheduled_indices():
    plan = FaultPlan([FaultEvent("step", 2, "crash"),
                      FaultEvent("alloc", 0, "oom")])
    plan.fire("step")
    plan.fire("step")
    with pytest.raises(InjectedFault):
        plan.fire("step")
    with pytest.raises(InjectedOOM):
        plan.fire("alloc")
    assert plan.exhausted
    assert plan.fired == [("step", 2, "crash"), ("alloc", 0, "oom")]
    plan.fire("step")                          # past the schedule: no-op


def test_fault_plan_stall_sleeps_not_raises():
    plan = FaultPlan([FaultEvent("step", 0, "stall", stall_s=0.05)])
    t0 = time.monotonic()
    plan.fire("step")                          # returns, late
    assert time.monotonic() - t0 >= 0.04
    assert plan.fired == [("step", 0, "stall")]


def test_fault_plan_seeded_deterministic():
    a = FaultPlan.seeded(1234, n_faults=20)
    b = FaultPlan.seeded(1234, n_faults=20)
    assert a._events.keys() == b._events.keys()
    for site in a._events:
        assert {at: (e.kind, e.stall_s) for at, e in a._events[site].items()} \
            == {at: (e.kind, e.stall_s) for at, e in b._events[site].items()}
    c = FaultPlan.seeded(5678, n_faults=20)
    assert any(a._events.get(s, {}).keys() != c._events.get(s, {}).keys()
               for s in ("step", "apply", "alloc"))
    assert a.n_events == 20
    # alloc events are always oom; oom never lands elsewhere
    for site, evs in a._events.items():
        for e in evs.values():
            assert (e.kind == "oom") == (site == "alloc")


def test_fault_plan_validation():
    with pytest.raises(ValueError):
        FaultEvent("nonsense", 0)
    with pytest.raises(ValueError):
        FaultEvent("step", 0, "explode")
    with pytest.raises(ValueError):
        FaultEvent("step", -1)
    with pytest.raises(ValueError):            # duplicate (site, at)
        FaultPlan([FaultEvent("step", 3), FaultEvent("step", 3)])
    assert NO_FAULTS.armed is False
    NO_FAULTS.fire("step")                     # no-op, no counters


# -- the acceptance criterion ---------------------------------------------
@pytest.mark.parametrize("execution", ["simulated", "packed"])
@pytest.mark.parametrize("horizon", [1, 8])
def test_crash_recovery_token_identical(qsetup, ref_setup, execution,
                                        horizon):
    """Mid-stream engine crash -> rebuild + replay -> byte-identical greedy
    output, across execution modes and decode horizons; zero leaked pages
    at teardown. The fault-free output is the reference engine's."""
    model, params = qsetup
    kw = dict(execution=execution, decode_horizon=horizon)
    ref = _reference(model, params, PROMPTS, **kw)
    assert ref == _jax_reference(ref_setup, PROMPTS, **kw)
    # crash twice: once on the first decode dispatch, once early in the
    # rebuilt incarnation (packed prefill makes the whole horizon=8 run
    # ~3 dispatches, so the triggers sit low enough to fire in every
    # parametrization)
    plan = FaultPlan([FaultEvent("apply", 1, "crash"),
                      FaultEvent("step", 3, "crash")])
    sup = EngineSupervisor(_factory(model, params, faults=plan, **kw),
                           watchdog=False)
    rids = [sup.submit(np.asarray(p), 10) for p in PROMPTS]
    out = sup.run()
    assert plan.exhausted, "both faults must actually fire"
    assert sup.n_restarts == 2
    assert sup.n_replayed_tokens > 0
    for rid, expect in zip(rids, ref):
        assert out[rid].tolist() == expect
    sup.engine.cache.check_invariants(expect_idle=True)
    sup.close()


def test_recovery_replay_resumes_mid_stream(qsetup):
    """The replay set is prompt + tokens-so-far: tokens generated before
    the crash are never re-delivered, and the continuation matches."""
    model, params = qsetup
    ref = _reference(model, params, PROMPTS)
    plan = FaultPlan([FaultEvent("apply", 6, "crash")])
    sup = EngineSupervisor(_factory(model, params, faults=plan),
                           watchdog=False)
    rids = [sup.submit(np.asarray(p), 10) for p in PROMPTS]
    streamed = {r: [] for r in rids}
    while sup.has_work:
        if not sup.step():
            break
        for r, (new, done) in sup.stream_updates().items():
            streamed[r].extend(new)
    assert sup.n_restarts == 1
    for rid, expect in zip(rids, ref):
        assert streamed[rid] == expect         # exactly once, in order
    sup.close()


def test_injected_oom_degrades_without_restart(qsetup):
    """InjectedOOM is an OutOfPages: the scheduler preempts and retries —
    the supervisor must see no crash at all."""
    model, params = qsetup
    ref = _reference(model, params, PROMPTS)
    plan = FaultPlan([FaultEvent("alloc", 3, "oom"),
                      FaultEvent("alloc", 6, "oom")])
    sup = EngineSupervisor(_factory(model, params, faults=plan),
                           watchdog=False)
    rids = [sup.submit(np.asarray(p), 10) for p in PROMPTS]
    out = sup.run()
    assert plan.exhausted
    assert sup.n_restarts == 0                 # graceful degradation
    assert sup.engine.scheduler.n_preemptions > 0
    for rid, expect in zip(rids, ref):
        assert out[rid].tolist() == expect
    sup.engine.cache.check_invariants(expect_idle=True)
    sup.close()


def test_watchdog_trips_on_stall_and_recovers(qsetup, ref_setup):
    """A hung step (injected stall) blows the rolling-median deadline; the
    worker is abandoned and recovery proceeds exactly as for a crash: the
    replayed output is the reference engine's fault-free output."""
    model, params = qsetup
    ref = _jax_reference(ref_setup, PROMPTS)
    plan = FaultPlan([FaultEvent("step", 5, "stall", stall_s=3.0)])
    sup = EngineSupervisor(
        _factory(model, params, faults=plan),
        watchdog=True, watchdog_floor_s=0.3, warmup_steps=2,
        warmup_deadline_s=120.0)
    rids = [sup.submit(np.asarray(p), 10) for p in PROMPTS]
    out = sup.run()
    assert sup.n_watchdog_trips == 1
    assert sup.n_restarts == 1
    assert isinstance(sup.last_crash, WatchdogTimeout)
    for rid, expect in zip(rids, ref):
        assert out[rid].tolist() == expect
    sup.close(check=False)    # abandoned worker may still hold the old pool


def test_poison_request_quarantined_cohort_survives(qsetup):
    """A request blamed for max_crashes_per_request crashes fails with
    PoisonedRequest naming the cause; the other requests complete with
    token-identical output."""
    model, params = qsetup
    # the first dispatch of every incarnation crashes (apply 0, 1, 2).
    # Incarnation 1's first dispatch is the packed A+B prefill — blame is
    # imprecise, so crash isolation kicks in and incarnations 2 and 3
    # prefill one segment per wave: their first dispatch is A's alone.
    # A collects 3 blames (quarantined); B collects 1 and survives.
    plan = FaultPlan([FaultEvent("apply", 0, "crash"),
                      FaultEvent("apply", 1, "crash"),
                      FaultEvent("apply", 2, "crash")])
    ref = _reference(model, params, [PROMPTS[1]])
    sup = EngineSupervisor(_factory(model, params, faults=plan),
                           watchdog=False, max_crashes_per_request=3)
    rid_a = sup.submit(np.asarray(PROMPTS[0]), 10)
    rid_b = sup.submit(np.asarray(PROMPTS[1]), 10)
    out = sup.run()
    fails = sup.pop_failures()
    assert set(fails) == {rid_a}
    assert isinstance(fails[rid_a], PoisonedRequest)
    assert "3 engine crashes" in str(fails[rid_a])
    assert "InjectedFault" in str(fails[rid_a])    # names the cause
    assert sup.n_quarantined == 1
    assert out[rid_b].tolist() == ref[0]           # the cohort survives
    sup.engine.cache.check_invariants(expect_idle=True)
    sup.close()


def test_abort_during_recovery_not_resurrected(qsetup):
    """Negative test: an abort_request landing between a crash
    (phase A: rebuild) and the next step (phase B: replay) must drop the
    request from the replay set — never resurrect it."""
    model, params = qsetup
    ref = _reference(model, params, PROMPTS)
    plan = FaultPlan([FaultEvent("apply", 5, "crash")])
    sup = EngineSupervisor(_factory(model, params, faults=plan),
                           watchdog=False)
    rids = [sup.submit(np.asarray(p), 10) for p in PROMPTS]
    while sup.n_restarts == 0:
        assert sup.step(), "fault must fire before work runs out"
    assert sup._pending_replay, "crash must leave a replay set"
    victim = rids[1]
    assert sup.abort_request(victim) is True   # the race window
    out = sup.run()
    assert victim not in out
    assert victim not in sup.pop_failures()
    # the rebuilt engine never admitted the aborted request
    assert sup.engine.scheduler.n_admissions == len(rids) - 1
    assert sup.stats()["aborts"] == 1
    for rid, expect in zip(rids, ref):
        if rid != victim:
            assert out[rid].tolist() == expect
    sup.engine.cache.check_invariants(expect_idle=True)
    sup.close()


def test_drain_stops_admissions_finishes_inflight(qsetup):
    model, params = qsetup
    ref = _reference(model, params, PROMPTS)
    sup = EngineSupervisor(_factory(model, params), watchdog=False)
    rids = [sup.submit(np.asarray(p), 10) for p in PROMPTS]
    sup.drain()
    assert sup.health == "draining"
    assert isinstance(sup.would_accept(4, 4), Draining)
    with pytest.raises(Draining):
        sup.submit(np.asarray([1, 2, 3]), 4)
    out = sup.run()                            # in-flight work finishes
    for rid, expect in zip(rids, ref):
        assert out[rid].tolist() == expect
    assert sup.drained
    sup.close()                                # invariant check included


def test_restart_budget_exhausted_dies_typed(qsetup):
    """Beyond max_restarts every in-flight request fails with EngineDied
    (not a hang), and the supervisor refuses new work."""
    model, params = qsetup
    plan = FaultPlan([FaultEvent("step", i, "crash") for i in range(6)])
    sup = EngineSupervisor(_factory(model, params, faults=plan),
                           watchdog=False, max_restarts=2)
    rid = sup.submit(np.asarray(PROMPTS[0]), 10)
    out = sup.run()
    assert rid not in out
    assert sup.health == "dead"
    assert sup.step() is False
    fails = sup.pop_failures()
    assert isinstance(fails[rid], EngineDied)
    assert isinstance(sup.would_accept(4, 4), EngineDied)
    with pytest.raises(EngineDied):
        sup.submit(np.asarray([1, 2]), 4)
    sup.close(check=False)


def test_recovering_window_rejects_submissions(qsetup):
    model, params = qsetup
    plan = FaultPlan([FaultEvent("apply", 5, "crash")])
    sup = EngineSupervisor(_factory(model, params, faults=plan),
                           watchdog=False)
    for p in PROMPTS:
        sup.submit(np.asarray(p), 10)
    while sup.n_restarts == 0:
        sup.step()
    # phase-B window: replay still pending
    assert isinstance(sup.would_accept(4, 4), Recovering)
    with pytest.raises(Recovering):
        sup.submit(np.asarray([1, 2]), 4)
    sup.run()
    assert sup.would_accept(4, 4) is None      # back to accepting
    sup.close()


def test_metrics_monotonic_across_rebuilds(qsetup):
    """A rebuilt engine's counters restart at zero; the supervisor's
    aggregated stats() must never regress (Counter.set_to raises)."""
    model, params = qsetup
    plan = FaultPlan([FaultEvent("apply", 4, "crash"),
                      FaultEvent("step", 8, "crash")])
    sup = EngineSupervisor(_factory(model, params, faults=plan),
                           watchdog=False)
    metrics = ServeMetrics()
    for p in PROMPTS:
        sup.submit(np.asarray(p), 10)
    prev_tokens = -1.0
    while sup.has_work:
        if not sup.step():
            break
        metrics.sync_engine(sup)               # raises on any regression
        assert metrics.tokens.value() >= prev_tokens
        prev_tokens = metrics.tokens.value()
    assert sup.n_restarts == 2
    assert metrics.restarts.value() == 2
    assert metrics.replayed_tokens.value() == sup.n_replayed_tokens
    assert metrics.recovery.count() == 2
    text = metrics.render()
    assert "msb_engine_restarts_total 2" in text
    sup.close()


def test_crash_on_final_step_still_finishes_identical(qsetup):
    """A crash landing on the very step that would deliver the request's
    final token loses that step's work; replay regenerates it and the
    request still finishes token-identical."""
    model, params = qsetup
    ref = _reference(model, params, [PROMPTS[0]], max_new=3)
    probe = _factory(model, params)()
    probe.submit(np.asarray(PROMPTS[0]), 3)
    n_steps = 0
    while probe.scheduler.has_work:
        probe.step()
        n_steps += 1
    probe.close()
    plan = FaultPlan([FaultEvent("step", n_steps - 1, "crash")])
    sup = EngineSupervisor(_factory(model, params, faults=plan),
                           watchdog=False)
    rid = sup.submit(np.asarray(PROMPTS[0]), 3)
    out = sup.run()
    assert plan.exhausted
    assert sup.n_restarts == 1
    assert out[rid].tolist() == ref[0]
    sup.engine.cache.check_invariants(expect_idle=True)
    sup.close()
