"""Overload-control tests of the PyTorch port (src/repro_torch/serve/
overload.py), re-pointed from tests/test_overload.py at the port's engine
on the CPU, the tensor-parallel soak on a mesh of two CPU ranks.

Overload control plane (DESIGN.md Sec. 17): priority/deadline-aware
admission, the SLO-driven brownout ladder, and starvation-free shedding.

Acceptance bar: a mixed-priority cohort at ~2x pool capacity
completes with zero starvation and zero leaked pages; every completed
request is greedy-token-identical to an unloaded run of the same config
(across execution modes and kv precisions); brownout level changes
never trigger a post-warmup capture; transitions are
hysteresis-bounded even under injected controller faults ("stuck",
"flap"); a supervisor rebuild inherits the brownout level; and with the
controller on, interactive TTFT p99 under overload beats the
uncontrolled baseline.
"""
import dataclasses
import json
import time

import jax
import numpy as np
import torch
import pytest

from repro import serve as j_serve
from repro.configs import smoke_config as j_smoke
from repro.core import QuantPolicy
from repro.core import quantize_params as j_quantize_params
from repro.models import Model as JModel
from repro_torch import serve as t_serve
from repro_torch.configs import smoke_config
from repro_torch.convert import from_reference
from repro_torch.models import Model
from repro_torch.serve import (APIServer, BrownoutLevel, ContinuousEngine,
                         DEFAULT_LADDER, EngineSupervisor, FaultEvent,
                         FaultPlan, OverloadController, Request, Saturated,
                         Scheduler, ServeMetrics, ValidationError,
                         compute_retry_after, jit_trace_count,
                         parse_completion_request)
from repro_torch.serve.scheduler import _WaitingQueue, Sequence


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


# -- the unified Retry-After computation -----------------------------------

def test_retry_after_golden():
    """Pure function of (base, pressure, level, salt): golden values pin
    the exact header every shedding path emits."""
    assert [compute_retry_after(1.0, salt=s) for s in range(6)] == \
        [1, 2, 2, 2, 2, 2]
    assert [compute_retry_after(1.0, pressure=1.0, level=0, salt=s)
            for s in range(1, 4)] == [3, 3, 3]
    assert [compute_retry_after(1.0, pressure=1.0, level=4, salt=s)
            for s in range(1, 4)] == [12, 11, 13]
    assert [compute_retry_after(2.0, pressure=0.5, level=lv, salt=9)
            for lv in range(5)] == [4, 7, 11, 14, 18]


def test_retry_after_matches_reference():
    """The same header as the reference's on a grid of (base, pressure,
    level, salt), out-of-range pressures included."""
    for base in (0.1, 0.5, 1.0, 2.0, 5.0, 20.0):
        for pressure in (0.0, 0.3, 0.5, 1.0, -1.0, 99.0):
            for level in range(5):
                for salt in (0, 1, 7, 42):
                    kw = dict(pressure=pressure, level=level, salt=salt)
                    assert t_serve.compute_retry_after(base, **kw) == \
                        j_serve.compute_retry_after(base, **kw), (base, kw)


def test_retry_after_properties():
    # whole seconds >= 1, capped, deterministic per salt
    assert compute_retry_after(0.1, salt=7) == 1
    assert compute_retry_after(20.0, pressure=1.0, level=4, salt=1) == 30
    assert compute_retry_after(5.0, pressure=0.3, level=2, salt=42) == \
        compute_retry_after(5.0, pressure=0.3, level=2, salt=42)
    # monotone (within jitter-free comparison) in level and pressure
    for lv in range(4):
        assert compute_retry_after(1.0, level=lv, salt=0) <= \
            compute_retry_after(1.0, level=lv + 1, salt=0)
    assert compute_retry_after(1.0, pressure=0.0, salt=0) <= \
        compute_retry_after(1.0, pressure=1.0, salt=0)
    # out-of-range pressure is clipped, not propagated
    assert compute_retry_after(1.0, pressure=99.0, salt=0) == \
        compute_retry_after(1.0, pressure=1.0, salt=0)


# -- HTTP-layer validation --------------------------------------------------

def test_priority_deadline_validation():
    base = {"prompt": [1, 2, 3]}
    p = parse_completion_request(base, vocab_size=64)
    assert p.priority == "standard" and p.deadline_ms is None
    p = parse_completion_request(
        dict(base, priority="interactive", deadline_ms=1500),
        vocab_size=64)
    assert p.priority == "interactive" and p.deadline_ms == 1500.0
    for bad in ("urgent", 3, None):
        with pytest.raises(ValidationError) as ei:
            parse_completion_request(dict(base, priority=bad),
                                     vocab_size=64)
        assert ei.value.param == "priority"
    for bad in (0, -5, "soon", True):
        with pytest.raises(ValidationError) as ei:
            parse_completion_request(dict(base, deadline_ms=bad),
                                     vocab_size=64)
        assert ei.value.param == "deadline_ms"


# -- per-class admission queue ----------------------------------------------

def _seq(rid, priority="standard", deadline=None, submitted_at=0.0):
    return Sequence(Request(rid, np.asarray([1], np.int32), 4,
                            priority=priority, deadline=deadline,
                            submitted_at=submitted_at))


def test_waiting_queue_edf_within_class():
    q = _WaitingQueue()
    a = _seq(0, deadline=9.0)
    b = _seq(1, deadline=3.0)
    c = _seq(2)                       # deadline-free: after deadlined peers
    d = _seq(3)
    for s in (a, c, b, d):
        q.append(s)
    assert [q.popleft().req.req_id for _ in range(4)] == [1, 0, 2, 3]


def test_waiting_queue_class_order_and_aging():
    q = _WaitingQueue(promote_after=3)
    batch = _seq(0, "batch")
    q.append(batch)
    ids = [10, 11, 12]
    for i in ids:
        q.append(_seq(i, "interactive"))
    # interactive beats fresh batch...
    assert q.popleft().req.req_id == 10
    assert q.popleft().req.req_id == 11
    # ...ties on effective rank still favor the better class, so the
    # batch entry overtakes interactive only after aging one extra
    # promote_after window (rank deficit 2 -> 3 windows total): bounded
    # starvation, not instant priority inversion
    q.append(_seq(13, "interactive"))
    q.append(_seq(14, "interactive"))
    got = [q.popleft().req.req_id for _ in range(4)]
    assert got == [12, 13, 0, 14], f"batch request starved: {got}"


def test_waiting_queue_preemption_front_pin():
    q = _WaitingQueue()
    q.append(_seq(0, deadline=1.0))
    pre = _seq(1)                      # no deadline at all
    q.appendleft(pre)                  # preemption re-entry
    # a later EDF arrival must not leapfrog the head-of-line pin
    q.append(_seq(2, deadline=0.5))
    assert q[0] is pre
    assert q.popleft() is pre
    assert q.popleft().req.req_id == 2


def test_waiting_queue_facade():
    q = _WaitingQueue()
    assert not q and len(q) == 0
    s = _seq(0, "batch")
    q.append(s)
    q.append(_seq(1))
    assert q and len(q) == 2 and q.depth("batch") == 1
    assert {x.req.req_id for x in q} == {0, 1}
    q.remove(s)
    assert len(q) == 1
    with pytest.raises(IndexError):
        q[1]


# -- preemption victim selection ---------------------------------------------

def _bare_sched(running):
    sched = Scheduler.__new__(Scheduler)
    sched.running = running
    return sched


def test_pick_victim_lowest_class_youngest():
    running = [_seq(0, "interactive"), _seq(1, "batch"),
               _seq(2, "standard"), _seq(3, "batch")]
    v = Scheduler._pick_victim(_bare_sched(running), now=100.0)
    assert v.req.req_id == 3          # batch class, youngest


def test_pick_victim_deadline_protection():
    # the nearly-due standard sequence is protected; the batch one with
    # plenty of slack is not
    near = _seq(5, "interactive", deadline=10.0, submitted_at=0.0)
    slack = _seq(6, "interactive", deadline=100.0, submitted_at=0.0)
    v = Scheduler._pick_victim(_bare_sched([near, slack]), now=7.0)
    assert v is slack
    # all protected: the pool must still make progress -> fallback picks
    v = Scheduler._pick_victim(_bare_sched([near]), now=7.0)
    assert v is near
    assert Scheduler._past_point_of_no_return(near, 7.0)
    assert not Scheduler._past_point_of_no_return(near, 2.0)
    assert not Scheduler._past_point_of_no_return(_seq(7), 1e9)


# -- brownout shedding at the scheduler --------------------------------------

def test_shed_classes_and_unknown_priority(qsetup):
    model, params = qsetup
    eng = ContinuousEngine(model, params, device="cpu", max_batch=2, page_size=4,
                           num_pages=16, max_seq=16, prefill_chunk=4)
    assert isinstance(eng.would_accept(4, 4, priority="vip"), ValueError)
    eng.scheduler.shed_classes = frozenset({"batch"})
    assert isinstance(eng.would_accept(4, 4, priority="batch"), Saturated)
    assert eng.would_accept(4, 4, priority="interactive") is None
    with pytest.raises(Saturated):
        eng.submit(np.asarray([1, 2], np.int32), 2, priority="batch")
    assert eng.scheduler.n_sheds_by_class["batch"] == 1
    eng.scheduler.shed_classes = frozenset()
    eng.submit(np.asarray([1, 2], np.int32), 2, priority="batch")
    eng.run()
    assert eng.stats()["admissions_by_class"]["batch"] == 1
    eng.close(check=True)


# -- the controller, unit-level (fake engine) --------------------------------

class _FakeEngine:
    """Just enough surface for OverloadController: a pressure dial.
    ``scheduler_cls`` is the port's Scheduler unless the test passes the
    reference's."""

    def __init__(self, scheduler_cls=Scheduler):
        self.scheduler = scheduler_cls.__new__(scheduler_cls)
        self.scheduler.max_waiting = 8
        self.scheduler.max_batch = 4
        self.scheduler.decode_horizon = 8
        self.scheduler.horizon_cap = None
        self.scheduler.max_wave_segments = None
        self.scheduler.shed_classes = frozenset()
        self.scheduler.waiting = []
        self.cache = type("C", (), {})()
        self.cache.num_pages = 33
        self.cache.n_available_pages = 32
        self.cache.shrink_calls = []
        self.cache.shrink_lru = lambda floor: (
            self.cache.shrink_calls.append(floor), 0)[1]

    def set_pressure(self, p):
        self.cache.n_available_pages = round((1.0 - p) * 32)

    def stats(self):
        return {"preemptions": 0, "steps": 0}


def test_hysteresis_needs_consecutive_ticks_and_dwell():
    eng = _FakeEngine()
    ctrl = OverloadController(eng, interval_s=0.0, up=0.8, down=0.3,
                              up_ticks=2, down_ticks=3, min_dwell_ticks=4)
    eng.set_pressure(1.0)
    assert ctrl.tick() is None         # 1 hot tick: not yet
    assert ctrl.tick() == 1            # 2 consecutive: escalate
    # dwell: even sustained pressure cannot transition again for 4 ticks
    for _ in range(3):
        assert ctrl.tick() is None
    assert ctrl.tick() == 2
    # the dead band (0.3 < p < 0.8) resets both streaks
    eng.set_pressure(0.5)
    for _ in range(20):
        assert ctrl.tick() is None
    assert ctrl.level == 2
    # de-escalation needs down_ticks consecutive cool ticks + dwell
    eng.set_pressure(0.0)
    ticks = [ctrl.tick() for _ in range(3)]
    assert ticks[-1] == 1
    # a single hot tick mid-cooldown resets the cool streak
    eng.set_pressure(1.0)
    ctrl.tick()
    eng.set_pressure(0.0)
    assert [ctrl.tick() for _ in range(8)].count(0) == 1
    assert ctrl.level == 0
    assert ctrl.n_transitions == 4
    assert len(ctrl.transition_log) == 4


def test_transition_rate_bounded_under_adversarial_oscillation():
    """Pressure flipping between extremes every tick (the worst case the
    'flap' fault injects) transitions at most once per dwell window."""
    eng = _FakeEngine()
    ctrl = OverloadController(eng, interval_s=0.0, up=0.8, down=0.3,
                              up_ticks=1, down_ticks=1, min_dwell_ticks=5)
    n_ticks = 200
    for i in range(n_ticks):
        eng.set_pressure(1.0 if i % 2 == 0 else 0.0)
        ctrl.tick()
    assert ctrl.n_transitions <= n_ticks // ctrl.min_dwell_ticks + 1


def test_controller_fault_stuck_and_flap_and_crash():
    eng = _FakeEngine()
    plan = FaultPlan([FaultEvent("controller", 0, "stuck"),
                      FaultEvent("controller", 29, "crash")])
    ctrl = OverloadController(eng, interval_s=0.0, up_ticks=1,
                              down_ticks=1, min_dwell_ticks=2, faults=plan)
    for _ in range(29):
        ctrl.tick()
    assert ctrl.level == len(DEFAULT_LADDER) - 1    # pinned at max
    errors_before = ctrl.n_tick_errors
    level_before = ctrl.level
    ctrl.tick()                                     # the injected crash
    assert ctrl.n_tick_errors == errors_before + 1
    assert ctrl.level == level_before               # fail-safe: level held
    assert plan.exhausted

    # flap injection: forced oscillation, hysteresis still bounds the rate
    eng2 = _FakeEngine()
    plan2 = FaultPlan([FaultEvent("controller", 0, "flap")])
    ctrl2 = OverloadController(eng2, interval_s=0.0, up_ticks=1,
                               down_ticks=1, min_dwell_ticks=6,
                               faults=plan2)
    for _ in range(120):
        ctrl2.tick()
    assert ctrl2.n_transitions <= 120 // 6 + 1
    assert plan2.exhausted


def _ladder_trace(mod, pressures, faults, **kw):
    """Per tick of ``mod``'s OverloadController over a fake engine: what
    ``tick`` returned, the level, and the knobs it left on the scheduler
    and cache; then the transition log and the tick-error count."""
    eng = _FakeEngine(mod.Scheduler)
    plan = mod.FaultPlan([mod.FaultEvent("controller", i, kind)
                          for i, kind in faults])
    ctrl = mod.OverloadController(eng, interval_s=0.0, faults=plan, **kw)
    trace = []
    for p in pressures:
        eng.set_pressure(p)
        sched = eng.scheduler
        trace.append((ctrl.tick(), ctrl.level, sched.horizon_cap,
                      sched.max_wave_segments, sorted(sched.shed_classes),
                      list(eng.cache.shrink_calls)))
    return trace, ctrl.transition_log, ctrl.n_tick_errors


@pytest.mark.parametrize("faults", [(), ((0, "stuck"), (40, "crash")),
                                    ((10, "flap"),)])
@pytest.mark.parametrize("knobs", [
    dict(up=0.8, down=0.3, up_ticks=2, down_ticks=3, min_dwell_ticks=4),
    dict(up=0.6, down=0.2, up_ticks=1, down_ticks=1, min_dwell_ticks=2,
         ladder="soak")])
def test_controller_transitions_match_reference(faults, knobs):
    """The same pressure sequence (seeded, with runs of hot and cool ticks)
    and the same controller faults move the reference's ladder and the
    port's through the same levels on the same ticks, with the same knobs
    applied."""
    rng = np.random.default_rng(17)
    pressures = np.repeat(rng.uniform(0.0, 1.0, 40),
                          rng.integers(1, 6, 40))[:120]
    traces = []
    for mod in (t_serve, j_serve):
        kw = dict(knobs)
        if kw.get("ladder") == "soak":
            kw["ladder"] = tuple(mod.BrownoutLevel(**dataclasses.asdict(lv))
                                 for lv in SOAK_LADDER)
        traces.append(_ladder_trace(mod, pressures, faults, **kw))
    assert traces[0] == traces[1]
    assert traces[0][1], "no transition: the sequence tests nothing"


def test_controller_fault_event_validation():
    with pytest.raises(ValueError):
        FaultEvent("step", 0, "stuck")          # controller-site only
    with pytest.raises(ValueError):
        FaultEvent("controller", 0, "oom")      # not a controller kind
    FaultEvent("controller", 0, "crash")        # crash is allowed


def test_controller_ladder_validation():
    eng = _FakeEngine()
    with pytest.raises(ValueError):
        OverloadController(eng, ladder=(BrownoutLevel(1),))
    with pytest.raises(ValueError):
        OverloadController(eng, ladder=(BrownoutLevel(0),
                                        BrownoutLevel(2)))
    with pytest.raises(ValueError):
        OverloadController(eng, up=0.5, down=0.5)


def test_interval_rate_limit():
    eng = _FakeEngine()
    ctrl = OverloadController(eng, interval_s=3600.0)
    assert ctrl.tick() is None
    n = ctrl._tick_n
    for _ in range(5):
        ctrl.tick()                    # all rate-limited away
    assert ctrl._tick_n == n


def test_apply_knobs(qsetup):
    """The ladder's levers land on the scheduler/cache as documented, and
    level 0 restores exactly today's behavior."""
    model, params = qsetup
    eng = ContinuousEngine(model, params, device="cpu", max_batch=4, page_size=4,
                           num_pages=32, max_seq=32, prefill_chunk=8,
                           decode_horizon=8)
    ctrl = OverloadController(eng, interval_s=0.0)
    sched = eng.scheduler
    ctrl.level = 3
    ctrl.apply_to(eng)
    assert sched.horizon_cap == 2              # 8 * 0.25
    assert sched.max_wave_segments == 2        # 4 * 0.5
    assert sched.effective_horizon == 2
    assert sched.shed_classes == frozenset()
    ctrl.level = 4
    ctrl.apply_to(eng)
    assert sched.shed_classes == frozenset({"batch"})
    assert sched.max_wave_segments == 1
    ctrl.level = 0
    ctrl.apply_to(eng)
    assert sched.horizon_cap is None
    assert sched.max_wave_segments is None
    assert sched.shed_classes == frozenset()
    assert sched.effective_horizon == 8
    eng.close(check=True)


def test_lru_eviction_floor(qsetup):
    """Level >= 3 shrinks the prefix-cache LRU park toward the floor; the
    pages come back to the free list (no leak)."""
    model, params = qsetup
    eng = ContinuousEngine(model, params, device="cpu", max_batch=2, page_size=4,
                           num_pages=32, max_seq=32, prefill_chunk=8)
    # park prefix pages on the LRU: run a few prompts to completion
    for i in range(3):
        eng.submit(np.arange(1 + 8 * i, 9 + 8 * i, dtype=np.int32) % 64, 2)
    eng.run()
    parked = len(eng.cache._lru)
    assert parked > 0
    free_before = eng.cache.n_free_pages
    ctrl = OverloadController(eng, interval_s=0.0)
    ctrl.level = 4                     # lru_frac=0.0: evict the whole park
    ctrl.apply_to(eng)
    assert len(eng.cache._lru) == 0
    assert eng.cache.n_free_pages == free_before + parked
    eng.close(check=True)


# -- capture discipline -------------------------------------------------------

def test_level_changes_never_trace_after_warmup(qsetup):
    """Brownout levels only select already-warmed shapes: horizon capping
    is a dynamic clamp, wave capping selects a smaller warmed bucket. A
    load driven through every level after warmup() must add zero graph
    captures — and stay token-identical to level 0."""
    model, params = qsetup
    prompts = [np.arange(2 + 3 * i, 12 + 3 * i, dtype=np.int32) % 64
               for i in range(6)]

    def run(level):
        eng = ContinuousEngine(model, params, device="cpu", max_batch=4, page_size=4,
                               num_pages=64, max_seq=32, prefill_chunk=8,
                               decode_horizon=4)
        eng.warmup()
        ctrl = OverloadController(eng, interval_s=0.0)
        ctrl.level = level
        ctrl.apply_to(eng)
        baseline = jit_trace_count()
        rids = [eng.submit(p, 6) for p in prompts]
        out = eng.run()
        assert jit_trace_count() == baseline, \
            f"level {level} triggered a post-warmup capture"
        eng.close(check=True)
        return [out[r].tolist() for r in rids]

    ref = run(0)
    for level in range(1, len(DEFAULT_LADDER)):
        assert run(level) == ref, f"level {level} changed tokens"


# -- supervisor integration ---------------------------------------------------

def test_supervisor_rebuild_inherits_level(qsetup):
    """A crash mid-overload rebuilds the engine at the controller's level
    (no flap through level 0), and by-class counters fold across the
    incarnations."""
    model, params = qsetup
    plan = FaultPlan([FaultEvent("step", 4, "crash")])
    sup = EngineSupervisor(
        lambda: ContinuousEngine(model, params, device="cpu", max_batch=4, page_size=4,
                                 num_pages=64, max_seq=32, prefill_chunk=8,
                                 decode_horizon=4, faults=plan),
        watchdog=False)
    ctrl = OverloadController(sup, interval_s=0.0)
    assert sup._overload is ctrl               # attach_overload ran
    ctrl.level = 2
    ctrl.apply_to(sup)
    assert sup.scheduler.horizon_cap == 2
    rids = [sup.submit(np.arange(1 + i, 9 + i, dtype=np.int32) % 64, 6,
                       priority=("interactive", "batch")[i % 2],
                       deadline_ms=60_000)
            for i in range(4)]
    out = sup.run()
    assert sup.n_restarts >= 1
    assert sorted(out) == sorted(rids)         # replay completed everyone
    # the rebuilt incarnation still carries level 2's knobs
    assert ctrl.level == 2
    assert sup.scheduler.horizon_cap == 2
    st = sup.stats()
    assert st["admissions_by_class"]["interactive"] >= 2
    assert st["admissions_by_class"]["batch"] >= 2
    sup.close(check=True)


def test_supervised_chaos_drain(qsetup):
    """Controller-site chaos during supervised serving: a stuck-at-max
    injection while work is in flight. The ladder pins at max, transitions
    stay hysteresis-bounded, admitted work still completes token-identical,
    and the drain leaves a clean pool."""
    model, params = qsetup
    prompts = [np.arange(1 + 2 * i, 11 + 2 * i, dtype=np.int32) % 64
               for i in range(5)]
    ref_eng = ContinuousEngine(model, params, device="cpu", max_batch=4, page_size=4,
                               num_pages=64, max_seq=32, prefill_chunk=8)
    ref_rids = [ref_eng.submit(p, 6) for p in prompts]
    ref_out = ref_eng.run()
    ref = {i: ref_out[r].tolist() for i, r in enumerate(ref_rids)}
    ref_eng.close()

    plan = FaultPlan([FaultEvent("controller", 2, "stuck")])
    sup = EngineSupervisor(
        lambda: ContinuousEngine(model, params, device="cpu", max_batch=4, page_size=4,
                                 num_pages=64, max_seq=32,
                                 prefill_chunk=8),
        watchdog=False)
    ctrl = OverloadController(sup, interval_s=0.0, up_ticks=1,
                              down_ticks=1, min_dwell_ticks=3, faults=plan)
    rids = [sup.submit(p, 6) for p in prompts]
    done = {}
    n_ticks = 0
    while sup.has_work:
        sup.step()
        ctrl.tick()
        done.update(sup.collect())
        n_ticks += 1
        assert n_ticks < 2000
    done.update(sup.collect())
    # stuck-at-max engaged, transitions stayed hysteresis-bounded, and
    # every admitted request completed token-identical under max brownout
    assert ctrl.level == len(DEFAULT_LADDER) - 1
    assert ctrl.n_transitions <= n_ticks // ctrl.min_dwell_ticks + 1
    assert sorted(done) == sorted(rids)
    for i, r in enumerate(rids):
        assert done[r].tolist() == ref[i], f"prompt {i} diverged"
    sup.drain()
    assert sup.drained
    sup.close(check=True)              # invariants: zero leaked pages


# -- the overload soak --------------------------------------------------------

SOAK_LADDER = (
    BrownoutLevel(0),
    BrownoutLevel(1, horizon_frac=0.5, wave_frac=0.5),
    BrownoutLevel(2, horizon_frac=0.25, wave_frac=0.5, lru_frac=0.0,
                  shed=("batch",)),
)


def _soak_cohort(n=12):
    """Mixed-priority cohort, round-robin classes, deterministic prompts.
    Deadlines are generous (they order admission, not abort work)."""
    rng = np.random.default_rng(7)
    cohort = []
    for i in range(n):
        prompt = rng.integers(1, 64, (int(rng.integers(5, 12)),)) \
            .astype(np.int32)
        cls = ("interactive", "standard", "batch")[i % 3]
        cohort.append((prompt, 8, cls))
    return cohort


def _drive_soak(model, params, *, overload, execution="simulated",
                kv_bits=16, num_pages=24, cohort=None,
                ladder=SOAK_LADDER, ctrl_kw=None, mesh=None):
    """Direct-drive overload run: the cohort's whole-sequence page demand
    is ~2x the pool's usable pages. TTFT is measured in engine *steps*
    (fully deterministic — no wall clock). Returns
    ``(outputs_by_cohort_idx, ttft_steps_by_idx, shed_idxs, stats)``."""
    eng = ContinuousEngine(model, params, device="cpu", max_batch=4, page_size=4,
                           num_pages=num_pages, max_seq=32,
                           prefill_chunk=8, decode_horizon=4,
                           max_waiting=32, execution=execution,
                           kv_bits=kv_bits, mesh=mesh)
    # the demand bound would shed class-blind before brownout gets a say;
    # this soak isolates the controller's class-aware shedding
    eng.scheduler.oversubscribe = 100.0
    ctrl = None
    if overload:
        kw = dict(interval_s=0.0, up=0.6, down=0.2, up_ticks=1,
                  down_ticks=3, min_dwell_ticks=2, ladder=ladder)
        kw.update(ctrl_kw or {})
        ctrl = OverloadController(eng, **kw)
    cohort = _soak_cohort() if cohort is None else cohort
    idx_of = {}                        # engine rid -> cohort index
    outputs, ttft, shed, submit_step = {}, {}, set(), {}
    step_n, next_i = 0, 0
    while next_i < len(cohort) or eng.scheduler.has_work:
        # open-loop arrival: two submits per step until exhausted (the
        # pool drains slower than that -> sustained ~2x overload)
        for _ in range(2):
            if next_i >= len(cohort):
                break
            prompt, max_new, cls = cohort[next_i]
            try:
                rid = eng.submit(prompt, max_new, priority=cls,
                                 deadline_ms=120_000)
                idx_of[rid] = next_i
                submit_step[rid] = step_n
            except Saturated:
                shed.add(next_i)
            next_i += 1
        eng.step()
        step_n += 1
        assert step_n < 5000, "soak stalled: starvation"
        for rid, (new, done) in eng.stream_updates().items():
            i = idx_of[rid]
            if new and i not in ttft:
                ttft[i] = step_n - submit_step[rid]
            outputs.setdefault(i, []).extend(new)
        if ctrl is not None:
            ctrl.tick()
    st = eng.stats()
    eng.close(check=True)              # zero leaks after the soak
    return outputs, ttft, shed, st, cohort


SOAK_REF = dict(max_batch=4, page_size=4, num_pages=96, max_seq=32,
                prefill_chunk=8, decode_horizon=4)


def _soak_reference(model, params, cohort, **kw):
    """Unloaded run of the same cohort: ample pool, no controller."""
    eng = ContinuousEngine(model, params, device="cpu", **SOAK_REF, **kw)
    rids = [eng.submit(p, n, priority=c) for p, n, c in cohort]
    out = eng.run()
    eng.close()
    return [out[r].tolist() for r in rids]


def _soak_jax_reference(ref_setup, cohort, **kw):
    """The same unloaded run on the reference ContinuousEngine."""
    jm, jp = ref_setup
    eng = j_serve.ContinuousEngine(jm, jp, **SOAK_REF, **kw)
    rids = [eng.submit(p, n, priority=c) for p, n, c in cohort]
    out = eng.run()
    return [out[r].tolist() for r in rids]


@pytest.mark.parametrize("execution", ["simulated", "packed"])
@pytest.mark.parametrize("kv_bits", [16, 8])
def test_overload_soak_token_identity(qsetup, ref_setup, execution,
                                     kv_bits):
    """2x-capacity mixed-priority soak: every admitted request completes
    (zero starvation), every completed output is token-identical to the
    unloaded run (the port's and the reference engine's), sheds are
    explicit 429-path rejections (batch class only), and the pool ends
    clean."""
    model, params = qsetup
    outputs, ttft, shed, st, cohort = _drive_soak(
        model, params, overload=True, execution=execution, kv_bits=kv_bits)
    ref = _soak_reference(model, params, cohort, execution=execution,
                          kv_bits=kv_bits)
    assert ref == _soak_jax_reference(ref_setup, cohort,
                                      execution=execution, kv_bits=kv_bits)
    admitted = [i for i in range(len(cohort)) if i not in shed]
    assert set(outputs) == set(admitted), "starved request"
    for i in admitted:
        assert outputs[i] == ref[i], \
            f"cohort[{i}] diverged under load ({execution}, kv{kv_bits})"
    for i in shed:
        assert cohort[i][2] == "batch", "only batch class may be shed"
    assert all(t >= 0 for t in ttft.values())
    assert st["sheds_by_class"]["interactive"] == 0


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_overload_soak_tp2(qsetup, kv_bits):
    """The soak invariants hold on a 2-way tensor-parallel mesh (two CPU
    ranks): no starvation, and every admitted request's tokens are the
    unloaded tp = 2 run's."""
    from repro_torch.launch.mesh import make_tp_mesh
    model, params = qsetup
    mesh = make_tp_mesh(2, devices=["cpu", "cpu"])
    try:
        outputs, _ttft, shed, _st, cohort = _drive_soak(
            model, params, overload=True, kv_bits=kv_bits, mesh=mesh)
        ref = _soak_reference(model, params, cohort, kv_bits=kv_bits,
                              mesh=mesh)
    finally:
        mesh.close()
    admitted = [i for i in range(len(cohort)) if i not in shed]
    assert set(outputs) == set(admitted), "starved request"
    for i in admitted:
        assert outputs[i] == ref[i], f"cohort[{i}] diverged under tp=2"


def test_soak_interactive_ttft_beats_uncontrolled(qsetup):
    """The point of the ladder: under a sustained batch flood, the
    controller sheds batch at the admission door so later interactive
    arrivals find free decode slots; uncontrolled, every interactive
    queues behind long batch decodes already holding the slots. TTFT p99
    is measured in engine steps — fully deterministic, no wall clock."""
    model, params = qsetup
    rng = np.random.default_rng(11)

    def _prompt():
        return rng.integers(1, 64, (int(rng.integers(5, 8)),)) \
            .astype(np.int32)

    # 12 long batch requests flood the slots first; then interactive
    # arrives at 2/step — faster than slots can turn over while admitted
    # batch still drains, so a backlog builds unless batch is shed
    cohort = [(_prompt(), 16, "batch") for _ in range(12)]
    cohort += [(_prompt(), 4, "interactive") for _ in range(12)]
    # shed-only ladder: no horizon/wave shrink, so any TTFT gap is
    # attributable purely to class-aware admission shedding
    shed_only = (BrownoutLevel(0), BrownoutLevel(1, shed=("batch",)))
    # pages fill incrementally as decodes run, so pool pressure climbs
    # slowly: a low trigger closes the door before the queue fills
    knobs = dict(up=0.15, down=0.05, up_ticks=1, down_ticks=100,
                 min_dwell_ticks=1)

    def interactive_p99(overload):
        _outputs, ttft, _shed, _st, _c = _drive_soak(
            model, params, overload=overload, cohort=cohort, num_pages=40,
            ladder=shed_only, ctrl_kw=knobs)
        vals = sorted(t for i, t in ttft.items()
                      if cohort[i][2] == "interactive")
        assert vals, "no interactive request got a first token"
        return vals[min(len(vals) - 1, int(np.ceil(0.99 * len(vals))) - 1)]

    controlled = interactive_p99(True)
    uncontrolled = interactive_p99(False)
    assert controlled < uncontrolled, (
        f"controller did not improve interactive TTFT p99: "
        f"{controlled} vs {uncontrolled} steps")


# -- HTTP front door ----------------------------------------------------------

def test_http_overload_end_to_end(qsetup):
    """Server-level integration: priority/deadline_ms accepted over HTTP,
    /healthz reports brownout_level, a stuck-at-max controller sheds batch
    requests with a load-derived Retry-After, and msb_* overload families
    render."""
    import http.client

    def req(host, port, method, path, payload=None):
        conn = http.client.HTTPConnection(host, port, timeout=120)
        try:
            body = None if payload is None else json.dumps(payload).encode()
            conn.request(method, path, body=body,
                         headers={"Content-Type": "application/json"})
            r = conn.getresponse()
            return r.status, dict(r.getheaders()), r.read()
        finally:
            conn.close()

    model, params = qsetup
    plan = FaultPlan([FaultEvent("controller", 0, "stuck")])
    srv = APIServer(
        ContinuousEngine(model, params, device="cpu", max_batch=4, page_size=4,
                         num_pages=64, max_seq=32, prefill_chunk=8),
        overload={"interval_s": 0.0, "up_ticks": 1, "down_ticks": 1,
                  "min_dwell_ticks": 1, "faults": plan})
    host, port = srv.serve_background()
    try:
        # normal completion with the new request fields
        status, _h, body = req(host, port, "POST", "/v1/completions",
                               {"prompt": [1, 2, 3], "max_tokens": 3,
                                "priority": "interactive",
                                "deadline_ms": 30_000})
        assert status == 200, body
        # bad priority -> 400 naming the param
        status, _h, body = req(host, port, "POST", "/v1/completions",
                               {"prompt": [1], "priority": "vip"})
        assert status == 400
        assert json.loads(body)["error"]["param"] == "priority"
        # the stuck fault pins the ladder at max within a few idle ticks
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            _s, _h, body = req(host, port, "GET", "/healthz")
            if json.loads(body)["brownout_level"] \
                    == len(DEFAULT_LADDER) - 1:
                break
            time.sleep(0.05)
        else:
            pytest.fail(f"brownout_level never reached max: {body}")
        # batch class is shed with a load-derived Retry-After
        status, headers, body = req(host, port, "POST", "/v1/completions",
                                    {"prompt": [5, 6], "max_tokens": 2,
                                     "priority": "batch"})
        assert status == 429, body
        assert 1 <= int(headers["Retry-After"]) <= 30
        assert json.loads(body)["error"]["type"] == "overloaded_error"
        # interactive still flows at max brownout
        status, _h, body = req(host, port, "POST", "/v1/completions",
                               {"prompt": [7, 8], "max_tokens": 2,
                                "priority": "interactive"})
        assert status == 200, body
        # the new families render, and the shed counter saw the batch 429
        _s, _h, metrics = req(host, port, "GET", "/metrics")
        text = metrics.decode()
        for fam in ("msb_brownout_level", "msb_brownout_transitions_total",
                    "msb_shed_total", "msb_admissions_total",
                    "msb_preemptions_total"):
            assert fam in text, fam
        assert 'msb_shed_total{class="batch"} 1' in text
    finally:
        srv.close()
