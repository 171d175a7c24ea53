"""Engine supervision: crash containment, watchdog, token-identical replay.

Port of ``repro.serve.supervisor`` by copy. "Warmup" and "compile" below
read, in the port, as the capture of the engine's dispatch set as CUDA
graphs (``serve/graphs.py``): the warm-up window and the first steps'
deadline amnesty of every incarnation cover that capture.

DESIGN.md Sec. 14. The serving stack's entire data plane hangs off one
step loop; without this module, any exception or hung dispatch in that
loop would strand every in-flight client and leak every page lease.
``EngineSupervisor`` wraps ``ContinuousEngine`` with the same
submit/step/collect/stream_updates surface and adds the failure-domain
boundary the ROADMAP's north star requires:

  * **Crash containment.** An exception escaping ``engine.step()`` is
    caught, the incarnation is discarded wholesale (host metadata may be
    mid-mutation; nothing is trusted), and a fresh engine — new
    ``PagedKVCache`` pools, new scheduler, *same* params/mesh/config — is
    built from the factory.
  * **Token-identical replay.** Every unfinished request is re-admitted
    as ``prompt + tokens generated so far`` with the remaining budget.
    Greedy decode is deterministic and batch-composition-independent
    (the engine's token-identity invariants), so the continuation is
    token-identical to the uncrashed run — clients cannot tell a crash
    happened except by latency. Replayed requests sharing a prefix
    dedupe against each other through the (rebuilt) prefix cache during
    re-prefill.
  * **Watchdog.** Steps run on a per-incarnation worker thread; the
    supervisor waits with a deadline derived from a rolling median of
    clean step times (``train.fault.StragglerMonitor`` — the same
    statistic the training stack uses to flag stragglers). A step that
    blows the deadline is declared hung: the worker is abandoned (it can
    no longer touch shared state) and recovery proceeds as for a crash.
  * **Poison quarantine.** Each crash blames the requests in the work
    unit that was stepping (a prefill chunk blames one sequence; a
    packed prefill or decode blames the batch; a pre-schedule crash
    blames every running sequence). A request blamed
    ``max_crashes_per_request`` times is quarantined: it fails with
    ``PoisonedRequest`` (surfaced as a 500 naming the cause) instead of
    crashing the engine a fourth time — the cohort survives. A crash
    blamed on a *multi-segment packed prefill* additionally switches
    every later incarnation to one-segment prefill waves (crash
    isolation), so repeat blame — and therefore quarantine — lands on
    the poisoned request alone, never on innocent packing neighbors.
  * **Warmup.** ``warmup()`` AOT-compiles the incarnation's reachable
    trace set (``serve.warmup``), surfacing ``warming`` health /
    ``Warming`` (503 + Retry-After) while it runs; once requested, every
    rebuilt incarnation re-warms inside its recovery window.
  * **Drain.** ``drain()`` stops admissions (``Draining`` -> HTTP 503)
    while in-flight work runs to completion; ``drained`` flips when the
    engine is empty. Wired to SIGTERM via ``train.fault
    .PreemptionHandler`` in the server entry point.

Replay is deliberately *two-phase*: recovery (inside the crashed
``step()``) rebuilds the engine and computes the replay set; re-admission
happens at the *next* ``step()``. The window between the phases is where
an ``abort_request`` racing a rebuild lands — an aborted request is
dropped from the replay set, never resurrected (negative-tested).

The supervisor is single-threaded by contract, like the engine: every
mutation (submit/step/abort) must come from one thread (the server's
engine loop). ``would_accept`` and ``health`` are read-only and safe to
probe from other threads.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..train.fault import StragglerMonitor
from .scheduler import Saturated

__all__ = ["Draining", "EngineDied", "EngineSupervisor", "PoisonedRequest",
           "Recovering", "Warming", "WatchdogTimeout"]


class EngineDied(RuntimeError):
    """The engine is gone for good: the supervisor exhausted its restart
    budget (or there is no supervisor and the step loop crashed). Every
    in-flight request fails with this instead of hanging forever."""


class PoisonedRequest(RuntimeError):
    """This request was in the blamed work unit of
    ``max_crashes_per_request`` engine crashes and is quarantined: it
    fails (HTTP 500 naming the cause) so the rest of the cohort can make
    progress."""


class WatchdogTimeout(RuntimeError):
    """A step exceeded the watchdog deadline and was declared hung."""


class Draining(RuntimeError):
    """Admissions are closed: the server is draining toward shutdown.
    Maps to HTTP 503 (permanent for this replica — go elsewhere)."""


class Recovering(RuntimeError):
    """Admissions are briefly closed while a crash recovery rebuilds the
    engine and re-admits in-flight work. Maps to HTTP 503 + Retry-After
    (transient — retry this replica shortly)."""


class Warming(RuntimeError):
    """Admissions are closed while startup AOT warmup compiles the
    reachable trace set (``serve.warmup``). Maps to HTTP 503 +
    Retry-After, like ``Recovering`` — transient, retry shortly."""


# health states, in increasing order of trouble
OK, WARMING, DEGRADED, DRAINING, DEAD = (
    "ok", "warming", "degraded", "draining", "dead")


class _SupReq:
    """Supervisor-side record of one request: the replay source of truth.

    ``tokens`` accumulates every generated token across incarnations;
    after a crash the request is re-admitted as ``prompt + tokens`` with
    ``max_new_tokens - len(tokens)`` budget, which greedy determinism
    makes token-identical to the uncrashed continuation."""

    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_id", "tokens",
                 "engine_rid", "crashes", "finished", "aborted", "error",
                 "reported_done", "stream_off", "priority", "deadline_at")

    def __init__(self, rid, prompt, max_new_tokens, eos_id,
                 priority="standard", deadline_at=None):
        self.rid = rid
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = eos_id
        # replay passes the *absolute* deadline through: a crash must not
        # grant a request extra EDF slack
        self.priority = priority
        self.deadline_at = deadline_at
        self.tokens: List[int] = []
        self.engine_rid: Optional[int] = None   # id in the current engine
        self.crashes = 0                        # times blamed for a crash
        self.finished = False
        self.aborted = False
        self.error: Optional[Exception] = None
        self.reported_done = False
        self.stream_off = 0                     # tokens already streamed


class EngineSupervisor:
    """Owns a ``ContinuousEngine`` built by ``factory`` and mirrors its
    driving API (``submit``/``step``/``collect``/``stream_updates``/
    ``abort_request``/``would_accept``/``has_work``/``stats``), adding
    crash recovery, a hang watchdog, poison quarantine and drain.

    ``factory`` must be a zero-arg callable returning a fresh
    ``ContinuousEngine`` with identical config each call (same model,
    params, mesh, execution, horizon) — replay correctness rides on the
    rebuilt engine being greedy-token-identical to the crashed one.

    Watchdog: a step's deadline is ``max(watchdog_floor_s,
    watchdog_factor * rolling median)`` of clean step times (median via
    ``StragglerMonitor``; the factor only engages once >= 10 samples
    exist). The first ``warmup_steps`` steps of every incarnation use
    ``max(deadline, warmup_deadline_s)`` instead — a fresh incarnation
    may be JIT-compiling (mesh engines rebuild their shard_map closures),
    and compilation is indistinguishable from a hang. ``watchdog=False``
    runs steps inline on the calling thread (no hang detection, no extra
    thread) — crash containment and replay still apply.
    """

    def __init__(self, factory: Callable[[], object], *,
                 max_crashes_per_request: int = 3,
                 max_restarts: Optional[int] = None,
                 watchdog: bool = True,
                 watchdog_floor_s: float = 30.0,
                 watchdog_factor: float = 8.0,
                 watchdog_window: int = 50,
                 warmup_steps: int = 2,
                 warmup_deadline_s: float = 300.0,
                 degraded_window_s: float = 2.0):
        self._factory = factory
        self.max_crashes_per_request = int(max_crashes_per_request)
        self.max_restarts = max_restarts
        self.watchdog_enabled = bool(watchdog)
        self.watchdog_floor_s = float(watchdog_floor_s)
        self.watchdog_factor = float(watchdog_factor)
        self.warmup_steps = int(warmup_steps)
        self.warmup_deadline_s = float(warmup_deadline_s)
        self.degraded_window_s = float(degraded_window_s)
        self._monitor = StragglerMonitor(window=watchdog_window,
                                         threshold=watchdog_factor)
        self.engine = factory()
        self._worker = (_StepWorker(self.engine)
                        if self.watchdog_enabled else None)
        self._steps_this_incarnation = 0
        self._next_rid = 0
        self._reqs: Dict[int, _SupReq] = {}     # all live supervised reqs
        self._by_engine: Dict[int, int] = {}    # engine rid -> sup rid
        self._pending_replay: List[int] = []    # phase-B re-admissions
        self._failures: Dict[int, Exception] = {}
        self._finished_out: Dict[int, np.ndarray] = {}
        self._recovering = False
        self._warming = False       # startup/rebuild AOT warmup in flight
        self._warmed = False        # warmup() was requested: re-warm rebuilds
        self._isolate_prefill = False   # crash blamed on a packed prefill
        self._dead: Optional[Exception] = None
        self.draining = False
        self._degraded_until = 0.0
        # monotonic counters accumulated across incarnations (an engine's
        # own counters reset when it is rebuilt; metrics must not regress)
        self._base = {k: 0 for k in _ENGINE_COUNTERS}
        self._base_dicts: Dict[str, Dict[str, int]] = {
            k: {} for k in _ENGINE_DICT_COUNTERS}
        self._aborts_extra = 0      # aborts of pending-replay requests
        self._overload = None       # OverloadController, if attached
        self.n_restarts = 0
        self.n_watchdog_trips = 0
        self.n_replayed_tokens = 0
        self.n_quarantined = 0
        self.recovery_log: List[float] = []     # seconds per recovery
        self.last_crash: Optional[Exception] = None

    # -- admission ----------------------------------------------------------
    @property
    def health(self) -> str:
        if self._dead is not None:
            return DEAD
        if self.draining:
            return DRAINING
        if self._warming:
            return WARMING
        if (self._recovering or self._pending_replay
                or time.monotonic() < self._degraded_until):
            return DEGRADED
        return OK

    def would_accept(self, prompt_len, max_new_tokens,
                     priority="standard"):
        """Read-only admission probe, safe off-thread. Beyond the engine's
        own answers (``None`` / ``ValueError`` / ``Saturated``) this adds
        ``Draining`` (shutting down, 503) and ``Recovering`` (mid-rebuild
        window, 503 + Retry-After) and ``EngineDied``."""
        if self._dead is not None:
            return EngineDied(f"engine supervisor gave up after "
                              f"{self.n_restarts} restarts: "
                              f"{self._dead}")
        if self.draining:
            return Draining("server is draining; not accepting work")
        if self._warming:
            return Warming("engine is warming up (capturing the dispatch "
                           "set); retry shortly")
        if self._recovering or self._pending_replay:
            return Recovering("engine is recovering from a crash; "
                              "retry shortly")
        return self.engine.would_accept(prompt_len, max_new_tokens,
                                        priority=priority)

    def submit(self, prompt, max_new_tokens, eos_id=None,
               priority="standard", deadline_ms=None,
               deadline_at=None) -> int:
        """Mirror of ``ContinuousEngine.submit`` with a supervisor-owned
        request id (stable across engine rebuilds). A relative
        ``deadline_ms`` is resolved to an absolute ``deadline_at`` here,
        once — replay after a crash passes the absolute value through, so
        recovery never extends a request's EDF slack."""
        err = self._gate()
        if err is not None:
            raise err
        if deadline_at is None and deadline_ms is not None:
            deadline_at = time.monotonic() + float(deadline_ms) / 1000.0
        sr = _SupReq(self._next_rid, prompt, max_new_tokens, eos_id,
                     priority=priority, deadline_at=deadline_at)
        # engine submit first: if it rejects (Saturated/ValueError) the
        # supervisor records nothing
        erid = self.engine.submit(sr.prompt, sr.max_new_tokens,
                                  eos_id=eos_id, priority=priority,
                                  deadline_at=deadline_at)
        self._next_rid += 1
        sr.engine_rid = erid
        self._reqs[sr.rid] = sr
        self._by_engine[erid] = sr.rid
        return sr.rid

    def _gate(self) -> Optional[Exception]:
        if self._dead is not None:
            return EngineDied(f"engine supervisor gave up after "
                              f"{self.n_restarts} restarts: {self._dead}")
        if self.draining:
            return Draining("server is draining; not accepting work")
        if self._warming:
            return Warming("engine is warming up (capturing the dispatch "
                           "set); retry shortly")
        if self._recovering or self._pending_replay:
            return Recovering("engine is recovering from a crash; "
                              "retry shortly")
        return None

    def attach_overload(self, controller):
        """Register the overload controller so rebuilt incarnations
        inherit the current brownout level: the controller holds the
        level, engine incarnations only hold its consequences
        (scheduler knobs), and ``_recover`` re-applies them before the
        fresh engine dispatches anything — no flapping across crashes.
        Called by ``OverloadController.__init__``."""
        self._overload = controller

    def warmup(self):
        """AOT-warm the current incarnation's reachable trace set
        (``ContinuousEngine.warmup``). While it runs, health reads
        ``warming`` and admissions get ``Warming`` (503 + Retry-After).
        Once requested, every rebuilt incarnation re-warms inside its
        recovery window, so steady-state serving stays trace-free across
        crashes too."""
        self._warming = True
        try:
            report = self.engine.warmup()
        finally:
            self._warming = False
        self._warmed = True
        return report

    # -- the supervised step -------------------------------------------------
    @property
    def has_work(self) -> bool:
        if self._dead is not None:
            return False
        return bool(self._pending_replay) or self.engine.scheduler.has_work

    def step(self) -> bool:
        """One supervised engine step. Contains crashes (rebuild + replay),
        trips the watchdog on hangs, and drains the engine's stream
        updates into the supervisor's records (the replay source)."""
        if self._dead is not None:
            return False
        if self._pending_replay:
            self._resubmit_replays()
        if not self.engine.scheduler.has_work:
            return False
        t0 = time.monotonic()
        if self._worker is not None:
            outcome = self._worker.step(self._deadline())
            if outcome is None:                       # hung: abandon worker
                self.n_watchdog_trips += 1
                self._worker.abandon()
                self._recover(WatchdogTimeout(
                    f"engine step exceeded watchdog deadline "
                    f"{self._deadline():.3f}s (median "
                    f"{self._monitor.median:.3f}s over "
                    f"{len(self._monitor.times)} steps)"))
                return True
            status, value = outcome
        else:
            try:
                status, value = "ok", self.engine.step()
            except Exception as e:                     # noqa: BLE001
                status, value = "err", e
        if status == "err":
            self._recover(value)
            return True
        dt = time.monotonic() - t0
        self._steps_this_incarnation += 1
        self._monitor.record(self._base["steps"] + self.engine.n_steps, dt)
        self._drain_engine()
        return bool(value)

    def _deadline(self) -> float:
        d = self.watchdog_floor_s
        if len(self._monitor.times) >= 10:
            d = max(d, self.watchdog_factor * self._monitor.median)
        if self._steps_this_incarnation < self.warmup_steps:
            d = max(d, self.warmup_deadline_s)         # JIT compile amnesty
        return d

    def _drain_engine(self):
        """Pull the engine's per-step stream updates into the supervisor
        records immediately — the narrower this window, the fewer tokens a
        crash forces replay to regenerate."""
        for erid, (new, done) in self.engine.stream_updates().items():
            rid = self._by_engine.get(erid)
            if rid is None:
                continue                    # aborted between step and drain
            sr = self._reqs[rid]
            sr.tokens.extend(new)
            if done:
                sr.finished = True
                del self._by_engine[erid]
                sr.engine_rid = None
                self._finished_out[rid] = np.asarray(sr.tokens, np.int32)

    # -- recovery ------------------------------------------------------------
    def _recover(self, cause: Exception):
        """Phase A of recovery, inside the crashed step: blame, quarantine,
        accumulate counters, rebuild the engine. Replay (phase B) happens
        at the next ``step()`` so a racing ``abort_request`` can still
        drop a request from the replay set."""
        t0 = time.monotonic()
        self._recovering = True
        try:
            self.last_crash = cause
            self._blame(cause)
            self.n_restarts += 1
            if (self.max_restarts is not None
                    and self.n_restarts > self.max_restarts):
                self._die(cause)
                return
            self._accumulate(self.engine)
            if self._worker is not None:
                self._worker.abandon()
            # drop the discarded incarnation's dispatch graphs (and their
            # memory pool) before its successor captures its own
            self.engine.close(check=False)
            old_reqs = [rid for rid, sr in self._reqs.items()
                        if not sr.finished and sr.error is None
                        and not sr.aborted]
            self.engine = self._factory()
            if self._isolate_prefill:
                # a previous crash was blamed on a multi-segment packed
                # prefill: pack one segment per wave from here on so blame
                # (and poison quarantine) is per-request precise
                self.engine.scheduler.isolate_prefill = True
            if self._overload is not None:
                # the rebuilt incarnation inherits the brownout level the
                # controller holds — recovery under overload must not
                # briefly serve at level 0 (flap) before the next tick
                self._overload.apply_to(self.engine)
            if self._warmed:
                self._warming = True
                try:
                    self.engine.warmup()    # re-warm: per-incarnation traces
                finally:
                    self._warming = False
            if self.watchdog_enabled:
                self._worker = _StepWorker(self.engine)
            self._steps_this_incarnation = 0
            self._by_engine = {}
            for rid in old_reqs:
                self._reqs[rid].engine_rid = None
            self._pending_replay = old_reqs        # original submit order
        finally:
            self._recovering = False
            self.recovery_log.append(time.monotonic() - t0)
            self._degraded_until = time.monotonic() + self.degraded_window_s

    def _blame(self, cause: Exception):
        """Attribute the crash and quarantine over-budget requests. The
        engine's ``last_step_rids`` names the work unit that was stepping
        (one sequence for a prefill chunk, the batch for a decode); a
        crash before scheduling — or a hang, where the worker's state is
        not trusted — blames every running sequence (best-effort)."""
        blamed = tuple(getattr(self.engine, "last_step_rids", ()) or ())
        if (len(blamed) > 1 and not isinstance(cause, WatchdogTimeout)
                and getattr(self.engine, "last_step_kind", "")
                == "prefill_packed"):
            self._isolate_prefill = True    # applied to rebuilt incarnations
        if not blamed or isinstance(cause, WatchdogTimeout):
            blamed = tuple(s.req.req_id
                           for s in self.engine.scheduler.running)
        for erid in blamed:
            rid = self._by_engine.get(erid)
            if rid is None:
                continue
            sr = self._reqs[rid]
            sr.crashes += 1
            if sr.crashes >= self.max_crashes_per_request:
                sr.error = PoisonedRequest(
                    f"request quarantined after being blamed for "
                    f"{sr.crashes} engine crashes (budget "
                    f"{self.max_crashes_per_request}); last cause: "
                    f"{type(cause).__name__}: {cause}")
                self._failures[rid] = sr.error
                self.n_quarantined += 1

    def _die(self, cause: Exception):
        self._dead = cause
        for rid, sr in self._reqs.items():
            if not sr.finished and sr.error is None and not sr.aborted:
                sr.error = EngineDied(
                    f"engine supervisor gave up after {self.n_restarts} "
                    f"restarts; last cause: {type(cause).__name__}: "
                    f"{cause}")
                self._failures[rid] = sr.error
        self._pending_replay = []

    def _resubmit_replays(self):
        """Phase B: re-admit the replay set as ``prompt + generated`` with
        the remaining budget. A replay refused by backpressure stays
        pending and is retried next step (it was admitted once; shedding
        it now would drop accepted work)."""
        still_pending: List[int] = []
        for rid in self._pending_replay:
            sr = self._reqs.get(rid)
            if sr is None or sr.aborted or sr.finished \
                    or sr.error is not None:
                continue                    # raced abort/quarantine: drop
            prompt = np.concatenate(
                [sr.prompt, np.asarray(sr.tokens, np.int32)])
            remaining = sr.max_new_tokens - len(sr.tokens)
            if remaining <= 0 or (sr.eos_id is not None and sr.tokens
                                  and sr.tokens[-1] == sr.eos_id):
                sr.finished = True          # crashed after its last token
                self._finished_out[rid] = np.asarray(sr.tokens, np.int32)
                continue
            try:
                erid = self.engine.submit(prompt, remaining,
                                          eos_id=sr.eos_id,
                                          priority=sr.priority,
                                          deadline_at=sr.deadline_at)
            except Saturated:
                still_pending.append(rid)
                continue
            except ValueError as e:         # factory config shrank the pool
                sr.error = e
                self._failures[rid] = e
                continue
            sr.engine_rid = erid
            self._by_engine[erid] = rid
            self.n_replayed_tokens += len(sr.tokens)
        self._pending_replay = still_pending

    # -- request surface -----------------------------------------------------
    def abort_request(self, rid) -> bool:
        """Mirror of ``ContinuousEngine.abort_request`` that is also
        correct *during a recovery rebuild*: a request still waiting in
        the replay set is dropped from it (never resurrected). Raises
        ``KeyError`` for unknown ids; returns False when the request had
        already finished or failed (its result is dropped)."""
        sr = self._reqs.get(rid)
        if sr is None:
            raise KeyError(f"unknown request id {rid}")
        if sr.finished or sr.error is not None:
            del self._reqs[rid]
            self._finished_out.pop(rid, None)
            self._failures.pop(rid, None)
            return False
        sr.aborted = True
        del self._reqs[rid]
        if sr.engine_rid is not None:
            erid = sr.engine_rid
            self._by_engine.pop(erid, None)
            try:
                return self.engine.abort_request(erid)
            except KeyError:
                return False
        # pending replay (or mid-rebuild): nothing engine-side to free
        self._aborts_extra += 1
        return True

    def stream_updates(self) -> Dict[int, Tuple[List[int], bool]]:
        """Per-token streaming drain in supervisor ids; same exactly-once,
        in-order contract as the engine's. Quarantined/died requests are
        *not* reported here — drain them via ``pop_failures()``."""
        out: Dict[int, Tuple[List[int], bool]] = {}
        for rid in list(self._reqs):
            sr = self._reqs[rid]
            if sr.error is not None:
                continue
            new = sr.tokens[sr.stream_off:]
            if new or sr.finished:
                out[rid] = (list(new), sr.finished)
                sr.stream_off = len(sr.tokens)
            if sr.finished:
                sr.reported_done = True
                del self._reqs[rid]
                self._finished_out.pop(rid, None)
        return out

    def collect(self) -> Dict[int, np.ndarray]:
        """Drain finished outputs (full generated-token arrays, spanning
        every incarnation the request lived through)."""
        out, self._finished_out = self._finished_out, {}
        for rid in out:
            self._reqs.pop(rid, None)
        return out

    def pop_failures(self) -> Dict[int, Exception]:
        """Drain requests that *failed* (quarantined poison requests,
        engine death). Each failure is reported exactly once; the server
        loop maps these to 500s naming the cause."""
        out, self._failures = self._failures, {}
        for rid in out:
            self._reqs.pop(rid, None)
        return out

    def run(self) -> Dict[int, np.ndarray]:
        """Drive until all submitted work completes or fails."""
        done: Dict[int, np.ndarray] = {}
        while self.has_work:
            if not self.step():
                break
            done.update(self.collect())
        done.update(self.collect())
        return done

    # -- drain / teardown ----------------------------------------------------
    def drain(self):
        """Stop admissions; in-flight work keeps stepping to completion."""
        self.draining = True

    @property
    def drained(self) -> bool:
        return (self.draining and not self._pending_replay
                and not self.engine.scheduler.has_work)

    def close(self, check: bool = True):
        """Tear down: stop the step worker and (optionally) verify the
        current incarnation's allocator invariants — after a drain the
        pool must be back at baseline with zero leaked pages."""
        if self._worker is not None:
            self._worker.stop()
            self._worker = None
        self.engine.close(check=check and self._dead is None)

    # -- metrics -------------------------------------------------------------
    def _accumulate(self, engine):
        st = engine.stats()
        for k in _ENGINE_COUNTERS:
            self._base[k] += st[k]
        for k in _ENGINE_DICT_COUNTERS:
            base = self._base_dicts[k]
            for c, v in st.get(k, {}).items():
                base[c] = base.get(c, 0) + v

    def stats(self) -> Dict[str, object]:
        """Aggregated monotonic counters across every incarnation, plus
        the supervision counters. Same schema as ``ContinuousEngine
        .stats()`` with the supervisor extras — ``ServeMetrics
        .sync_engine`` consumes either."""
        st = self.engine.stats()
        out = {k: self._base[k] + st[k] for k in _ENGINE_COUNTERS}
        for k in _ENGINE_DICT_COUNTERS:
            merged = dict(self._base_dicts[k])
            for c, v in st.get(k, {}).items():
                merged[c] = merged.get(c, 0) + v
            out[k] = merged
        out["aborts"] += self._aborts_extra
        out["queue_depth"] = st["queue_depth"] + len(self._pending_replay)
        out["running"] = st["running"]
        out.update(
            restarts=self.n_restarts,
            watchdog_trips=self.n_watchdog_trips,
            replayed_tokens=self.n_replayed_tokens,
            quarantined=self.n_quarantined,
            health=self.health,
            recovery_log=list(self.recovery_log),
        )
        return out

    def drain_observations(self):
        """Passthrough of ``ContinuousEngine.drain_observations`` (bounded
        per-event samples for metrics histograms). Samples buffered inside
        a crashed incarnation are lost with it — they are observability,
        not accounting."""
        return self.engine.drain_observations()

    # passthrough conveniences for tests / benches
    @property
    def scheduler(self):
        return self.engine.scheduler

    @property
    def cache(self):
        return self.engine.cache


# the monotonic keys shared by ContinuousEngine.stats() and the
# supervisor's cross-incarnation accumulator
_ENGINE_COUNTERS = ("tokens_out", "steps", "decode_steps", "host_syncs",
                    "work_positions", "aborts", "preemptions", "admissions",
                    "prefix_hits", "prefix_positions_saved", "forks",
                    "prefill_dispatches", "prefill_segments",
                    "admission_waves", "warmup_seconds", "warmup_traces")

# per-priority-class dict counters (overload control plane), folded across
# incarnations the same way the scalar counters are
_ENGINE_DICT_COUNTERS = ("preemptions_by_class", "admissions_by_class",
                         "sheds_by_class")


class _StepWorker:
    """One engine incarnation's step executor. The supervisor thread asks
    for a step and waits with a deadline; on timeout the worker is
    *abandoned* — it may still be stuck inside the hung dispatch, but it
    holds only the discarded engine, so it can never touch the
    replacement. An abandoned worker exits as soon as the hung call
    returns (or immediately, if it was idle)."""

    def __init__(self, engine):
        import threading
        self.engine = engine
        self._go = threading.Event()
        self._done = threading.Event()
        self._quit = False
        self.result: Optional[Tuple[str, object]] = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="msb-step-worker")
        self._thread.start()

    def _run(self):
        while True:
            self._go.wait()
            self._go.clear()
            if self._quit:
                return
            try:
                self.result = ("ok", self.engine.step())
            except Exception as e:                     # noqa: BLE001
                self.result = ("err", e)
            self._done.set()
            if self._quit:
                return

    def step(self, timeout: float):
        """Run one engine.step() with a deadline; None = timed out."""
        self.result = None
        self._done.clear()
        self._go.set()
        if not self._done.wait(timeout):
            return None
        return self.result

    def abandon(self):
        self._quit = True
        self._go.set()

    def stop(self, timeout: float = 10.0):
        """Abandon, then wait up to ``timeout`` for the thread to exit (at
        once unless a step is still running), so no step thread outlives
        a closed supervisor."""
        self.abandon()
        self._thread.join(timeout)
