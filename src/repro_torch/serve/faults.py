"""Deterministic fault injection for the serving stack (port of
``repro.serve.faults`` by copy; DESIGN.md Sec. 14).

Every recovery path in the supervisor (serve/supervisor.py) exists because
some step of the serving pipeline can fail in production: a device dispatch
raises, the allocator runs dry, a step hangs, the detokenize thread dies, a
client socket drops mid-stream. None of those happen on a healthy CI host,
so without injection the recovery code is dead code until the first real
incident. This module makes faults *first-class, seeded inputs*: a
``FaultPlan`` is an explicit schedule of ``FaultEvent``s keyed on (site,
call index), so a chaos test replays the exact same failure sequence on
every run — and a recovery bug bisects like any other regression.

Sites (where ``fire(site)`` is called):

  * ``"step"``   — top of ``ContinuousEngine.step()``, before any work is
    scheduled. A crash here models a dispatch/tracing failure surfacing at
    the step boundary; a stall models a hung device dispatch.
  * ``"apply"``  — inside the engine's decode paths *after* the device
    dispatch, before host bookkeeping (commit/sample). A crash here leaves
    device pools written but host state behind — the nastiest partial
    state recovery must handle (it discards the incarnation wholesale).
  * ``"alloc"``  — inside ``PagedKVCache.reserve``. An ``oom`` event
    raises ``InjectedOOM`` (an ``OutOfPages``), which the scheduler treats
    exactly like real pool exhaustion: preemption, not crash. Pool
    pressure is the *common* failure at serving scale and must degrade
    gracefully without supervisor involvement.
  * ``"detok"``  — top of the detokenize thread's batch loop (between
    batches, so no event is ever half-processed). A crash kills the
    thread; the engine loop detects and restarts it.
  * ``"socket"`` — per token-bearing SSE frame in the HTTP stream writer.
    A crash drops the client connection mid-stream, exercising the
    disconnect -> abort -> page-release path under load.
  * ``"controller"`` — top of ``OverloadController.tick()``. The control
    plane has its own failure modes: a stuck pressure signal pinning the
    ladder at max brownout (``kind="stuck"``), or a signal oscillating
    between extremes every tick trying to make the ladder flap
    (``kind="flap"``). Both raise ``InjectedControlFault``, which the
    controller *catches* and converts into a forced pressure override —
    the chaos test then asserts the hysteresis guard still bounds the
    transition rate and the server drains cleanly. A plain ``crash``
    here is also caught: a controller failure must never take down the
    engine loop, it just holds the current level (fail-safe).

Kinds: ``"crash"`` raises ``InjectedFault``; ``"oom"`` raises
``InjectedOOM``; ``"stall"`` sleeps ``stall_s`` then returns (the step
completes, late — what a watchdog must catch); ``"stuck"``/``"flap"``
(controller site only) raise ``InjectedControlFault``.

The default is a shared no-op plan (``NO_FAULTS``): one attribute check
per site call, no lock, no allocation — production pays nothing.
``FaultPlan.seeded(seed, ...)`` derives a reproducible schedule from a
single integer; two plans built from the same seed fire identically.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .paged_cache import OutOfPages

SITES = ("step", "apply", "alloc", "detok", "socket", "controller")
KINDS = ("crash", "oom", "stall", "stuck", "flap")
# kinds that only make sense at the controller site (pressure overrides,
# not exceptions that escape) — and the only non-crash kinds it accepts
_CONTROLLER_KINDS = ("stuck", "flap", "crash")


class InjectedFault(RuntimeError):
    """A FaultPlan-scheduled crash. Deliberately a plain RuntimeError
    subtype: the supervisor must not special-case injected faults — it
    sees an exception escaping the engine, same as production."""


class InjectedOOM(OutOfPages):
    """A FaultPlan-scheduled allocator failure. An ``OutOfPages`` subtype
    so the scheduler's preemption path handles it identically to real
    pool exhaustion."""


class InjectedControlFault(RuntimeError):
    """A FaultPlan-scheduled control-plane fault. ``mode`` is ``"stuck"``
    (pressure pinned at max from now on) or ``"flap"`` (pressure alternates
    between extremes every tick). Raised by ``fire("controller")`` and
    *caught* by ``OverloadController.tick`` — control-plane faults degrade
    the controller, never the engine."""

    def __init__(self, mode: str, msg: str = ""):
        super().__init__(msg or f"injected controller fault ({mode})")
        self.mode = mode


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault: fires on the ``at``-th call (0-based) of
    ``site``. ``stall_s`` is only meaningful for ``kind="stall"``."""
    site: str
    at: int
    kind: str = "crash"
    stall_s: float = 0.0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(sites: {SITES})")
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(kinds: {KINDS})")
        if self.kind in ("stuck", "flap") and self.site != "controller":
            raise ValueError(f"kind {self.kind!r} is controller-site only "
                             f"(got site {self.site!r})")
        if self.site == "controller" and self.kind not in _CONTROLLER_KINDS:
            raise ValueError(f"controller site accepts kinds "
                             f"{_CONTROLLER_KINDS}, got {self.kind!r}")
        if self.at < 0:
            raise ValueError(f"fault index must be >= 0, got {self.at}")


class FaultPlan:
    """A deterministic schedule of faults over per-site call counters.

    ``fire(site)`` increments the site's counter and, if an event is
    scheduled at that index, raises or stalls accordingly. Counters are
    lock-protected (sites are hit from the engine, detokenize and asyncio
    threads); fired events land on ``self.fired`` for assertions.

    A plan is exhausted when every event has fired — ``exhausted`` lets a
    chaos test keep the workload running until the full schedule has
    been delivered.
    """

    def __init__(self, events: Sequence[FaultEvent] = (),
                 seed: Optional[int] = None):
        self.seed = seed
        by_site: Dict[str, Dict[int, FaultEvent]] = {}
        for ev in events:
            slot = by_site.setdefault(ev.site, {})
            if ev.at in slot:
                raise ValueError(f"duplicate fault at ({ev.site}, {ev.at})")
            slot[ev.at] = ev
        self._events = by_site
        self._counts = {site: 0 for site in SITES}
        self._lock = threading.Lock()
        self.n_events = len(tuple(events))
        self.fired: List[Tuple[str, int, str]] = []  # (site, at, kind)

    # -- construction -------------------------------------------------------
    @classmethod
    def seeded(cls, seed: int, *, n_faults: int = 10,
               sites: Sequence[str] = ("step", "apply", "alloc"),
               first: int = 2, spread: int = 200,
               stall_s: float = 0.05,
               stall_weight: float = 0.25) -> "FaultPlan":
        """Derive a reproducible ``n_faults``-event schedule from ``seed``.

        Call indices are sampled without replacement per site from
        ``[first, first + spread)`` — dense enough to hit mid-stream
        states, never index 0 of everything at once. ``step``-site events
        become stalls with probability ``stall_weight`` (a watchdog needs
        hangs, not just crashes); ``alloc`` events are always ``oom``.
        """
        import random
        rng = random.Random(seed)
        taken: Dict[str, set] = {s: set() for s in SITES}
        events = []
        for _ in range(int(n_faults)):
            site = rng.choice(tuple(sites))
            at = first + rng.randrange(spread)
            while at in taken[site]:
                at = first + rng.randrange(spread)
            taken[site].add(at)
            if site == "alloc":
                kind = "oom"
            elif site == "controller":
                kind = rng.choice(("stuck", "flap"))
            elif site == "step" and rng.random() < stall_weight:
                kind = "stall"
            else:
                kind = "crash"
            events.append(FaultEvent(site, at, kind, stall_s=stall_s))
        return cls(events, seed=seed)

    # -- the hot path --------------------------------------------------------
    armed = True

    def fire(self, site: str):
        """Tick ``site``'s counter; crash/stall if an event is due."""
        with self._lock:
            n = self._counts[site]
            self._counts[site] = n + 1
            ev = self._events.get(site, {}).get(n)
            if ev is None:
                return
            self.fired.append((ev.site, ev.at, ev.kind))
        if ev.kind == "stall":
            time.sleep(ev.stall_s)
            return
        msg = (f"injected {ev.kind} at site={ev.site!r} call #{ev.at}"
               + (f" (seed={self.seed})" if self.seed is not None else ""))
        if ev.kind == "oom":
            raise InjectedOOM(msg)
        if ev.kind in ("stuck", "flap"):
            raise InjectedControlFault(ev.kind, msg)
        raise InjectedFault(msg)

    # -- introspection -------------------------------------------------------
    @property
    def exhausted(self) -> bool:
        """True once every scheduled event has fired."""
        return len(self.fired) >= self.n_events

    def calls(self, site: str) -> int:
        with self._lock:
            return self._counts[site]

    def __repr__(self):
        return (f"FaultPlan(n_events={self.n_events}, "
                f"fired={len(self.fired)}, seed={self.seed})")


class _NoFaults:
    """The production default: ``fire`` is a no-op with no lock and no
    allocation. ``armed = False`` lets extra-hot call sites skip even the
    method call (``if faults.armed: faults.fire(...)``)."""

    armed = False
    n_events = 0
    exhausted = True
    fired: List[Tuple[str, int, str]] = []

    def fire(self, site: str):
        return

    def calls(self, site: str) -> int:
        return 0

    def __repr__(self):
        return "NO_FAULTS"


NO_FAULTS = _NoFaults()
