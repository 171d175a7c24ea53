"""Overload control plane: SLO-driven brownout ladder + load-derived
Retry-After (port of ``repro.serve.overload`` by copy; DESIGN.md Sec. 17).

Under overload the serving stack used to behave like a binary switch: the
page pool saturates, ``would_accept`` flips to 429, and every request is
treated identically. ``OverloadController`` replaces the switch with a
deterministic, hysteresis-guarded **brownout ladder**: it observes pressure
(page-pool occupancy, admission queue depth, preemption rate, and — when a
metrics registry is attached — TTFT/ITL percentiles against their SLOs) and
walks a small table of degradation levels. Level 0 is exactly today's
behavior; each successive level trades a little per-request machinery for
headroom:

  1. shrink the *effective* decode horizon for new dispatches — fewer
     speculatively leased pages per sequence, faster page turnover;
  2. cap the packed-prefill wave width — smaller prefill bursts, decode
     keeps breathing;
  3. evict the prefix-cache LRU park down to a floor — cold prefix
     residency is the cheapest RAM to give back;
  4. shed by priority class — batch-class submits turn into 429s whose
     ``Retry-After`` reflects actual load.

Every lever is **schedule-only**: the captured dispatch shapes (decode
horizon, packed-prefill buckets) never change, so a level change can
never trigger a post-warmup capture, and greedy token identity holds at every
level for whatever is admitted. Already-running work is never killed by the
controller — only deprioritized (admission order, preemption-victim order).

Concurrency contract: ``tick()`` runs on the engine thread (the
``EngineLoop`` calls it once per loop iteration, right after the metrics
sync; direct-drive harnesses call it between ``step()``s). It therefore
mutates scheduler/cache state with the same single-writer discipline as the
engine itself — no new races. ``level`` and ``last_pressure`` are single
attribute reads, safe to observe from the HTTP thread (``/healthz``,
``Retry-After``).

Hysteresis: a level transition needs (a) ``up_ticks`` consecutive ticks of
pressure >= ``up`` (or ``down_ticks`` consecutive ticks <= ``down``), and
(b) at least ``min_dwell_ticks`` ticks since the previous transition. With
``down < up`` this bounds the transition rate at one per dwell window no
matter how adversarially the pressure signal oscillates — the property the
controller-site chaos test asserts.

Supervisor interaction: the controller holds the level; engine incarnations
only hold its *consequences* (scheduler knobs). ``apply_to`` is idempotent
and re-run every tick, and ``EngineSupervisor.attach_overload`` re-applies
it inside ``_recover`` — so a crash during overload resumes at the same
level with zero flapping.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

from .faults import NO_FAULTS, InjectedControlFault, InjectedFault

MAX_RETRY_AFTER_S = 30.0


def compute_retry_after(base_s: float, *, pressure: float = 0.0,
                        level: int = 0, salt: int = 0,
                        jitter_frac: float = 0.25,
                        max_s: float = MAX_RETRY_AFTER_S) -> int:
    """The one Retry-After computation for every shedding path (saturation
    429, warming 503, recovery 503 — they used to each do it differently).

    Load-derived and deterministic: ``base_s`` is scaled up by the brownout
    level and the instantaneous pressure (a loaded server asks clients to
    back off longer), then spread by a deterministic jitter in
    ``[0, jitter_frac)`` keyed on ``salt`` (a per-rejection counter) so a
    thundering herd of simultaneous 429s does not re-synchronize its
    retries. Pure function of its inputs — golden-tested. Returns whole
    seconds >= 1 (the HTTP header granularity), capped at ``max_s``."""
    p = min(max(float(pressure), 0.0), 1.0)
    s = float(base_s) * (1.0 + int(level)) * (1.0 + p)
    # Knuth multiplicative hash of the salt -> uniform-ish [0, 1)
    h = (int(salt) * 2654435761) & 0xFFFFFFFF
    s *= 1.0 + jitter_frac * (h / 2.0 ** 32)
    return max(1, int(math.ceil(min(s, float(max_s)))))


@dataclasses.dataclass(frozen=True)
class BrownoutLevel:
    """One rung of the ladder. Fractions are of the engine's configured
    capacity (decode_horizon, max_batch, usable pages); ``1.0`` means
    untouched. ``shed`` names the priority classes turned away at
    admission while this level holds."""
    level: int
    horizon_frac: float = 1.0   # effective decode horizon / decode_horizon
    wave_frac: float = 1.0      # packed-wave width / max_batch
    lru_frac: float = 1.0       # LRU park floor / usable pages
    shed: Tuple[str, ...] = ()  # classes refused at submit

    def describe(self) -> str:
        parts = []
        if self.horizon_frac < 1.0:
            parts.append(f"horizon x{self.horizon_frac:g}")
        if self.wave_frac < 1.0:
            parts.append(f"wave x{self.wave_frac:g}")
        if self.lru_frac < 1.0:
            parts.append(f"lru floor {self.lru_frac:g}")
        if self.shed:
            parts.append("shed " + "+".join(self.shed))
        return ", ".join(parts) or "normal"


DEFAULT_LADDER: Tuple[BrownoutLevel, ...] = (
    BrownoutLevel(0),
    BrownoutLevel(1, horizon_frac=0.5),
    BrownoutLevel(2, horizon_frac=0.5, wave_frac=0.5),
    BrownoutLevel(3, horizon_frac=0.25, wave_frac=0.5, lru_frac=0.25),
    BrownoutLevel(4, horizon_frac=0.25, wave_frac=0.25, lru_frac=0.0,
                  shed=("batch",)),
)


class OverloadController:
    """Closes the loop between observed pressure and the brownout ladder.

    ``engine`` is a ``ContinuousEngine`` or an ``EngineSupervisor`` (both
    expose ``scheduler``/``cache``; the supervisor additionally gets
    ``attach_overload`` called so rebuilt incarnations inherit the level).
    ``metrics`` (optional ``ServeMetrics``) supplies TTFT/ITL percentiles
    as pressure inputs and receives the ``msb_brownout_level`` gauge and
    transition counter.
    """

    def __init__(self, engine, metrics=None, *,
                 ladder: Tuple[BrownoutLevel, ...] = DEFAULT_LADDER,
                 up: float = 0.85, down: float = 0.5,
                 up_ticks: int = 2, down_ticks: int = 4,
                 min_dwell_ticks: int = 8,
                 interval_s: float = 0.05,
                 queue_ref: Optional[int] = None,
                 ttft_slo_s: Optional[float] = None,
                 itl_slo_s: Optional[float] = None,
                 retry_after_base_s: float = 1.0,
                 faults=NO_FAULTS):
        if not ladder or ladder[0].level != 0:
            raise ValueError("ladder must start at level 0 (normal service)")
        for i, lv in enumerate(ladder):
            if lv.level != i:
                raise ValueError(f"ladder levels must be 0..{len(ladder)-1} "
                                 f"in order, got {lv.level} at index {i}")
        if not (0.0 <= down < up):
            raise ValueError(f"need 0 <= down < up for hysteresis, "
                             f"got down={down}, up={up}")
        self.engine = engine
        self.metrics = metrics
        self.ladder = tuple(ladder)
        self.up = float(up)
        self.down = float(down)
        self.up_ticks = max(1, int(up_ticks))
        self.down_ticks = max(1, int(down_ticks))
        self.min_dwell_ticks = max(1, int(min_dwell_ticks))
        self.interval_s = float(interval_s)
        self.queue_ref = queue_ref
        self.ttft_slo_s = ttft_slo_s
        self.itl_slo_s = itl_slo_s
        self.retry_after_base_s = float(retry_after_base_s)
        self.faults = faults if faults is not None else NO_FAULTS
        self.level = 0
        self.last_pressure = 0.0
        self.last_signals: Dict[str, float] = {}
        self.n_transitions = 0
        self.n_tick_errors = 0       # controller-site crashes swallowed
        # (tick index, old level, new level, pressure) — bounded history
        self.transition_log: List[Tuple[int, int, int, float]] = []
        self._tick_n = 0
        self._hi = 0
        self._lo = 0
        self._last_transition_tick = -10 ** 9
        self._last_tick_t = -math.inf
        self._forced: Optional[str] = None   # "stuck" | "flap" (injected)
        self._retry_salt = 0
        if metrics is not None and hasattr(metrics, "brownout_level"):
            metrics.brownout_level.set(0)
        attach = getattr(engine, "attach_overload", None)
        if attach is not None:
            attach(self)

    # -- pressure -----------------------------------------------------------
    def measure(self) -> Dict[str, float]:
        """One deterministic snapshot of the pressure signals, each
        normalized so 1.0 means 'at the limit'. The composite is their max
        — any single saturated resource is enough to climb the ladder."""
        sched = self.engine.scheduler
        cache = self.engine.cache
        usable = max(1, cache.num_pages - 1)
        pool = 1.0 - cache.n_available_pages / usable
        qref = self.queue_ref
        if qref is None:
            qref = sched.max_waiting if sched.max_waiting else \
                4 * sched.max_batch
        queue = len(sched.waiting) / max(1, qref)
        # preemption churn per step since the last measure: >= 1 means the
        # pool is thrashing (every step evicts someone)
        st = self.engine.stats()
        d_pre = st["preemptions"] - getattr(self, "_seen_pre", 0)
        d_steps = st["steps"] - getattr(self, "_seen_steps", 0)
        self._seen_pre, self._seen_steps = st["preemptions"], st["steps"]
        preempt = min(1.0, d_pre / d_steps) if d_steps > 0 else 0.0
        sig = {"pool": min(1.0, max(0.0, pool)),
               "queue": min(1.0, queue),
               "preempt": preempt}
        if self.metrics is not None:
            if self.ttft_slo_s:
                p99 = self.metrics.ttft.percentile(0.99)
                if p99 is not None:
                    sig["ttft"] = min(1.0, (p99 / self.ttft_slo_s) / 2.0)
            if self.itl_slo_s:
                p99 = self.metrics.itl.percentile(0.99)
                if p99 is not None:
                    sig["itl"] = min(1.0, (p99 / self.itl_slo_s) / 2.0)
        sig["composite"] = max(v for k, v in sig.items())
        return sig

    # -- the control loop ---------------------------------------------------
    def tick(self, now: Optional[float] = None) -> Optional[int]:
        """One control iteration (engine thread only): measure pressure,
        advance the hysteresis counters, maybe transition one level, and
        (re-)apply the current level's knobs to the engine. Returns the new
        level on a transition, else None. Rate-limited to one evaluation
        per ``interval_s`` (pass 0 for direct-drive harnesses)."""
        now = time.monotonic() if now is None else now
        if now - self._last_tick_t < self.interval_s:
            return None
        self._last_tick_t = now
        try:
            if self.faults.armed:
                self.faults.fire("controller")
        except InjectedControlFault as e:
            self._forced = e.mode
        except InjectedFault:
            # a crashed controller must never take the engine loop down —
            # fail safe by holding the current level this tick
            self.n_tick_errors += 1
            return None
        self._tick_n += 1
        sig = self.measure()
        p = sig["composite"]
        if self._forced == "stuck":
            p = 1.0
        elif self._forced == "flap":
            p = 1.0 if self._tick_n % 2 == 0 else 0.0
        self.last_pressure = p
        self.last_signals = sig
        if p >= self.up:
            self._hi += 1
            self._lo = 0
        elif p <= self.down:
            self._lo += 1
            self._hi = 0
        else:
            self._hi = self._lo = 0        # dead band: hold
        changed = None
        dwell_ok = (self._tick_n - self._last_transition_tick
                    >= self.min_dwell_ticks)
        if dwell_ok and self._hi >= self.up_ticks \
                and self.level < len(self.ladder) - 1:
            changed = self._transition(self.level + 1, p)
        elif dwell_ok and self._lo >= self.down_ticks and self.level > 0:
            changed = self._transition(self.level - 1, p)
        self.apply_to(self.engine)
        return changed

    def _transition(self, new_level: int, pressure: float) -> int:
        old = self.level
        self.level = new_level
        self.n_transitions += 1
        self._last_transition_tick = self._tick_n
        self._hi = self._lo = 0
        if len(self.transition_log) < 4096:
            self.transition_log.append((self._tick_n, old, new_level,
                                        round(pressure, 4)))
        m = self.metrics
        if m is not None and hasattr(m, "brownout_level"):
            m.brownout_level.set(new_level)
            m.brownout_transitions.inc()
        return new_level

    def apply_to(self, engine) -> None:
        """Install the current level's knobs on ``engine`` (idempotent,
        engine thread only). Split from ``tick`` so the supervisor can
        re-apply the inherited level to a freshly rebuilt incarnation
        before it dispatches anything."""
        lv = self.ladder[self.level]
        sched = engine.scheduler
        cache = engine.cache
        if lv.horizon_frac >= 1.0:
            sched.horizon_cap = None
        else:
            sched.horizon_cap = max(
                1, int(sched.decode_horizon * lv.horizon_frac))
        if lv.wave_frac >= 1.0:
            sched.max_wave_segments = None
        else:
            sched.max_wave_segments = max(
                1, int(sched.max_batch * lv.wave_frac))
        sched.shed_classes = frozenset(lv.shed)
        if lv.lru_frac < 1.0:
            usable = max(1, cache.num_pages - 1)
            cache.shrink_lru(int(lv.lru_frac * usable))

    # -- shedding -----------------------------------------------------------
    def retry_after(self) -> int:
        """Load-derived Retry-After seconds for the next rejection. Each
        call advances the jitter salt so consecutive rejections spread."""
        self._retry_salt += 1
        return compute_retry_after(self.retry_after_base_s,
                                   pressure=self.last_pressure,
                                   level=self.level,
                                   salt=self._retry_salt)

    # -- introspection ------------------------------------------------------
    def status(self) -> Dict[str, object]:
        return {
            "brownout_level": self.level,
            "brownout_action": self.ladder[self.level].describe(),
            "pressure": round(self.last_pressure, 4),
            "signals": {k: round(v, 4)
                        for k, v in self.last_signals.items()},
            "transitions": self.n_transitions,
            "tick_errors": self.n_tick_errors,
        }

    def __repr__(self):
        return (f"OverloadController(level={self.level}, "
                f"pressure={self.last_pressure:.3f}, "
                f"transitions={self.n_transitions})")
