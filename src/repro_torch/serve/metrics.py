"""Prometheus-text-format metrics for the serving front door (port of
``repro.serve.metrics`` by copy; the trace probe it exports,
``msb_traces_compiled_total``, counts the continuous engine's CUDA-graph
captures here).

A tiny, dependency-free subset of the Prometheus client model — counters,
gauges and histograms with optional labels, rendered in text exposition
format 0.0.4 (the format every Prometheus/VictoriaMetrics/Grafana-agent
scraper speaks) — plus ``ServeMetrics``, the registry wired to the counters
the engine already exposes.

Design constraints, in order:

* **Hot-loop cheap.** ``observe``/``inc``/``set`` are a dict lookup and a
  float add; no locks (the engine step-loop thread is the only writer of
  engine-derived series, and scrape-time readers tolerate torn-but-recent
  values — each individual Python float read is atomic under the GIL).
* **Monotonic counters.** Prometheus ``rate()`` treats any decrease as a
  counter reset. ``Counter.inc`` rejects negative deltas and
  ``Counter.set_to`` (the bridge from the engine's own monotonic counters,
  e.g. ``n_decode_steps``) rejects regressions, so a wiring bug fails
  loudly here instead of silently corrupting dashboards.
* **Deterministic render.** Families render in registration order, children
  in sorted-label order, so the text output is stable enough to golden-test.

Timing semantics (used by ``lifecycle.RequestLifecycle``): TTFT is observed
once per request, at the arrival of the event carrying its first token —
chunked prefill just makes that event later. Inter-token latency observes
**one value per token-bearing arrival gap**, not per token: with
``decode_horizon=H`` the engine delivers up to H tokens per dispatch, and
recording H identical gaps would fabricate H-1 latencies no client ever
saw. The ITL histogram therefore measures the stall a streaming consumer
actually experiences between flushes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

# Prometheus-recommended latency buckets, extended down to 1ms: CPU smoke
# runs sit in the 1-50ms/token range, real accelerators below that.
LATENCY_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

_LABEL_ESC = str.maketrans({"\\": r"\\", '"': r"\"", "\n": r"\n"})


def _fmt(v: float) -> str:
    """Prometheus sample-value formatting: integers without the trailing
    ``.0``, infinities as ``+Inf``/``-Inf``."""
    if v == math.inf:
        return "+Inf"
    if v == -math.inf:
        return "-Inf"
    f = float(v)
    if f.is_integer():
        return str(int(f))
    return repr(f)


def _labelstr(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{str(v).translate(_LABEL_ESC)}"'
                     for k, v in labels)
    return "{" + inner + "}"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def _key(self, labels: Dict[str, str]):
        if set(labels) != set(self.labelnames):
            raise ValueError(f"{self.name}: expected labels "
                             f"{self.labelnames}, got {tuple(labels)}")
        return tuple((k, str(labels[k])) for k in self.labelnames)

    def _child(self, labels):
        key = self._key(labels)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = self._new_child()
        return child

    def render(self) -> List[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        for key in sorted(self._children):
            lines.extend(self._render_child(key, self._children[key]))
        return lines


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return [0.0]

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up "
                             f"(inc {amount})")
        self._child(labels)[0] += amount

    def set_to(self, value: float, **labels):
        """Ratchet to an externally-maintained monotonic value (the bridge
        from engine counters like ``n_decode_steps``); a regression is a
        wiring bug and raises."""
        child = self._child(labels)
        if value < child[0]:
            raise ValueError(f"{self.name}: monotonic counter cannot go "
                             f"from {child[0]} to {value}")
        child[0] = float(value)

    def value(self, **labels) -> float:
        return self._child(labels)[0]

    def _render_child(self, key, child):
        return [f"{self.name}{_labelstr(key)} {_fmt(child[0])}"]


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return [0.0]

    def set(self, value: float, **labels):
        self._child(labels)[0] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        self._child(labels)[0] += amount

    def dec(self, amount: float = 1.0, **labels):
        self._child(labels)[0] -= amount

    def value(self, **labels) -> float:
        return self._child(labels)[0]

    def _render_child(self, key, child):
        return [f"{self.name}{_labelstr(key)} {_fmt(child[0])}"]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help, labelnames=(),
                 buckets: Sequence[float] = LATENCY_BUCKETS):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"{name}: need at least one bucket")
        self.buckets = bs

    def _new_child(self):
        # per-bucket non-cumulative counts + [sum, count]
        return {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0,
                "count": 0}

    def observe(self, value: float, **labels):
        child = self._child(labels)
        i = len(self.buckets)
        for j, b in enumerate(self.buckets):    # ~13 buckets: linear is fine
            if value <= b:
                i = j
                break
        child["counts"][i] += 1
        child["sum"] += float(value)
        child["count"] += 1

    def count(self, **labels) -> int:
        return self._child(labels)["count"]

    def sum(self, **labels) -> float:
        return self._child(labels)["sum"]

    def percentile(self, q: float, **labels) -> Optional[float]:
        """Bucket-resolution percentile (upper bound of the bucket holding
        the q-quantile observation) — what a PromQL ``histogram_quantile``
        would report. None with no observations."""
        child = self._child(labels)
        if child["count"] == 0:
            return None
        rank = q * child["count"]
        cum = 0
        for j, b in enumerate(self.buckets):
            cum += child["counts"][j]
            if cum >= rank:
                return b
        return math.inf

    def _render_child(self, key, child):
        lines, cum = [], 0
        for j, b in enumerate(self.buckets):
            cum += child["counts"][j]
            lk = key + (("le", _fmt(b)),)
            lines.append(f"{self.name}_bucket{_labelstr(lk)} {cum}")
        cum += child["counts"][-1]
        lk = key + (("le", "+Inf"),)
        lines.append(f"{self.name}_bucket{_labelstr(lk)} {cum}")
        lines.append(f"{self.name}_sum{_labelstr(key)} {_fmt(child['sum'])}")
        lines.append(f"{self.name}_count{_labelstr(key)} {cum}")
        return lines


class Registry:
    """Ordered collection of metric families with one text renderer."""

    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _register(self, metric):
        if metric.name in self._metrics:
            raise ValueError(f"duplicate metric {metric.name}")
        self._metrics[metric.name] = metric
        return metric

    def counter(self, name, help, labelnames=()) -> Counter:
        return self._register(Counter(name, help, labelnames))

    def gauge(self, name, help, labelnames=()) -> Gauge:
        return self._register(Gauge(name, help, labelnames))

    def histogram(self, name, help, labelnames=(),
                  buckets=LATENCY_BUCKETS) -> Histogram:
        return self._register(Histogram(name, help, labelnames, buckets))

    def render(self) -> str:
        lines: List[str] = []
        for metric in self._metrics.values():
            lines.extend(metric.render())
        return "\n".join(lines) + "\n"


class ServeMetrics:
    """The serving front door's metric set, wired from the counters the
    engine/scheduler/cache already maintain plus the per-request timing the
    lifecycle layer records.

    Two write paths: the request path (``ttft``/``itl``/``requests``,
    written by ``RequestLifecycle`` as events happen) and ``sync_engine``,
    called by the engine step-loop each tick and at scrape time to ratchet
    the engine's own monotonic counters into Prometheus families. Both run
    on the engine-loop thread, so no locking."""

    def __init__(self, registry: Optional[Registry] = None):
        r = self.registry = registry or Registry()
        self.ttft = r.histogram(
            "msb_ttft_seconds",
            "Time from request acceptance to its first generated token")
        self.itl = r.histogram(
            "msb_inter_token_seconds",
            "Gap between consecutive token-bearing stream flushes of one "
            "request (one observation per gap, however many tokens a "
            "decode-horizon dispatch delivers at once)")
        self.queue_depth = r.gauge(
            "msb_queue_depth", "Requests waiting for admission")
        self.running = r.gauge(
            "msb_running_requests", "Requests holding a KV-cache slot")
        self.requests = r.counter(
            "msb_requests_total", "Completed API requests by outcome",
            labelnames=("outcome",))
        self.tokens = r.counter(
            "msb_tokens_generated_total", "Tokens sampled by the engine")
        self.dispatches = r.counter(
            "msb_dispatches_total", "Jitted device dispatches (any kind)")
        self.decode_dispatches = r.counter(
            "msb_decode_dispatches_total", "Decode dispatches (any horizon)")
        self.host_syncs = r.counter(
            "msb_host_syncs_total", "Blocking device-to-host transfers")
        self.preemptions = r.counter(
            "msb_preemptions_total",
            "Sequences evicted for recompute, by priority class",
            labelnames=("class",))
        self.aborts = r.counter(
            "msb_aborts_total", "Requests cancelled before finishing")
        self.prefix_hits = r.counter(
            "msb_prefix_hits_total",
            "Admissions that longest-prefix-matched the page registry")
        self.prefix_positions_saved = r.counter(
            "msb_prefix_positions_saved_total",
            "Token positions adopted from the prefix cache, not prefilled")
        self.prefix_hit_rate = r.gauge(
            "msb_prefix_hit_rate",
            "Fraction of admissions that hit the prefix cache")
        # packed prefill + AOT warmup (DESIGN.md Sec. 16)
        self.prefill_dispatches = r.counter(
            "msb_prefill_dispatches_total",
            "Prefill dispatches (packed waves count once, however many "
            "segments they carry)")
        self.prefill_segments = r.counter(
            "msb_prefill_segments_total",
            "Prompt segments prefetched across all prefill dispatches")
        self.admission_waves = r.counter(
            "msb_admission_waves_total",
            "Scheduler admission waves that admitted at least one request")
        self.packed_segments = r.histogram(
            "msb_prefill_packed_segments",
            "Segments per packed prefill dispatch",
            buckets=(1, 2, 4, 8, 16, 32))
        self.admission_depth = r.histogram(
            "msb_admission_queue_depth",
            "Waiting-queue depth at the start of each admission wave "
            "(one observation per wave, not per chunk)",
            buckets=(0, 1, 2, 4, 8, 16, 32, 64, 128))
        self.warmup_seconds = r.counter(
            "msb_warmup_seconds",
            "Wall time spent in warmup (CUDA-graph capture of the dispatch "
            "set), summed across engine incarnations")
        self.traces_compiled = r.counter(
            "msb_traces_compiled_total",
            "Process-wide dispatch-graph captures (the steady-state serving "
            "delta after warmup should be zero)")
        # supervision (DESIGN.md Sec. 14) — zero-valued until a supervised
        # engine syncs, so dashboards can alert on them unconditionally
        self.restarts = r.counter(
            "msb_engine_restarts_total",
            "Engine incarnations discarded and rebuilt after crash or hang")
        self.watchdog_trips = r.counter(
            "msb_watchdog_trips_total",
            "Steps abandoned for exceeding the watchdog deadline")
        self.replayed_tokens = r.counter(
            "msb_replayed_tokens_total",
            "Already-generated tokens re-admitted as prompt after recovery")
        self.quarantined = r.counter(
            "msb_quarantined_requests_total",
            "Requests failed for exhausting their crash-blame budget")
        self.detok_restarts = r.counter(
            "msb_detok_restarts_total",
            "Detokenize-thread deaths detected and restarted")
        self.recovery = r.histogram(
            "msb_recovery_seconds",
            "Wall time of one crash recovery (blame + rebuild), excluding "
            "replay re-prefill")
        # overload control plane (DESIGN.md Sec. 17)
        self.admissions = r.counter(
            "msb_admissions_total",
            "Requests admitted to a KV slot, by priority class",
            labelnames=("class",))
        self.sheds = r.counter(
            "msb_shed_total",
            "Requests turned away with 429, by priority class (written by "
            "the HTTP front door, not synced from the engine)",
            labelnames=("class",))
        self.brownout_level = r.gauge(
            "msb_brownout_level",
            "Current rung of the overload brownout ladder (0 = normal)")
        self.brownout_transitions = r.counter(
            "msb_brownout_transitions_total",
            "Brownout ladder level changes (either direction)")
        self.health = r.gauge(
            "msb_health_state",
            "One-hot server health (exactly one state is 1)",
            labelnames=("state",))
        for s in ("ok", "warming", "degraded", "draining", "dead"):
            self.health.set(1.0 if s == "ok" else 0.0, state=s)
        self._recovery_seen = 0       # recovery_log entries already observed

    def sync_engine(self, engine):
        """Ratchet engine counters and refresh gauges from the engine's
        ``stats()`` snapshot. Works identically for a raw
        ``ContinuousEngine`` and an ``EngineSupervisor`` — the supervisor
        aggregates counters across engine rebuilds (a fresh incarnation's
        counters restart at zero; feeding them here raw would trip the
        ``set_to`` monotonicity check) and adds the supervision families.
        Counters are monotonic by construction; ``set_to`` enforces it."""
        st = engine.stats()
        self.queue_depth.set(st["queue_depth"])
        self.running.set(st["running"])
        self.tokens.set_to(st["tokens_out"])
        self.dispatches.set_to(st["steps"])
        self.decode_dispatches.set_to(st["decode_steps"])
        self.host_syncs.set_to(st["host_syncs"])
        # per-class families ratchet from the engine's by-class dicts
        # (`class` is a keyword, hence the **{} spelling)
        for c, v in st.get("preemptions_by_class", {}).items():
            self.preemptions.set_to(v, **{"class": c})
        for c, v in st.get("admissions_by_class", {}).items():
            self.admissions.set_to(v, **{"class": c})
        self.aborts.set_to(st["aborts"])
        self.prefix_hits.set_to(st["prefix_hits"])
        self.prefix_positions_saved.set_to(st["prefix_positions_saved"])
        self.prefix_hit_rate.set(
            st["prefix_hits"] / max(st["admissions"], 1))
        if "prefill_dispatches" in st:
            self.prefill_dispatches.set_to(st["prefill_dispatches"])
            self.prefill_segments.set_to(st["prefill_segments"])
            self.admission_waves.set_to(st["admission_waves"])
            self.warmup_seconds.set_to(st["warmup_seconds"])
        # process-wide capture probe: it ratchets across sibling engines
        from .continuous import jit_trace_count
        self.traces_compiled.set_to(jit_trace_count())
        drain = getattr(engine, "drain_observations", None)
        if drain is not None:
            obs = drain()
            for d in obs.get("admission_queue_depth", ()):
                self.admission_depth.observe(d)
            for n in obs.get("packed_segments", ()):
                self.packed_segments.observe(n)
        if "restarts" in st:          # supervised engine
            self.restarts.set_to(st["restarts"])
            self.watchdog_trips.set_to(st["watchdog_trips"])
            self.replayed_tokens.set_to(st["replayed_tokens"])
            self.quarantined.set_to(st["quarantined"])
            for t in st["recovery_log"][self._recovery_seen:]:
                self.recovery.observe(t)
            self._recovery_seen = len(st["recovery_log"])
            self.set_health(st["health"])

    def set_health(self, state: str):
        for s in ("ok", "warming", "degraded", "draining", "dead"):
            self.health.set(1.0 if s == state else 0.0, state=s)

    def render(self) -> str:
        return self.registry.render()
