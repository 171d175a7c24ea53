"""Fault-tolerance utilities: preemption capture + straggler monitoring
(port of ``repro.train.fault`` by copy; stdlib only).

Production mapping (documented for the 1000+-node deployment):
  * PreemptionHandler — SIGTERM/SIGINT from the cluster scheduler sets a
    flag the train loop polls; the loop checkpoints and exits cleanly. On
    TPU pods the same hook is driven by the maintenance-event notification.
  * StragglerMonitor — per-step wall-time ring buffer; a host whose step
    time exceeds ``threshold`` x running median is flagged. In multi-host
    deployments the flags are aggregated through a tiny all-gather each
    ``report_every`` steps and the controller can evict/replace the host
    (restart-from-checkpoint covers the membership change — the elastic
    restore path reshards to the new mesh).
"""
from __future__ import annotations

import collections
import signal
import statistics
import threading


class PreemptionHandler:
    """Installs signal handlers; ``should_stop()`` is loop-pollable."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._stop = threading.Event()
        self._prev = {}
        for sig in signals:
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # non-main thread (tests)
                pass

    def _handler(self, signum, frame):
        self._stop.set()

    def should_stop(self):
        return self._stop.is_set()

    def trigger(self):  # for tests / manual drain
        self._stop.set()

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)


class StragglerMonitor:
    def __init__(self, window=50, threshold=2.0):
        self.window = window
        self.threshold = threshold
        self.times = collections.deque(maxlen=window)
        self.flagged = []

    def record(self, step, dt):
        if len(self.times) >= 10:
            med = statistics.median(self.times)
            if dt > self.threshold * med:
                self.flagged.append((step, dt, med))
        self.times.append(dt)

    @property
    def median(self):
        return statistics.median(self.times) if self.times else 0.0
