"""The traced slice of a run: torch.profiler over the card, read back.

``Tracer`` profiles CPU and CUDA activity over a slice of the measured
window; the harness marks its own host spans with ``record_function``
(``bench.window`` around the slice, ``bench.step``, ``bench.drain``,
``bench.submit``). ``summary`` reads the profiler's
events once: every device activity (kernels, copies, fills), the host
spans and the CUDA runtime calls, all on the profiler's one clock.
From them: the device's busy seconds (the union of its activity inside
the slice), device seconds by kernel name, the idle gaps labelled by
what the host was doing at each gap's midpoint, the host's seconds in
``cudaGraphLaunch``, and the device seconds by name of each engine step.
"""
from __future__ import annotations

import bisect

HOST_LABELS = {
    "cudaGraphLaunch": "dispatch: cudaGraphLaunch",
    "cudaStreamSynchronize": "sync: wait for the device",
    "cudaDeviceSynchronize": "sync: wait for the device",
    "cudaEventSynchronize": "sync: wait for the device",
    "cudaMemcpyAsync": "sync: copy to the host",
    "cudaMemcpy": "sync: copy to the host",
    "cudaLaunchKernel": "launch: eager kernel",
    "cudaLaunchKernelExC": "launch: eager kernel",
    "cuLaunchKernel": "launch: eager kernel",
    "cuLaunchKernelEx": "launch: eager kernel",
    "bench.step": "step: scheduler and host bookkeeping",
    "bench.drain": "stream drain",
    "bench.submit": "submit",
}


def _raw_events(prof):
    """(name, is_device, start_us, end_us) of every profiled event."""
    out = []
    try:
        evs = prof.profiler.kineto_results.events()
        for e in evs:
            name = e.name()
            dev = "CUDA" in str(e.device_type())
            if hasattr(e, "start_ns"):
                t0, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
            else:
                t0, dur = float(e.start_us()), float(e.duration_us())
            out.append((name, dev, t0, t0 + dur))
        if out:
            return out
    except Exception:       # an older or newer profiler: the slow path
        out = []
    for e in prof.events():
        dev = "CUDA" in str(e.device_type)
        out.append((e.name, dev, float(e.time_range.start),
                    float(e.time_range.end)))
    return out


class Tracer:
    def __init__(self, torch):
        self.torch = torch
        self.prof = None
        self.span = None

    def start(self):
        prof_mod = self.torch.profiler
        acts = [prof_mod.ProfilerActivity.CPU]
        if self.torch.cuda.is_available():
            acts.append(prof_mod.ProfilerActivity.CUDA)
        self.prof = prof_mod.profile(activities=acts)
        self.prof.__enter__()
        self.span = prof_mod.record_function("bench.window")
        self.span.__enter__()

    def stop(self):
        if self.torch.cuda.is_available():
            self.torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)

    def record(self, name):
        return self.torch.profiler.record_function(name)

    def summary(self):
        return summarize(_raw_events(self.prof))


def summarize(events):
    """Busy and idle time, device seconds by name and the host's time in
    graph launches, from (name, is_device, start_us, end_us) events."""
    win = [e for e in events if e[0] == "bench.window" and not e[1]]
    if not win:
        return None
    w0, w1 = win[0][2], win[0][3]
    dev = sorted((max(t0, w0), min(t1, w1), name)
                 for name, is_dev, t0, t1 in events
                 if is_dev and not name.startswith("bench.")
                 and t1 > w0 and t0 < w1)
    by_name = {}
    for t0, t1, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e6
    busy, gaps, cur0, cur1 = 0.0, [], None, None
    last = w0
    for t0, t1, _ in dev:
        if cur1 is None or t0 > cur1:
            if cur1 is not None:
                busy += cur1 - cur0
            if t0 > last:
                gaps.append((last, t0))
            cur0, cur1 = t0, t1
        else:
            cur1 = max(cur1, t1)
        last = max(last, cur1)
    if cur1 is not None:
        busy += cur1 - cur0
    if w1 > last:
        gaps.append((last, w1))
    host = sorted((t0, t1, name) for name, is_dev, t0, t1 in events
                  if not is_dev and name in HOST_LABELS)
    starts = [h[0] for h in host]
    idle = {}
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        label, width = "benchmark loop", float("inf")
        i = bisect.bisect_right(starts, mid)
        for t0, t1, name in reversed(host[max(0, i - 64):i]):
            if t1 >= mid and t1 - t0 < width:
                label, width = HOST_LABELS[name], t1 - t0
        idle[label] = idle.get(label, 0.0) + (g1 - g0) / 1e6
    launch = sum(t1 - t0 for t0, t1, name in host
                 if name == "cudaGraphLaunch") / 1e6
    by_step, outside = _by_step(events, dev)
    return {"window_s": (w1 - w0) / 1e6, "busy_s": busy / 1e6,
            "by_name": by_name, "idle": idle, "graph_launch_s": launch,
            "graph_launches": sum(1 for h in host if h[2] == "cudaGraphLaunch"),
            "by_step": by_step, "outside_steps_s": outside}


def _by_step(events, dev):
    """Device seconds by name of each ``bench.step`` span, in order: an
    activity belongs to the span that holds its midpoint (every engine
    step ends by reading its results back, so its work runs inside it).
    Also the device seconds that fall in no step."""
    spans = sorted((t0, t1) for name, is_dev, t0, t1 in events
                   if not is_dev and name == "bench.step")
    starts = [s[0] for s in spans]
    out, outside = [{} for _ in spans], 0.0
    for t0, t1, name in dev:
        mid = 0.5 * (t0 + t1)
        i = bisect.bisect_right(starts, mid) - 1
        if i >= 0 and mid <= spans[i][1]:
            out[i][name] = out[i].get(name, 0.0) + (t1 - t0) / 1e6
        else:
            outside += (t1 - t0) / 1e6
    return out, outside


def kernel_seconds(by_name, patterns):
    """Device seconds of every kernel in ``by_name`` whose name holds one
    of ``patterns``."""
    return sum(s for name, s in by_name.items()
               if any(p in name for p in patterns))


def breakdown(summary, top=10):
    ops = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(summary["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in gaps]}
