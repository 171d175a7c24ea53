"""Shared arithmetic of the per-layer metric readers (``metrics/*.py``).

A reader gets the run's record: ``kind`` (the driver's: "serve" for
the closed loop), the configuration, the padded vocabulary, the trace
``summary`` (None when nothing was traced) and the driver's own
bookkeeping: every window step (kind, host seconds, the (c0, c1)
position range each row computed, whether it ran inside the traced
slice) and the position counts.

``launches`` turns the traced serving steps into the forwards they ran:
a decode dispatch of horizon H is up to H forwards (inner step j holds
the rows that delivered more than j tokens, row i at context c0_i + j +
1); a prefill wave is one forward over its segments' tokens, each
position p attending p + 1 keys, with one logits row a segment.
``roofline`` reads the work of the steps of one kind (a decode or a
prefill) against the device time of the kernels that ran inside those
steps' spans, so a kernel that leaves one kind of step leaves that
kind's share silent.
"""
from __future__ import annotations

from . import cost
from .trace import kernel_seconds


def traced(rec):
    return [s for s in rec["steps"] if s["traced"]]


def launches(rec, kind=""):
    """(contexts, logit_rows, segments) of each forward the traced serving
    steps whose kind starts with ``kind`` ran; ``segments`` are a prefill
    wave's (c0, c1) rows, empty for a decode forward."""
    out = []
    for s in traced(rec):
        rows = s["rows"]
        if not rows or not s["kind"].startswith(kind):
            continue
        if s["kind"].startswith("decode"):
            ks = [c1 - c0 for c0, c1 in rows]
            for j in range(max(ks)):
                ctx = [c0 + j + 1 for (c0, _), k in zip(rows, ks) if k > j]
                out.append((ctx, len(ctx), []))
        else:
            ctx = [p + 1 for c0, c1 in rows for p in range(c0, c1)]
            out.append((ctx, len(rows), list(rows)))
    return out


def share(least_s, kernel_s):
    """A roofline share in %, or None where nothing ran."""
    if kernel_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / kernel_s


def step_kernel_seconds(rec, patterns, kind):
    """Device seconds of the kernels matching ``patterns`` inside the
    spans of the traced steps whose kind starts with ``kind``, or None
    where the trace's step spans do not line up with the traced steps."""
    steps, spans = traced(rec), rec["summary"].get("by_step")
    if spans is None or len(spans) != len(steps):
        return None
    return sum(kernel_seconds(by_name, patterns)
               for st, by_name in zip(steps, spans)
               if st["kind"].startswith(kind))


def roofline(rec, patterns, work, kind=""):
    """A kernel's share of its roofline over the traced steps whose kind
    starts with ``kind`` (all steps for ""): the least seconds of the
    work ``work(contexts, logit_rows, segments)`` -> [(flops, bytes),
    ...] summed over their forwards, over the device seconds of the
    kernels whose names hold one of ``patterns`` inside those steps."""
    summ = rec.get("summary")
    if summ is None:
        return None
    least = sum(cost.least_seconds(f, b)
                for ctx, lr, segs in launches(rec, kind)
                for f, b in work(ctx, lr, segs))
    if kind:
        kernel_s = step_kernel_seconds(rec, patterns, kind)
        if kernel_s is None:
            return None
    else:
        kernel_s = kernel_seconds(summ["by_name"], patterns)
    return share(least, kernel_s)


def idle_share(rec):
    summ = rec.get("summary")
    if summ is None or summ["window_s"] <= 0 or summ["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - summ["busy_s"] / summ["window_s"])


def mfu(rec):
    """Model FLOPs of the traced slice over its seconds at the bf16 peak,
    in %."""
    summ = rec.get("summary")
    if summ is None or summ["window_s"] <= 0 or summ["busy_s"] <= 0:
        return None
    cfg, vp = rec["config"], rec["vocab_padded"]
    fl = sum(cost.model_flops(cfg, ctx, lr, vp)
             for ctx, lr, _ in launches(rec))
    if fl <= 0:
        return None
    return 100.0 * fl / (summ["window_s"] * cost.PEAK_FLOPS)


def dispatch_ms(rec, prefix):
    """Mean host milliseconds of the untraced window steps whose kind
    starts with ``prefix``."""
    dts = [s["dt"] for s in rec["steps"]
           if s["kind"].startswith(prefix) and not s["traced"]]
    return 1e3 * sum(dts) / len(dts) if dts else None
