"""Pieces a driver shares: the program's set-up from the seed, the
traced slice of the window, and the check's bookkeeping."""
from __future__ import annotations

import gc
import time

import numpy as np

from . import program, weights
from .trace import Tracer


class Setup:
    """Kernels built, raw weights drawn from the seed on the device, and
    the port's quantization of them (its DP on the card): set-up's share
    before the engine."""

    def __init__(self, ctx):
        torch, dev, cfg = ctx.torch, ctx.device, ctx.config
        self.port = program.port()
        self.build_s = program.build_kernels(dev)
        t0 = time.monotonic()
        self.raw = weights.make(torch, cfg, ctx.seed, dev)
        self.weights_s = time.monotonic() - t0
        t0 = time.monotonic()
        self.qtree = program.quantize(cfg, self.raw, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        self.quantize_s = time.monotonic() - t0
        from repro_torch.models import Model
        self.model = Model(program.model_config(torch, cfg))
        self.vocab_padded = weights.vocab_padded(cfg)


class Slice:
    """The traced part of the window (``--trace 1`` only): the profiler
    starts ``start`` seconds after the window opened and records for
    ``length`` seconds from the moment it is running. Set-up starts and
    stops it once beforehand, so its first start (CUPTI's) is paid
    there."""

    def __init__(self, ctx, start, length):
        self.on = bool(ctx.trace)
        self.tracer = Tracer(ctx.torch) if self.on else None
        self.start, self.length, self.end = start, length, None
        self.state = "before"
        if self.on:
            self.tracer.start()
            self.tracer.stop()

    def span(self, name):
        if self.state == "in":
            return self.tracer.record(name)
        return _NULL

    def tick(self, elapsed):
        """Start or stop the profiler at ``elapsed()`` seconds into the
        window; True while it runs."""
        if not self.on:
            return False
        if self.state == "before" and elapsed() >= self.start:
            self.tracer.start()
            self.end = elapsed() + self.length
            self.state = "in"
        elif self.state == "in" and elapsed() >= self.end:
            self.tracer.stop()
            self.state = "after"
        return self.state == "in"

    def close(self):
        if self.state == "in":
            self.tracer.stop()
            self.state = "after"
        return self.tracer.summary() if self.state == "after" else None


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _Null()


def p95(values):
    if not len(values):
        raise ValueError("no samples in the window for a 95th percentile")
    return float(np.percentile(np.asarray(values, np.float64), 95))


def memory_peak(torch, dev):
    return int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def free(torch, dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
