"""Deterministic synthetic data pipeline (no external datasets offline).

Port of ``repro.data.synthetic``: numpy only, so a seed gives the
reference's tables and batches bit for bit (the chain's rows built on
threads, its sampler a bisection of each row). Two sources:
  * ``TokenStream`` — uniform-random tokens, fully deterministic in
    (seed, step, host): the dry-run/throughput workload.
  * ``MarkovStream`` — tokens from a fixed random Markov chain, so a model
    can actually *learn* (entropy-gap between chain and uniform). Used by
    the end-to-end example + quantization-quality benchmarks: eval loss on
    held-out Markov text measurably degrades when weights are quantized.

Batches are per-host shards of the global batch (shape (local_batch, seq)),
prefetched on a background thread.
"""
from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class TokenStream:
    def __init__(self, vocab, seq_len, global_batch, seed=0, host=0, n_hosts=1):
        assert global_batch % n_hosts == 0
        self.vocab, self.seq = vocab, seq_len
        self.local_batch = global_batch // n_hosts
        self.seed, self.host = seed, host

    def batch(self, step):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host]))
        toks = rng.integers(0, self.vocab,
                            (self.local_batch, self.seq + 1), dtype=np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class MarkovStream(TokenStream):
    """Order-1 Markov chain with temperature-controlled transition rows."""

    def __init__(self, vocab, seq_len, global_batch, seed=0, host=0,
                 n_hosts=1, concentration=0.05):
        super().__init__(vocab, seq_len, global_batch, seed, host, n_hosts)
        rng = np.random.default_rng(seed)
        # the reference's row-wise arithmetic, in place (two tables, not
        # five) and in blocks of rows on threads: the same bits
        self.trans = rng.standard_normal((vocab, vocab))
        self.cum = np.empty_like(self.trans)
        rows = [(lo, min(lo + self.ROWS, vocab))
                for lo in range(0, vocab, self.ROWS)]
        with ThreadPoolExecutor(min(len(rows), os.cpu_count() or 1)) as pool:
            list(pool.map(lambda r: self._rows(*r, concentration), rows))

    ROWS = 1024        # rows of the transition table a thread takes at once

    def _rows(self, lo, hi, concentration):
        x = self.trans[lo:hi]
        x /= concentration
        x -= x.max(axis=1, keepdims=True)
        np.exp(x, out=x)
        x /= x.sum(axis=1, keepdims=True)
        np.cumsum(x, axis=1, out=self.cum[lo:hi])

    def batch(self, step):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 7, step, self.host]))
        b, s = self.local_batch, self.seq + 1
        toks = np.empty((b, s), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        u = rng.random((b, s))
        # the reference's argmax(cum[prev] > u): the first token whose
        # cumulative probability exceeds u (0 where none does), found by
        # bisection of the nondecreasing row
        cum, v = self.cum, self.vocab
        for i in range(b):
            row, ui = toks[i], u[i]
            prev = int(row[0])
            for t in range(1, s):
                k = int(cum[prev].searchsorted(ui[t], side="right"))
                prev = k if k < v else 0
                row[t] = prev
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def entropy(self):
        """Per-token entropy of the chain (nats) — the loss floor."""
        stat = np.linalg.matrix_power(self.trans, 64)[0]
        h_rows = -(self.trans * np.log(self.trans + 1e-12)).sum(axis=1)
        return float((stat * h_rows).sum())


class Prefetcher:
    """Background-thread prefetch wrapper around any batch iterator."""

    def __init__(self, it, depth=2):
        self.q = queue.Queue(maxsize=depth)
        self.it = iter(it)
        self._stop = False
        self.t = threading.Thread(target=self._fill, daemon=True)
        self.t.start()

    def _fill(self):
        for item in self.it:
            if self._stop:
                return
            self.q.put(item)

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        """Stop filling. A fill thread blocked on the full queue is let
        through, so it stops and lets go of the iterator (and what the
        iterator holds: a chain's tables)."""
        self._stop = True
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
