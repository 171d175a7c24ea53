"""Deterministic synthetic data pipeline (no external datasets offline).

Port of ``repro.data.synthetic`` by copy: numpy only, so a seed gives the
reference's batches bit for bit. Two sources:
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

import queue
import threading

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
        logits = rng.standard_normal((vocab, vocab)) / concentration
        logits -= logits.max(axis=1, keepdims=True)
        p = np.exp(logits)
        self.trans = p / p.sum(axis=1, keepdims=True)
        self.cum = np.cumsum(self.trans, axis=1)

    def batch(self, step):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, 7, step, self.host]))
        b, s = self.local_batch, self.seq + 1
        toks = np.empty((b, s), dtype=np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, b)
        u = rng.random((b, s))
        for t in range(1, s):
            toks[:, t] = np.argmax(
                self.cum[toks[:, t - 1]] > u[:, t:t + 1], axis=1)
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
        self._stop = True
