"""The one traffic generator: request sizes and token ids from a mix file.

Lengths come from a pool of ``pool`` (prompt, output) pairs: each
marginal is the lognormal's quantiles at (i + 1/2) / pool (median
``median``, shape ``sigma``, rounded and clipped to [min, max]), the two
paired by a fixed permutation, and the pool offered in a fixed order,
cycled. Every seed thus offers the same requests, of the same sizes, in
the same order: the work of a run does not depend on its seed, which
draws the token ids (uniformly over the real vocabulary) and, elsewhere,
the weights. ``ramp`` gives the sessions' first requests, drawn so the
loop starts as it runs in its steady state.
"""
from __future__ import annotations

import statistics

import numpy as np

PAIRING_SEED = 20240917
ORDER_SEED = 20241031
RAMP_SEED = 20250203


def quantiles(spec, n):
    dist = statistics.NormalDist()
    z = np.array([dist.inv_cdf((i + 0.5) / n) for i in range(n)])
    v = np.rint(spec["median"] * np.exp(spec["sigma"] * z))
    return np.clip(v, spec["min"], spec["max"]).astype(np.int64)


def size_pool(traffic):
    """(prompt lengths, output lengths), each (pool,), in the seed-free
    pairing."""
    n = traffic["pool"]
    prompts = quantiles(traffic["prompt"], n)
    outs = quantiles(traffic["output"], n)
    outs = outs[np.random.default_rng(PAIRING_SEED).permutation(n)]
    return prompts, outs


def order(traffic):
    """The order requests are offered in: indices into ``size_pool``."""
    return np.random.default_rng(ORDER_SEED).permutation(traffic["pool"])


def tokens(seed, index, length, vocab):
    """Token ids of request ``index`` (uniform over [0, vocab))."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 2, int(index)])
    return rng.integers(0, vocab, size=int(length), dtype=np.int64).astype(
        np.int32)


def ramp(traffic):
    """(pool indices, fractions) of the sessions' first requests. In a
    closed loop's steady state a session is found inside a request with
    odds in proportion to how long the request lasts, and part way
    through it. So the indices are drawn from the pool in its offered
    order weighted by output length, stratified at (j + 1/2) / sessions,
    and each first answer keeps a fraction (i + 1/2) / sessions of its
    length, the fractions in a fixed order unrelated to the lengths."""
    s = traffic["sessions"]
    _, outs = size_pool(traffic)
    idx = order(traffic)
    cum = np.cumsum(outs[idx].astype(np.float64))
    at = (np.arange(s) + 0.5) / s * cum[-1]
    picks = idx[np.searchsorted(cum, at)]
    fractions = (np.random.default_rng(RAMP_SEED).permutation(s) + 0.5) / s
    return picks, fractions
