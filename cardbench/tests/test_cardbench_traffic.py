"""The traffic generator: every seed offers the same requests in the same
order, the pools follow the stated lognormals, clipped, whose means are
the cited source's, and the ramp starts the loop length-biased."""
import json
import math

import numpy as np
import pytest

from cardbench import manifest, traffic_gen

MIXES = {p.stem: json.loads(p.read_text())
         for p in (manifest.HERE / "traffic").glob("*.json")}
LOOPS = [k for k, v in MIXES.items() if v["driver"] == "closed_loop"]


@pytest.mark.parametrize("mix", LOOPS)
def test_pool_draws_the_stated_lognormals(mix):
    tr = MIXES[mix]
    prompts, outs = traffic_gen.size_pool(tr)
    for vals, spec in ((prompts, tr["prompt"]), (outs, tr["output"])):
        assert vals.min() >= spec["min"] and vals.max() <= spec["max"]
        assert abs(np.median(vals) - spec["median"]) <= 0.02 * spec["median"]
        inner = vals[(vals > spec["min"]) & (vals < spec["max"])]
        # the quartiles of a lognormal: median * exp(+-0.6745 sigma)
        q1, q3 = np.quantile(vals, [0.25, 0.75])
        want = math.exp(0.6745 * spec["sigma"])
        assert abs(q3 / spec["median"] - want) < 0.03 * want
        assert abs(spec["median"] / q1 - want) < 0.03 * want
        assert len(inner) > 0.5 * len(vals)


@pytest.mark.parametrize("mix", LOOPS)
def test_order_offers_the_whole_pool(mix):
    tr = MIXES[mix]
    a = traffic_gen.order(tr)
    assert sorted(a.tolist()) == list(range(tr["pool"]))
    assert (a == traffic_gen.order(tr)).all()
    assert (a != np.arange(tr["pool"])).any()


def test_tokens_are_deterministic_and_in_range():
    big = 2 ** 31 + 12345
    t1 = traffic_gen.tokens(big, 5, 4000, 92544)
    assert (t1 == traffic_gen.tokens(big, 5, 4000, 92544)).all()
    assert not (t1 == traffic_gen.tokens(big, 6, 4000, 92544)).all()
    assert t1.dtype == np.int32 and t1.min() >= 0 and t1.max() < 92544
    # uniform: each tenth of the vocabulary gets about a tenth
    hist = np.bincount(t1 // 9255, minlength=10)
    assert hist.min() > 300


@pytest.mark.parametrize("mix", LOOPS)
def test_pool_keeps_the_cited_means(mix):
    """Each mix names its source and the means it was fitted to; the
    pool's means are those, within 1 %."""
    tr = MIXES[mix]
    assert tr["source"] and tr["fit"]
    prompts, outs = traffic_gen.size_pool(tr)
    means = tr["source_means"]
    assert prompts.mean() == pytest.approx(means["prompt"], rel=0.01)
    assert outs.mean() == pytest.approx(means["output"], rel=0.01)


@pytest.mark.parametrize("mix", LOOPS)
def test_ramp_is_length_biased_and_fixed(mix):
    tr = MIXES[mix]
    picks, fractions = traffic_gen.ramp(tr)
    again = traffic_gen.ramp(tr)
    assert (picks == again[0]).all() and (fractions == again[1]).all()
    s = tr["sessions"]
    assert len(picks) == s and set(picks.tolist()) <= set(range(tr["pool"]))
    assert sorted(fractions * s - 0.5) == pytest.approx(range(s))
    _, outs = traffic_gen.size_pool(tr)
    # length-biased: the picks' mean answer is the pool's E[L^2] / E[L]
    want = (outs.astype(float) ** 2).mean() / outs.mean()
    assert outs[picks].mean() == pytest.approx(want, rel=0.1)
    assert outs[picks].mean() > 1.3 * outs.mean()
