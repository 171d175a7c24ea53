"""Warm-up of the port's ContinuousEngine (serve/warmup.py over the dispatch
set of serve/graphs.py) against the reference's (repro.serve.warmup), on
the CPU, where a dispatch runs eagerly and its key's first dispatch counts
as its capture: the same reachable dispatch set, the probe's contract (no
capture after warm-up), all-pad dummy dispatches that write only the
scratch page and hot row, and greedy tokens after warm-up identical to the
reference engine's on fp32 smoke params."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import QuantPolicy
from repro.core import quantize_params as j_quantize_params
from repro.models import Model as JModel
from repro.serve import ContinuousEngine as JEngine
from repro.serve.warmup import enumerate_traces as j_enumerate
from repro.serve.warmup import warm_engine as j_warm_engine
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.models import Model as TModel
from repro_torch.serve import ContinuousEngine as TEngine
from repro_torch.serve import enumerate_traces, jit_trace_count
from repro_torch.serve.graphs import input_shapes, pad_inputs

ENGINE = dict(max_batch=4, page_size=4, num_pages=64, max_seq=40,
              prefill_chunk=6)

# argument names of the reference's dispatch callables after (pools,
# params), as ``repro.serve.warmup._warm_one`` passes them
J_ARGS = {
    "prefill_packed": ("_prefill_fn", ("tokens", "seg_ids", "q_pos",
                                       "kv_lens", "bt", "slots", "last_idx",
                                       "seg_off")),
    "prefill": ("_step_fn", ("tokens", "q_pos", "kv_lens", "bt", "slots")),
    "decode": ("_step_fn", ("tokens", "q_pos", "kv_lens", "bt", "slots")),
    "decode_horizon": ("_horizon_fn", ("tokens", "start_pos", "n_left",
                                       "eos", "bt", "slots")),
}


def _cfg(smoke):
    return dataclasses.replace(smoke("internlm2-1.8b"), vocab_size=64,
                               vocab_round=64)


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 64, int(n)).astype(np.int32)
            for n in (5, 13, 3, 9)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, which only slow
    the other test workers down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    """Reference fp32 smoke params, 4-bit quantized, and the reference
    engine's greedy tokens at kv 16 and 4 (decode_horizon 8)."""
    jm = JModel(_cfg(j_smoke))
    params = jm.init(jax.random.PRNGKey(0))
    qparams, _ = j_quantize_params(params, QuantPolicy(
        bits=4, block=64, solver="dp", min_size=1024))
    ref = {}
    for bits in (16, 4):
        eng = JEngine(jm, qparams, execution="packed", decode_horizon=8,
                      kv_bits=bits, **ENGINE)
        rids = [eng.submit(p, 8) for p in _prompts()]
        out = eng.run()
        ref[bits] = [out[r] for r in rids]
    return TModel(_cfg(t_smoke)), from_reference(qparams, "cpu"), ref


@pytest.mark.parametrize("max_batch", [1, 5, 8])
@pytest.mark.parametrize("horizon", [1, 8])
@pytest.mark.parametrize("packing", [True, False])
def test_enumerate_traces_matches_reference(packing, horizon, max_batch):
    """The same reachable dispatch set, and for each entry the same all-pad
    dummy inputs and scratch block table as the reference's warm-up passes
    its jitted callables (recorded by stand-ins for them)."""
    kw = dict(max_batch=max_batch, page_size=4, num_pages=16,
              prefill_chunk=4, decode_horizon=horizon,
              prefill_packing=packing)
    j_eng = JEngine(JModel(_cfg(j_smoke)), {}, execution="simulated", **kw)
    t_eng = TEngine(TModel(_cfg(t_smoke)), {}, execution="simulated",
                    device="cpu", **kw)
    entries = enumerate_traces(t_eng)
    assert entries == j_enumerate(j_eng)
    calls = []

    def stand_in(name):
        def fn(pools, params, *args):
            calls.append((name, [np.asarray(a) for a in args]))
            out = np.zeros(1)
            return (out, out, pools) if name == "_horizon_fn" else (out,
                                                                    pools)
        return fn

    for name in ("_prefill_fn", "_step_fn", "_horizon_fn"):
        setattr(j_eng, name, stand_in(name))
    assert j_warm_engine(j_eng)["shapes"] == entries
    for (kind, size), (name, args) in zip(entries, calls):
        want_name, names = J_ARGS[kind]
        assert name == want_name
        rows, shapes = input_shapes(kind, size, max_batch)
        slots, pads = pad_inputs(kind, size, max_batch)
        assert set(pads) == set(shapes) == set(names) - {"bt"}
        ref = dict(zip(names, args))
        np.testing.assert_array_equal(
            t_eng.cache.table_rows(slots).numpy(), ref.pop("bt"))
        for n, a in ref.items():
            assert pads[n].shape == shapes[n] == a.shape, (kind, n)
            np.testing.assert_array_equal(pads[n], a, err_msg=f"{kind} {n}")


def test_warmup_then_zero_new_captures(setup, rng):
    """The port of tests/test_packed_prefill.py's warm-up test: after
    warmup() every reachable dispatch shape is captured, and a mixed
    serving run (packed prefill waves, decode-horizon buckets, a prompt
    longer than the largest bucket) captures nothing."""
    model, params, _ = setup
    eng = TEngine(model, params, max_batch=4, page_size=4, num_pages=64,
                  max_seq=48, prefill_chunk=4, decode_horizon=8,
                  prefix_cache=False, device="cpu")
    report = eng.warmup()
    # 3 prefill buckets + decode-horizon batch buckets (1, 2, 4)
    assert report["entries"] == 6 and report["traces"] == 6
    assert report["shapes"] == [("prefill_packed", 4), ("prefill_packed", 8),
                                ("prefill_packed", 16), ("decode_horizon", 1),
                                ("decode_horizon", 2), ("decode_horizon", 4)]
    assert report["graph_bytes"] is None            # no graph on the CPU
    assert eng.stats()["warmup_traces"] == 6
    assert eng.stats()["warmup_seconds"] > 0
    assert eng.graphs.keys == report["shapes"]
    n0 = jit_trace_count()
    requests = [(rng.integers(0, 64, (int(n),)).astype(np.int32), 9)
                for n in (3, 7, 20, 11)]
    rids = [eng.submit(p, n) for p, n in requests]
    out = eng.run()
    assert sorted(out) == sorted(rids)
    assert jit_trace_count() == n0, "steady-state serving captured"
    again = eng.warmup()                # every entry captured already
    assert again["traces"] == 0 and eng.stats()["warmup_traces"] == 12
    eng.close()
    assert eng.graphs.keys == []                    # close drops the set


def _randomize(pools, gen):
    """Fill every pool leaf, in place, with random bytes of its type."""
    for slot in pools["layers"].values():
        for leaf in slot["attn"].values():
            if leaf.is_floating_point():
                leaf.copy_(torch.randn(leaf.shape, generator=gen))
            else:
                leaf.copy_(torch.randint(-128, 128, leaf.shape, generator=gen,
                                         dtype=torch.int32).to(leaf.dtype))


@pytest.mark.parametrize("packing", [True, False])
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_warmup_writes_only_scratch(setup, bits, packing):
    """The all-pad dummy dispatches of warm-up write scratch page 0 (and
    hot row 0 of quantized pools) and not one other byte, whatever the
    pools held."""
    model, params, _ = setup
    eng = TEngine(model, params, decode_horizon=4, kv_bits=bits,
                  prefill_packing=packing, device="cpu", **ENGINE)
    _randomize(eng.cache.pools, torch.Generator().manual_seed(bits))
    before = {(s, n): leaf.clone()
              for s, slot in eng.cache.pools["layers"].items()
              for n, leaf in slot["attn"].items()}
    report = eng.warmup()
    # 3 prefill buckets (or the one chunk shape) + decode buckets 1, 2, 4
    assert report["traces"] == report["entries"] == (6 if packing else 4)
    for (s, n), old in before.items():
        new = eng.cache.pools["layers"][s]["attn"][n]
        # leaves are (n_periods, page or hot row, ...): index 0 is scratch
        assert torch.equal(new[:, 1:], old[:, 1:]), f"{s}/{n} written"
    eng.close()


@pytest.mark.parametrize("horizon", [1, 8])
@pytest.mark.parametrize("bits", [16, 4])
def test_tokens_after_warmup_match_reference(setup, bits, horizon):
    model, params, ref = setup
    eng = TEngine(model, params, decode_horizon=horizon, kv_bits=bits,
                  device="cpu", **ENGINE)
    eng.warmup()
    n0 = jit_trace_count()
    rids = [eng.submit(p, 8) for p in _prompts()]
    out = eng.run()
    assert jit_trace_count() == n0
    for rid, expect in zip(rids, ref[bits]):
        np.testing.assert_array_equal(out[rid], expect)
    eng.close(check=True)
