"""``execution="simulated"`` in the port (serve/engine.py: QTensor leaves
kept and dequantized per call, ``torch.matmul`` for the product) against
the reference's simulated engines on fp32 smoke internlm2: greedy tokens
of ``ContinuousEngine`` (decode horizons 1 and 8) and ``ServeEngine``
identical to the reference's, ``score`` within 1e-5 relative, and the
port's simulated and packed engines token-identical at kv 16, 8 and 4."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.core import QuantPolicy
from repro.core import quantize_params as j_quantize_params
from repro.models import Model as JModel
from repro.serve import ContinuousEngine as JEngine
from repro.serve import ServeEngine as JServe
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.core.quantize import PackedQTensor, QTensor
from repro_torch.models import Model as TModel
from repro_torch.serve import ContinuousEngine as TEngine
from repro_torch.serve import ServeEngine as TServe
from repro_torch.serve import resolve_execution

ENGINE = dict(max_batch=4, page_size=4, num_pages=64, max_seq=40,
              prefill_chunk=6)
MAX_SEQ = 40


def _cfg(smoke):
    return dataclasses.replace(smoke("internlm2-1.8b"), vocab_size=64,
                               vocab_round=64)


def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 64, int(n)).astype(np.int32)
            for n in (4, 11, 7)]


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
    """Reference QTensor params and the reference simulated engines'
    outputs: continuous greedy tokens (decode_horizon 8), static greedy
    tokens and a score."""
    jm = JModel(_cfg(j_smoke))
    params = jm.init(jax.random.PRNGKey(0))
    qparams, _ = j_quantize_params(params, QuantPolicy(
        bits=4, block=64, solver="dp", min_size=1024))
    eng = JEngine(jm, qparams, execution="simulated", decode_horizon=8,
                  **ENGINE)
    rids = [eng.submit(p, 8) for p in _prompts()]
    out = eng.run()
    static = np.stack([p[:4] for p in _prompts()])
    scored = np.random.default_rng(12).integers(0, 64, (2, 17)).astype(
        np.int32)
    jserve = JServe(jm, qparams, max_seq=MAX_SEQ, execution="simulated")
    ref = {"continuous": [out[r] for r in rids],
           "static": np.asarray(jserve.generate(jnp.asarray(static), 9)),
           "score": float(jserve.score(jnp.asarray(scored)))}
    return TModel(_cfg(t_smoke)), from_reference(qparams, "cpu"), static, \
        scored, ref


def _leaf_types(tree):
    if isinstance(tree, dict):
        return {t for v in tree.values() for t in _leaf_types(v)}
    return {type(tree)}


def test_resolve_execution_keeps_or_packs_qtensors(setup):
    _, params, *_ = setup
    mode, sim = resolve_execution("simulated", params, torch.device("cpu"))
    assert mode == "simulated" and QTensor in _leaf_types(sim)
    assert PackedQTensor not in _leaf_types(sim)
    assert sim["dec"]["s0"]["attn"]["wq"].codes.device.type == "cpu"
    mode, packed = resolve_execution(None, params, torch.device("cpu"))
    assert mode == "packed" and PackedQTensor in _leaf_types(packed)
    with pytest.raises(ValueError, match="'packed' or 'simulated'"):
        resolve_execution("interpret", params, torch.device("cpu"))


@pytest.mark.parametrize("horizon", [1, 8])
def test_continuous_simulated_matches_reference(setup, horizon):
    model, params, _, _, ref = setup
    eng = TEngine(model, params, execution="simulated",
                  decode_horizon=horizon, device="cpu", **ENGINE)
    assert eng.execution == "simulated"
    rids = [eng.submit(p, 8) for p in _prompts()]
    out = eng.run()
    for rid, expect in zip(rids, ref["continuous"]):
        np.testing.assert_array_equal(out[rid], expect)
    eng.close(check=True)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_simulated_and_packed_agree(setup, bits):
    """The reference's contract: both execution modes give the same greedy
    tokens, at every kv precision."""
    model, params, *_ = setup
    outs = {}
    for mode in ("simulated", "packed"):
        eng = TEngine(model, params, execution=mode, decode_horizon=4,
                      kv_bits=bits, device="cpu", **ENGINE)
        rids = [eng.submit(p, 8) for p in _prompts()]
        out = eng.run()
        outs[mode] = [out[r].tolist() for r in rids]
        eng.close(check=True)
    assert outs["simulated"] == outs["packed"]


def test_serve_engine_simulated_matches_reference(setup):
    model, params, static, scored, ref = setup
    eng = TServe(model, params, max_seq=MAX_SEQ, execution="simulated",
                 device="cpu")
    toks = eng.generate(static, 9)
    np.testing.assert_array_equal(toks, ref["static"])
    np.testing.assert_allclose(eng.score(scored), ref["score"], rtol=1e-5)
