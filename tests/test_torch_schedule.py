"""Where prefill chunks end, against the reference, on the CPU.

With quantized KV pools (kv_bits 8 and 4) attention reads every page a
row has filled from its codes and the page the row is on from the hot
row. A packed prefill wave holds the largest bucket's tokens, so when
other requests share the wave, a long prompt is cut into chunks, and the
cut can fall mid-page: the page it falls in is then read exact (hot) by
the chunk's own tokens, where a whole-prompt chunk reads it quantized.
The same request's logits then depend on what it was batched with. This
is the reference's semantics, and the port keeps it: here one 14-token
prompt is served alone, behind a 5-token prompt (its first chunk ends
mid-page, at 11) and behind a 4-token prompt (its first chunk ends on a
page boundary, at 12), through both engines at kv 16, 8 and 4. Within a
schedule the port agrees with the reference; across schedules both
differ in the same way, and only where a chunk ended mid-page: kv16 and
page-aligned cuts are schedule-free."""
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
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.convert import from_reference
from repro_torch.models import Model as TModel
from repro_torch.serve import ContinuousEngine as TEngine

# prefill_chunk 4: buckets 4, 8 and 16, so a wave holds 16 tokens
ENGINE = dict(max_batch=4, page_size=4, num_pages=64, max_seq=48,
              prefill_chunk=4)
LONG_LEN, MAX_NEW = 14, 8
# schedule -> (length of the prompt submitted before the long one, the
# long prompt's prefill chunks as (start, length))
SCHEDULES = {"alone": (0, [(0, 14)]),
             "mid_page": (5, [(0, 11), (11, 3)]),
             "page_aligned": (4, [(0, 12), (12, 2)])}


def _cfg(smoke):
    return dataclasses.replace(smoke("internlm2-1.8b"), vocab_size=64,
                               vocab_round=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, which only slow
    the other test workers down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve(eng, before):
    """Serve the long prompt behind a ``before``-token prompt (none if 0)
    in one engine. Returns the long request's tokens, the logits its first
    token was sampled from, and its prefill chunks."""
    rng = np.random.default_rng(5)
    long = rng.integers(0, 64, LONG_LEN).astype(np.int32)
    first = rng.integers(0, 64, before).astype(np.int32)
    logits, chunks = {}, []
    sample, prefill = eng._sample_and_advance, eng._run_prefill_packed

    def on_sample(seq, row):
        logits.setdefault(seq.req.req_id, np.array(row, np.float32))
        sample(seq, row)

    def on_prefill(segs, bucket):
        chunks.extend((seq.req.req_id, start, n) for seq, start, n in segs)
        prefill(segs, bucket)

    eng._sample_and_advance, eng._run_prefill_packed = on_sample, on_prefill
    if before:
        eng.submit(first, MAX_NEW)
    rid = eng.submit(long, MAX_NEW)
    out = eng.run()
    return (out[rid].tolist(), logits[rid],
            [(s, n) for r, s, n in chunks if r == rid])


@pytest.fixture(scope="module")
def served():
    """{(engine, kv_bits, schedule): _serve's result}, engine "jax" (the
    reference) or "torch" (the port), on the same 4-bit quantized
    reference params (packed execution)."""
    jm = JModel(_cfg(j_smoke))
    qparams, _ = j_quantize_params(jm.init(jax.random.PRNGKey(0)),
                                   QuantPolicy(bits=4, block=64, solver="dp",
                                               min_size=1024))
    tm, tp = TModel(_cfg(t_smoke)), from_reference(qparams, "cpu")
    out = {}
    for bits in (16, 8, 4):
        for name, (before, _) in SCHEDULES.items():
            out["jax", bits, name] = _serve(JEngine(
                jm, qparams, execution="packed", kv_bits=bits, **ENGINE),
                before)
            out["torch", bits, name] = _serve(TEngine(
                tm, tp, execution="packed", kv_bits=bits, device="cpu",
                **ENGINE), before)
    return out


@pytest.mark.parametrize("schedule", list(SCHEDULES))
@pytest.mark.parametrize("bits", [16, 8, 4])
def test_port_matches_reference_within_a_schedule(served, bits, schedule):
    """The same chunks, the reference's tokens, and its first-token logits
    within 1e-4."""
    toks, logits, chunks = served["torch", bits, schedule]
    j_toks, j_logits, j_chunks = served["jax", bits, schedule]
    assert chunks == j_chunks == SCHEDULES[schedule][1]
    assert toks == j_toks
    np.testing.assert_allclose(logits, j_logits, rtol=0, atol=1e-4)


@pytest.mark.parametrize("bits", [16, 8, 4])
def test_schedule_dependence_matches_reference(served, bits):
    """Against the long prompt served alone: a cut on a page boundary
    changes no logit in either engine, nor does any cut at kv16; a
    mid-page cut at kv8 and kv4 moves the reference's first-token logits
    by more than 1e-3, and the port's by the same amount within 1e-4."""
    def delta(engine, schedule):
        return served[engine, bits, schedule][1] - \
            served[engine, bits, "alone"][1]

    for engine in ("jax", "torch"):
        assert not delta(engine, "page_aligned").any(), engine
    moved = {e: delta(e, "mid_page") for e in ("jax", "torch")}
    if bits == 16:
        assert not moved["jax"].any() and not moved["torch"].any()
    else:
        assert np.abs(moved["jax"]).max() > 1e-3
        np.testing.assert_allclose(moved["torch"], moved["jax"], rtol=0,
                                   atol=1e-4)
