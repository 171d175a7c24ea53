"""Chaos tests of the PyTorch port's serving stack, re-pointed from
tests/test_chaos.py at the port's engine on the CPU.

Chaos tests: the full serving stack under seeded fault injection.

Acceptance bar: N concurrent requests through the real
``APIServer`` while a seeded ``FaultPlan`` injects crashes/stalls/OOM —
final token streams byte-identical to a fault-free run, no request hangs;
and a 100-fault seeded run ends with zero leaked pages
(``check_invariants`` clean) and zero hung requests. Plus the loop-level
failure paths: an unsupervised engine death fails clients with a typed
error (no hang), the detokenize thread restarts after death, poison
requests answer 500 naming the cause, drain answers 503, and an injected
socket drop releases the request's pages.
"""
import dataclasses
import itertools
import json
import socket
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import torch
import pytest

from repro.configs import smoke_config as j_smoke
from repro.core import QuantPolicy
from repro.core import quantize_params as j_quantize_params
from repro.models import Model as JModel
from repro.serve import ContinuousEngine as JEngine
from repro_torch.configs import smoke_config
from repro_torch.convert import from_reference
from repro_torch.models import Model
from repro_torch.serve import (APIServer, ContinuousEngine, EngineSupervisor,
                         FaultEvent, FaultPlan, jit_trace_count)
from repro_torch.serve.supervisor import (Recovering, Saturated,
                                          WatchdogTimeout)

import http.client


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size ops gain nothing from intra-op threads, and beside other
    test workers and the server's own threads, spinning intra-op threads
    slow every process down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_setup():
    """The reference's smoke internlm2 (vocab 64), 4-bit quantized."""
    cfg = dataclasses.replace(j_smoke("internlm2-1.8b"), vocab_size=64,
                              vocab_round=64)
    jm = JModel(cfg)
    qparams, report = j_quantize_params(jm.init(jax.random.PRNGKey(0)),
                                        QuantPolicy(bits=4, block=64,
                                                    solver="dp",
                                                    min_size=1024))
    assert report
    return jm, qparams


@pytest.fixture(scope="module")
def qsetup(ref_setup):
    """The port's model over the reference's quantized params."""
    cfg = smoke_config("internlm2-1.8b")
    cfg = dataclasses.replace(cfg, vocab_size=64, vocab_round=64)
    return Model(cfg), from_reference(ref_setup[1], "cpu")


@pytest.fixture(scope="module")
def jax_refs(ref_setup):
    """The reference ContinuousEngine's fault-free greedy output for
    PROMPTS under ENG_KW (the port's default execution, packed)."""
    jm, jp = ref_setup
    eng = JEngine(jm, jp, execution="packed", **ENG_KW)
    rids = [eng.submit(np.asarray(p, np.int32), MAX_NEW) for p in PROMPTS]
    out = eng.run()
    return [out[r].tolist() for r in rids]


ENG_KW = dict(max_batch=4, page_size=4, num_pages=64, prefill_chunk=8)

PROMPTS = [list(range(1, 9)), [3, 5, 7, 2], [10, 11, 12, 13, 14, 15],
           [20, 21, 22], [1, 2, 3, 4, 40, 41], [7, 7, 7, 7, 7]]
MAX_NEW = 8


def _engine(model, params, faults=None, **kw):
    merged = dict(ENG_KW, **kw)
    return ContinuousEngine(model, params, device="cpu", faults=faults, **merged)


def _reference(model, params, prompts, max_new=MAX_NEW):
    eng = _engine(model, params)
    rids = [eng.submit(np.asarray(p, np.int32), max_new) for p in prompts]
    out = eng.run()
    eng.close()
    return [out[r].tolist() for r in rids]


def _post(host, port, payload, timeout=120):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = json.dumps(payload).encode()
        conn.request("POST", "/v1/completions", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _get(host, port, path, timeout=30):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _parse_sse(body: bytes):
    frames = [f for f in body.decode().split("\n\n") if f]
    for f in frames:
        assert f.startswith("data: "), f"bad SSE frame: {f!r}"
    assert frames[-1] == "data: [DONE]"
    return [json.loads(f[len("data: "):]) for f in frames[:-1]]


def _poll(predicate, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def _pool_at_baseline(cache):
    return (cache.n_free_pages + cache.n_cached_pages == cache.num_pages - 1
            and (cache.ref_counts[1:] == 0).all()
            and cache.n_free_slots == cache.max_seqs)


# -- the API-server chaos acceptance test -----------------------------------
def test_api_server_chaos_streams_byte_identical(qsetup, jax_refs):
    """Concurrent streaming clients through the real HTTP server while a
    seeded plan injects engine crashes, stalls and allocator OOM; every
    client's final stream is byte-identical to the fault-free run (the
    port's and the reference engine's) and no request hangs. Clients retry
    on 503 (recovery window) and 429."""
    model, params = qsetup
    refs = _reference(model, params, PROMPTS)
    assert refs == jax_refs
    # spread sized to the packed-prefill cadence: one dispatch covers a
    # whole admission wave, so the run reaches fewer step/apply indices
    plan = FaultPlan.seeded(42, n_faults=8, sites=("step", "apply", "alloc"),
                            first=2, spread=15, stall_s=0.02)
    sup = EngineSupervisor(
        lambda: _engine(model, params, faults=plan, max_waiting=32),
        watchdog=False, max_crashes_per_request=100)
    srv = APIServer(sup)
    host, port = srv.serve_background()
    try:
        def client(i):
            payload = {"prompt": PROMPTS[i], "max_tokens": MAX_NEW,
                       "stream": True}
            deadline = time.monotonic() + 120
            while True:
                assert time.monotonic() < deadline, f"client {i} hung"
                status, headers, body = _post(host, port, payload)
                if status in (429, 503):       # saturated / recovering
                    time.sleep(0.05)
                    continue
                assert status == 200, (status, body)
                return body

        with ThreadPoolExecutor(len(PROMPTS)) as pool:
            bodies = list(pool.map(client, range(len(PROMPTS))))

        for i, body in enumerate(bodies):
            frames = _parse_sse(body)
            toks = [t for f in frames for t in f["choices"][0]["token_ids"]]
            assert toks == refs[i], f"client {i} diverged"
            assert frames[-1]["choices"][0]["finish_reason"] == "length"
        assert plan.exhausted, (plan.fired, plan.n_events)
        assert sup.n_restarts > 0              # crashes actually recovered
        assert _poll(lambda: _pool_at_baseline(sup.engine.cache))
        sup.engine.cache.check_invariants(expect_idle=True)
    finally:
        srv.close()
        sup.close(check=False)


# -- a hung step after warm-up ----------------------------------------------
def test_watchdog_recovery_after_warmup_captures_only_the_rewarm(qsetup,
                                                                 jax_refs):
    """A watchdog trip on a ``step`` stall in a warmed supervisor: the
    abandoned worker wakes inside its discarded engine, whose closed
    dispatch set refuses the step, so the captures after the first warm-up
    are the rebuilt incarnation's own warm-up and no more; the replayed
    output is the reference engine's fault-free output."""
    model, params = qsetup
    plan = FaultPlan([FaultEvent("step", 4, "stall", stall_s=1.5)])
    sup = EngineSupervisor(lambda: _engine(model, params, faults=plan),
                           watchdog=True, watchdog_floor_s=0.3,
                           warmup_steps=2, warmup_deadline_s=120.0)
    first = sup._worker
    n0 = jit_trace_count()
    entries = sup.warmup()["entries"]
    assert entries > 0 and jit_trace_count() == n0 + entries
    rids = [sup.submit(np.asarray(p, np.int32), MAX_NEW) for p in PROMPTS]
    out = sup.run()
    assert plan.exhausted
    assert sup.n_watchdog_trips == 1 and sup.n_restarts == 1
    assert isinstance(sup.last_crash, WatchdogTimeout)
    first._thread.join(30)             # the stalled step has returned
    assert not first._thread.is_alive()
    assert isinstance(first.result[1], RuntimeError), first.result
    assert "closed engine" in str(first.result[1])
    assert jit_trace_count() == n0 + 2 * entries
    assert [out[r].tolist() for r in rids] == jax_refs
    sup.engine.cache.check_invariants(expect_idle=True)
    sup.close()


# -- the 100-fault endurance run --------------------------------------------
def test_hundred_fault_chaos_zero_leaks_zero_hangs(qsetup):
    """Direct-drive endurance: a seeded 100-event plan over a rolling
    workload. Every submitted request completes (token-identical to its
    fault-free reference) or is accounted for — none hang — and the pool
    ends at baseline with the invariant audit clean."""
    model, params = qsetup
    refs = _reference(model, params, PROMPTS)
    plan = FaultPlan.seeded(1337, n_faults=100,
                            sites=("step", "apply", "alloc"),
                            first=2, spread=400, stall_s=0.005)
    sup = EngineSupervisor(
        lambda: _engine(model, params, faults=plan, max_waiting=32),
        watchdog=False, max_crashes_per_request=1000)
    prompt_of = {}
    outputs = {}
    cycle = itertools.cycle(range(len(PROMPTS)))
    deadline = time.monotonic() + 240
    while not plan.exhausted:
        assert time.monotonic() < deadline, (
            f"chaos run hung: fired {len(plan.fired)}/{plan.n_events}, "
            f"{len(prompt_of) - len(outputs)} requests outstanding")
        # keep a rolling cohort in flight so every fault index is reached
        while len(prompt_of) - len(outputs) < 8:
            i = next(cycle)
            try:
                rid = sup.submit(np.asarray(PROMPTS[i], np.int32), MAX_NEW)
            except (Recovering, Saturated):
                break                          # recovery/backpressure window
            prompt_of[rid] = i
        sup.step()
        outputs.update({r: o for r, o in sup.collect().items()})
        assert not sup.pop_failures()          # budget 1000: nothing poisons
    # drain the tail: run() loops until has_work is false — the no-hang
    # bound is the pytest-level timeout on this step completing at all
    outputs.update(sup.run())
    assert not sup.pop_failures()
    assert set(outputs) == set(prompt_of), "requests hung or vanished"
    for rid, out in outputs.items():
        assert out.tolist() == refs[prompt_of[rid]], f"request {rid} diverged"
    assert plan.exhausted
    assert sup.n_restarts > 10                 # the plan really was hostile
    sup.engine.cache.check_invariants(expect_idle=True)
    assert _pool_at_baseline(sup.engine.cache)
    sup.close()                                # re-audits at teardown


# -- loop-level failure paths ------------------------------------------------
def test_unsupervised_engine_death_fails_clients_typed(qsetup):
    """A crash escaping EngineLoop._run must fail the
    in-flight client with an error event (finish_reason "error"), not
    strand it, and /healthz must flip to 503."""
    model, params = qsetup
    plan = FaultPlan([FaultEvent("step", 2, "crash")])
    srv = APIServer(_engine(model, params, faults=plan))  # no supervisor
    host, port = srv.serve_background()
    try:
        status, _, body = _post(
            host, port,
            {"prompt": PROMPTS[0], "max_tokens": MAX_NEW, "stream": True})
        assert status == 200
        frames = _parse_sse(body)
        assert frames[-1]["choices"][0]["finish_reason"] == "error"
        assert "InjectedFault" in frames[-1]["error"]["message"]
        assert _poll(lambda: not srv.engine_loop.alive)
        assert srv.engine_loop.health == "dead"
        status, _, body = _get(host, port, "/healthz")
        assert status == 503
        assert json.loads(body)["status"] == "dead"
        # new submissions get a typed 503, not a hang
        status, _, _ = _post(host, port,
                             {"prompt": [1, 2], "max_tokens": 2})
        assert status == 503
    finally:
        srv.close()


def test_supervised_server_survives_the_same_crash(qsetup):
    """The same step crash under a supervisor: the client stream completes
    token-identical and /healthz returns to ok."""
    model, params = qsetup
    refs = _reference(model, params, [PROMPTS[0]])
    plan = FaultPlan([FaultEvent("step", 2, "crash")])
    sup = EngineSupervisor(lambda: _engine(model, params, faults=plan),
                           watchdog=False, degraded_window_s=0.2)
    srv = APIServer(sup)
    host, port = srv.serve_background()
    try:
        status, _, body = _post(
            host, port,
            {"prompt": PROMPTS[0], "max_tokens": MAX_NEW, "stream": True})
        assert status == 200
        frames = _parse_sse(body)
        toks = [t for f in frames for t in f["choices"][0]["token_ids"]]
        assert toks == refs[0]
        assert sup.n_restarts == 1
        assert _poll(lambda: srv.engine_loop.health == "ok")
        status, _, body = _get(host, port, "/healthz")
        assert status == 200
        h = json.loads(body)
        assert h["status"] == "ok"
        assert h["restarts"] == 1
    finally:
        srv.close()
        sup.close(check=False)


def test_detok_thread_death_restarts_and_stream_completes(qsetup):
    model, params = qsetup
    refs = _reference(model, params, [PROMPTS[0]])
    # the detok fire ticks once per batch loop pass; index 2 kills the
    # thread mid-request, between batches
    plan = FaultPlan([FaultEvent("detok", 2, "crash")])
    srv = APIServer(_engine(model, params), faults=plan)
    host, port = srv.serve_background()
    try:
        status, _, body = _post(
            host, port,
            {"prompt": PROMPTS[0], "max_tokens": MAX_NEW, "stream": True})
        assert status == 200
        frames = _parse_sse(body)
        toks = [t for f in frames for t in f["choices"][0]["token_ids"]]
        assert toks == refs[0]                 # nothing lost across restart
        assert srv.engine_loop.n_detok_restarts == 1
        assert srv.engine_loop.alive
        status, _, _ = _get(host, port, "/healthz")
        assert status == 200
    finally:
        srv.close()


def test_poison_request_answers_500_naming_cause(qsetup):
    model, params = qsetup
    plan = FaultPlan([FaultEvent("apply", i, "crash") for i in range(3)])
    sup = EngineSupervisor(lambda: _engine(model, params, faults=plan),
                           watchdog=False, max_crashes_per_request=3)
    srv = APIServer(sup)
    host, port = srv.serve_background()
    try:
        status, _, body = _post(
            host, port, {"prompt": PROMPTS[0], "max_tokens": MAX_NEW})
        assert status == 500
        err = json.loads(body)["error"]
        assert err["type"] == "engine_error"
        assert "PoisonedRequest" in err["message"]
        assert "3 engine crashes" in err["message"]
        assert "InjectedFault" in err["message"]   # names the cause
        assert _poll(lambda: _pool_at_baseline(sup.engine.cache))
    finally:
        srv.close()
        sup.close(check=False)


def test_drain_rejects_new_finishes_inflight_over_http(qsetup):
    model, params = qsetup
    refs = _reference(model, params, [PROMPTS[2]])
    sup = EngineSupervisor(lambda: _engine(model, params), watchdog=False)
    srv = APIServer(sup)
    host, port = srv.serve_background()
    try:
        with ThreadPoolExecutor(1) as pool:
            fut = pool.submit(_post, host, port,
                              {"prompt": PROMPTS[2], "max_tokens": MAX_NEW,
                               "stream": True})
            _poll(lambda: sup.engine.scheduler.has_work, timeout=10)
            srv.drain()
            status, _, body = _get(host, port, "/healthz")
            assert status == 503
            assert json.loads(body)["status"] == "draining"
            status, _, _ = _post(host, port,
                                 {"prompt": [1, 2], "max_tokens": 2})
            assert status == 503               # admissions closed
            status, _, body = fut.result(timeout=60)
        assert status == 200                   # in-flight work finished
        frames = _parse_sse(body)
        toks = [t for f in frames for t in f["choices"][0]["token_ids"]]
        assert toks == refs[0]
        assert _poll(lambda: srv.engine_loop.drained)
    finally:
        srv.close()
        sup.close(check=False)


def test_socket_drop_mid_stream_releases_pages(qsetup):
    """An injected connection drop on a token-bearing frame aborts the
    request server-side: the client sees an abrupt close (no [DONE]) and
    every page returns to the allocator."""
    model, params = qsetup
    plan = FaultPlan([FaultEvent("socket", 1, "crash")])
    eng = _engine(model, params)
    srv = APIServer(eng, faults=plan)
    host, port = srv.serve_background()
    try:
        s = socket.create_connection((host, port), timeout=60)
        payload = json.dumps({"prompt": PROMPTS[0], "max_tokens": MAX_NEW,
                              "stream": True}).encode()
        s.sendall((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                   f"Content-Type: application/json\r\n"
                   f"Content-Length: {len(payload)}\r\n\r\n").encode()
                  + payload)
        buf = b""
        while True:
            try:
                chunk = s.recv(4096)
            except ConnectionError:
                break
            if not chunk:
                break
            buf += chunk
        s.close()
        assert b"data: [DONE]" not in buf      # dropped mid-stream
        assert plan.exhausted
        assert _poll(lambda: _pool_at_baseline(eng.cache))
        eng.cache.check_invariants(expect_idle=True)
        # the server is still healthy for the next client
        status, _, _ = _post(host, port,
                             {"prompt": PROMPTS[1], "max_tokens": 4})
        assert status == 200
    finally:
        srv.close()
