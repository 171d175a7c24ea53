"""Front-door tests of the PyTorch port (src/repro_torch/serve/server.py),
re-pointed from tests/test_server.py at the port's engine on the CPU.

End-to-end tests for the HTTP serving front door.

The acceptance bar: concurrent streaming clients over real sockets get
greedy output token-identical to direct engine use (across execution modes
and decode horizons), and every failure path — validation, saturation,
client disconnect, server-side timeout — leaves the page pool at baseline.
"""
import dataclasses
import http.client
import json
import socket
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager

import jax
import numpy as np
import torch
import pytest

from repro import serve as j_serve
from repro.configs import smoke_config as j_smoke
from repro.core import QuantPolicy
from repro.core import quantize_params as j_quantize_params
from repro.models import Model as JModel
from repro_torch import serve as t_serve
from repro_torch.configs import smoke_config
from repro_torch.convert import from_reference
from repro_torch.models import Model
from repro_torch.serve import APIServer, ContinuousEngine


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


def _reference_tokens(ref_setup, reqs, **eng_kw):
    """The reference ContinuousEngine's greedy tokens for (prompt,
    max_new) pairs submitted together."""
    jm, jp = ref_setup
    eng = j_serve.ContinuousEngine(jm, jp, **eng_kw)
    rids = [eng.submit(np.asarray(p, np.int32), m) for p, m in reqs]
    out = eng.run()
    return [out[r].tolist() for r in rids]


@contextmanager
def _server(model, params, server_kw=None, **eng_kw):
    eng_kw.setdefault("max_batch", 4)
    eng_kw.setdefault("page_size", 4)
    eng_kw.setdefault("num_pages", 64)
    eng_kw.setdefault("prefill_chunk", 8)
    srv = APIServer(ContinuousEngine(model, params, device="cpu", **eng_kw),
                    **(server_kw or {}))
    host, port = srv.serve_background()
    try:
        yield srv, host, port
    finally:
        srv.close()


def _request(host, port, method, path, payload=None, timeout=120):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = None if payload is None else json.dumps(payload).encode()
        conn.request(method, path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _post(host, port, payload, **kw):
    return _request(host, port, "POST", "/v1/completions", payload, **kw)


def _parse_sse(body: bytes):
    """Assert well-formed SSE framing; return the JSON payloads (the final
    [DONE] sentinel is checked and stripped)."""
    frames = [f for f in body.decode().split("\n\n") if f]
    for f in frames:
        assert f.startswith("data: "), f"bad SSE frame: {f!r}"
    assert frames[-1] == "data: [DONE]"
    return [json.loads(f[len("data: "):]) for f in frames[:-1]]


def _stream_tokens(status, headers, body):
    assert status == 200
    assert headers["Content-Type"].startswith("text/event-stream")
    frames = _parse_sse(body)
    assert frames[-1]["choices"][0]["finish_reason"] is not None
    for f in frames[:-1]:
        assert f["choices"][0]["finish_reason"] is None
    toks = [t for f in frames for t in f["choices"][0]["token_ids"]]
    text = "".join(f["choices"][0]["text"] for f in frames)
    return toks, text, frames[-1]["choices"][0]["finish_reason"]


def _recv_until(sock, marker, buf=b""):
    while marker not in buf:
        chunk = sock.recv(4096)
        assert chunk, "connection closed before expected data"
        buf += chunk
    return buf


def _open_stream(host, port, payload):
    """Raw-socket streaming POST; returns (socket, bytes) once the first
    token-bearing SSE frame has arrived — i.e. the request is provably
    running server-side."""
    s = socket.create_connection((host, port), timeout=120)
    body = json.dumps(payload).encode()
    s.sendall((f"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
               f"Content-Type: application/json\r\n"
               f"Content-Length: {len(body)}\r\n\r\n").encode() + body)
    buf = _recv_until(s, b"\r\n\r\n")
    assert buf.startswith(b"HTTP/1.1 200"), buf
    rest = buf.split(b"\r\n\r\n", 1)[1]
    return s, _recv_until(s, b"\n\n", rest)


def _poll(predicate, timeout=15.0):
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


# -- token identity across execution modes and horizons ----------------------

@pytest.mark.parametrize("execution,horizon", [
    ("simulated", 1), ("packed", 1), ("simulated", 8), ("packed", 8)])
def test_concurrent_clients_token_identical_to_direct_engine(
        qsetup, ref_setup, execution, horizon):
    """HTTP answers carry the direct port engine's tokens, which are the
    reference engine's on the same params and requests."""
    model, qparams = qsetup
    r = np.random.default_rng(7)
    reqs = [(r.integers(0, 64, (int(n),)).astype(np.int32), int(m))
            for n, m in ((5, 7), (9, 6), (7, 9))]
    eng_kw = dict(execution=execution, decode_horizon=horizon)

    direct = ContinuousEngine(model, qparams, device="cpu", max_batch=4, page_size=4,
                              num_pages=64, prefill_chunk=8, **eng_kw)
    rids = [direct.submit(p, m) for p, m in reqs]
    outs = direct.run()
    refs = [outs[rid].tolist() for rid in rids]
    assert refs == _reference_tokens(ref_setup, reqs, max_batch=4,
                                     page_size=4, num_pages=64,
                                     prefill_chunk=8, **eng_kw)

    with _server(model, qparams, **eng_kw) as (srv, host, port):
        def client(i):
            p, m = reqs[i]
            body = {"prompt": p.tolist(), "max_tokens": m,
                    "stream": i > 0}         # client 0 non-stream, rest SSE
            return _post(host, port, body)
        with ThreadPoolExecutor(3) as pool:
            results = list(pool.map(client, range(3)))

        status, _, body = results[0]
        assert status == 200
        resp = json.loads(body)
        choice = resp["choices"][0]
        assert choice["token_ids"] == refs[0]
        assert choice["finish_reason"] == "length"
        assert choice["text"] == "".join(f" {t}" for t in refs[0])
        assert resp["usage"] == {
            "prompt_tokens": len(reqs[0][0]),
            "completion_tokens": len(refs[0]),
            "total_tokens": len(reqs[0][0]) + len(refs[0])}

        for i in (1, 2):
            toks, text, reason = _stream_tokens(*results[i])
            assert toks == refs[i], f"stream client {i} diverged"
            assert text == "".join(f" {t}" for t in refs[i])
            assert reason == "length"

        assert _pool_at_baseline(srv.engine_loop.engine.cache)


# -- request validation and routing ------------------------------------------

def test_routes_validation_and_metrics(qsetup):
    model, qparams = qsetup
    with _server(model, qparams) as (srv, host, port):
        status, _, body = _request(host, port, "GET", "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"

        status, _, body = _request(host, port, "GET", "/v1/models")
        assert status == 200
        assert json.loads(body)["data"][0]["id"] == model.cfg.name

        # typed 400s name the offending param
        for payload, param in [({"prompt": [1], "temperature": 0.9},
                                "temperature"),
                               ({"prompt": [99]}, "prompt"),
                               ({"prompt": [1], "max_tokens": 0},
                                "max_tokens")]:
            status, _, body = _post(host, port, payload)
            err = json.loads(body)["error"]
            assert status == 400, err
            assert err["type"] == "invalid_request_error"
            assert err["param"] == param
        status, _, body = _post(host, port, {"prompt": [1],
                                             "model": "gpt-4"})
        assert status == 404
        assert json.loads(body)["error"]["param"] == "model"

        conn = http.client.HTTPConnection(host, port, timeout=30)
        conn.request("POST", "/v1/completions", body=b"{not json",
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 400
        assert json.loads(resp.read())["error"]["type"] == \
            "invalid_request_error"
        conn.close()

        assert _request(host, port, "GET", "/v1/completions")[0] == 405
        assert _request(host, port, "DELETE", "/healthz")[0] == 405
        assert _request(host, port, "GET", "/no/such/route")[0] == 404

        # one real completion so the scrape has request-path series
        status, _, body = _post(host, port, {"prompt": [1, 2, 3],
                                             "max_tokens": 3})
        assert status == 200

        status, headers, body = _request(host, port, "GET", "/metrics")
        assert status == 200
        assert headers["Content-Type"] == \
            "text/plain; version=0.0.4; charset=utf-8"
        text = body.decode()
        for family in ("msb_ttft_seconds_bucket", "msb_ttft_seconds_count",
                       "msb_inter_token_seconds_bucket", "msb_queue_depth",
                       "msb_running_requests", "msb_prefix_hit_rate",
                       "msb_tokens_generated_total"):
            assert family in text, f"{family} missing from scrape"
        assert 'msb_requests_total{outcome="length"} 1' in text
        assert 'msb_requests_total{outcome="rejected"} 5' in text
        assert srv.metrics.ttft.count() == 1
        assert srv.metrics.itl.count() >= 1


# -- backpressure -------------------------------------------------------------

def test_saturated_engine_returns_429_with_retry_after(qsetup):
    """max_batch=1 + max_waiting=0: while one request runs, the next gets a
    deterministic 429; once drained, submissions flow again."""
    model, qparams = qsetup
    with _server(model, qparams, max_batch=1, max_waiting=0,
                 num_pages=128) as (srv, host, port):
        s, buf = _open_stream(host, port, {"prompt": [3, 1, 4, 1, 5],
                                           "max_tokens": 256,
                                           "stream": True})
        try:
            status, headers, body = _post(host, port,
                                          {"prompt": [2], "max_tokens": 2})
            assert status == 429, body
            # Retry-After is load-derived (serve/overload.py): whole
            # seconds in [1, MAX_RETRY_AFTER_S]
            assert 1 <= int(headers["Retry-After"]) <= 30
            assert json.loads(body)["error"]["type"] == "overloaded_error"
            buf = _recv_until(s, b"data: [DONE]\n\n", buf)
        finally:
            s.close()
        toks, _, reason = _stream_tokens(
            200, {"Content-Type": "text/event-stream"}, buf)
        assert len(toks) == 256 and reason == "length"
        assert srv.metrics.requests.value(outcome="saturated") == 1

        status, _, body = _post(host, port, {"prompt": [2],
                                             "max_tokens": 2})
        assert status == 200
        assert _pool_at_baseline(srv.engine_loop.engine.cache)


# -- cancellation paths --------------------------------------------------------

def test_mid_stream_disconnect_aborts_and_frees_pages(qsetup):
    model, qparams = qsetup
    with _server(model, qparams, num_pages=128) as (srv, host, port):
        s, _ = _open_stream(host, port, {"prompt": [1, 2, 3, 4, 5, 6],
                                         "max_tokens": 200, "stream": True})
        s.close()                          # client walks away mid-stream
        eng = srv.engine_loop.engine
        assert _poll(lambda: eng.n_aborts == 1), \
            "disconnect never reached abort_request"
        assert _poll(lambda: _pool_at_baseline(eng.cache)), \
            "abort leaked pages or slots"
        assert _poll(lambda: srv.metrics.requests.value(
            outcome="cancelled") == 1)
        # the engine is still healthy: a fresh request completes
        status, _, body = _post(host, port, {"prompt": [7, 8],
                                             "max_tokens": 3})
        assert status == 200
        assert len(json.loads(body)["choices"][0]["token_ids"]) == 3
        assert _pool_at_baseline(eng.cache)


def test_server_side_timeout_finishes_with_timeout_reason(qsetup):
    model, qparams = qsetup
    with _server(model, qparams, num_pages=128) as (srv, host, port):
        status, _, body = _post(host, port, {"prompt": [1, 2, 3],
                                             "max_tokens": 500,
                                             "timeout": 0.2})
        assert status == 200
        choice = json.loads(body)["choices"][0]
        assert choice["finish_reason"] == "timeout"
        assert len(choice["token_ids"]) < 500    # cut off mid-generation
        eng = srv.engine_loop.engine
        assert eng.n_aborts == 1
        assert _poll(lambda: _pool_at_baseline(eng.cache))
        assert srv.metrics.requests.value(outcome="timeout") == 1


def test_healthz_reports_dead_engine_loop(qsetup):
    model, qparams = qsetup
    with _server(model, qparams) as (srv, host, port):
        srv.engine_loop.stop()
        assert _poll(lambda: not srv.engine_loop.alive)
        status, _, body = _request(host, port, "GET", "/healthz")
        assert status == 503
        assert json.loads(body)["status"] != "ok"


# -- the pure front-door pieces against the reference ------------------------

PAYLOADS = [
    ({"prompt": [1, 2, 3]}, {}),
    ({"prompt": [1, 2, 3], "max_tokens": 5, "stream": True, "stop": [4, 5],
      "timeout": 2.5, "temperature": 0}, {}),
    ({"prompt": [1], "stop": 7, "n": 1}, {}),
    ({"prompt": [1], "priority": "interactive", "deadline_ms": 1500}, {}),
    ({"prompt": [1], "timeout": 100}, {"max_timeout_s": 30.0}),
    ({"prompt": [1]}, {"max_timeout_s": 30.0, "default_max_tokens": 3}),
    ([1, 2], {}),
    ({"prompt": [1], "n": 2}, {}),
    ({}, {}),
    ({"prompt": []}, {}),
    ({"prompt": [99]}, {}),
    ({"prompt": "abc"}, {}),
    ({"prompt": [1, True]}, {}),
    ({"prompt": [1.5]}, {}),
    ({"prompt": [1], "max_tokens": 0}, {}),
    ({"prompt": [1], "max_tokens": 5000}, {}),
    ({"prompt": [1], "temperature": 0.9}, {}),
    ({"prompt": [1], "temperature": "hot"}, {}),
    ({"prompt": [1], "stop": [1, 2, 3, 4, 5]}, {}),
    ({"prompt": [1], "stream": "yes"}, {}),
    ({"prompt": [1], "timeout": -1}, {}),
    ({"prompt": [1], "priority": "urgent"}, {}),
    ({"prompt": [1], "deadline_ms": 0}, {}),
]


def _parse(mod, body, kw):
    """(parsed fields, None) or (None, (message, param)) of one package's
    ``parse_completion_request``."""
    try:
        got = mod.parse_completion_request(body, vocab_size=64, **kw)
    except mod.ValidationError as e:
        return None, (str(e), e.param)
    return {k: (v.dtype.str, v.tolist()) if isinstance(v, np.ndarray) else v
            for k, v in dataclasses.asdict(got).items()}, None


@pytest.mark.parametrize("case", range(len(PAYLOADS)))
def test_parse_completion_request_matches_reference(case):
    """The same body gives the reference's parsed request, or the same
    ValidationError (message and param)."""
    body, kw = PAYLOADS[case]
    assert _parse(t_serve, body, kw) == _parse(j_serve, body, kw)


class _StatsEngine:
    """An engine whose ``stats()`` and observations are set by the test."""

    def __init__(self):
        self.st, self.obs = {}, {}

    def stats(self):
        return dict(self.st)

    def drain_observations(self):
        obs, self.obs = self.obs, {}
        return obs


def test_metrics_exposition_matches_reference(monkeypatch):
    """The same request-path events and engine snapshots give the
    reference's Prometheus text, line for line, apart from the HELP of the
    two families whose meaning is the port's own (warm-up is CUDA-graph
    capture; the trace probe counts captures)."""
    for mod in (j_serve.continuous, t_serve.continuous):
        monkeypatch.setattr(mod, "jit_trace_count", lambda: 7)
    snaps = []
    for k in (1, 3):
        snaps.append(dict(
            queue_depth=2 * k, running=k, tokens_out=40 * k, steps=9 * k,
            decode_steps=6 * k, host_syncs=9 * k, aborts=k,
            preemptions_by_class={"batch": k, "standard": 0},
            admissions_by_class={"interactive": 2 * k, "batch": k},
            prefix_hits=k, prefix_positions_saved=8 * k, admissions=3 * k,
            prefill_dispatches=3 * k, prefill_segments=5 * k,
            admission_waves=2 * k, warmup_seconds=0.25 * k, restarts=k - 1,
            watchdog_trips=k // 3, replayed_tokens=4 * (k - 1),
            quarantined=0, recovery_log=[0.5] * (k - 1),
            health="ok" if k == 1 else "degraded"))
    texts = []
    for mod in (t_serve, j_serve):
        m, eng = mod.ServeMetrics(), _StatsEngine()
        for i, snap in enumerate(snaps):
            eng.st = snap
            eng.obs = {"admission_queue_depth": [0, 3 + i],
                       "packed_segments": [1, 2 + i]}
            m.sync_engine(eng)
            for v in (0.004, 0.02 * (i + 1), 1.5):
                m.ttft.observe(v)
                m.itl.observe(v / 10)
            m.requests.inc(outcome="length")
            m.requests.inc(outcome="rejected")
            m.sheds.inc(**{"class": "batch"})
            m.brownout_level.set(i + 1)
            m.brownout_transitions.inc()
        m.set_health("draining")
        texts.append(m.render().splitlines())
    port_help = ("# HELP msb_warmup_seconds ",
                 "# HELP msb_traces_compiled_total ")
    got, want = ([ln for ln in t if not ln.startswith(port_help)]
                 for t in texts)
    assert len(got) == len(texts[0]) - 2 and len(want) == len(texts[1]) - 2
    assert got == want
    assert "msb_traces_compiled_total 7" in got
