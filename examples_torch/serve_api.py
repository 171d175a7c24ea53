"""Serve an MSB-quantized model over the streaming HTTP front door.

    PYTHONPATH=src python examples_torch/serve_api.py --port 8000   # serve
    PYTHONPATH=src python examples_torch/serve_api.py --self-check  # exit
    PYTHONPATH=src python examples_torch/serve_api.py --self-check --chaos

The PyTorch port of ``examples/serve_api.py``. It runs on the card unless
``--device cpu`` is given. It builds a smoke-size model (seeded
``torch.Generator``), quantizes it at load (4-bit MSB, dynamic-grouping
DP solver: no calibration pass, so quantize-then-serve is one step), wraps
it in ``ContinuousEngine`` at the production decode config
(``decode_horizon=8``, prefix cache on), and exposes it through
``APIServer`` (DESIGN.md Sec. 13):

  * ``POST /v1/completions``: OpenAI-style; ``prompt`` is token ids,
    streaming responses are SSE ``data:`` frames ending in ``data: [DONE]``
  * ``GET /v1/models`` / ``GET /healthz`` / ``GET /metrics``

The server starts with ``warmup=True``: the engine loop captures the
full reachable dispatch set as CUDA graphs (DESIGN.md Sec. 16; eager first
dispatches on the CPU) before admitting traffic, and ``/healthz`` answers
503 + ``Retry-After`` (``"warming"``) until it finishes. Steady-state
serving then captures nothing. The probe ``jit_trace_count()`` keeps the
reference's name but counts graph captures.

``--self-check`` starts the server in-process and drives it like a client:
waits out the warming window, runs the prompt through a direct
``ContinuousEngine`` (a second engine captures its own graphs, so the
capture probe is read after it), then a streaming request (SSE framing),
a non-stream request (token identity with the direct run), a mid-stream
disconnect (the engine aborts, the page pool drains back to baseline),
asserts the probe never moved, and scrapes ``/metrics`` to
``--metrics-out``.

``--self-check --chaos`` wraps the engine in ``EngineSupervisor`` with a
seeded ``FaultPlan`` (DESIGN.md Sec. 14: crashes at ``step`` and
``apply``, allocator OOM at ``alloc``, stalls) and drives concurrent
streaming clients through it: every final stream must be byte-identical
to a fault-free run, every rebuilt incarnation is re-warmed, and the page
pool audits clean afterwards.

In foreground mode (no ``--self-check``) SIGTERM/SIGINT triggers a
graceful drain: admissions answer 503 while in-flight requests finish,
then the server exits.
"""
import argparse
import dataclasses
import http.client
import json
import socket
import time

import numpy as np
import torch

ENGINE_KW = dict(max_batch=8, page_size=4, num_pages=256, max_seq=128,
                 prefill_chunk=8, decode_horizon=8, max_waiting=32)


def smoke_model():
    """The smoke internlm2 with a vocab of 64."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import Model

    return Model(dataclasses.replace(smoke_config("internlm2-1.8b"),
                                     vocab_size=64, vocab_round=64))


def build_model(seed=0, device=None):
    """``smoke_model`` from ``seed``, f32, 4-bit MSB quantized on
    ``device``: (model, quantized params)."""
    from repro_torch.core import QuantPolicy, map_tensors, quantize_params
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    model = smoke_model()
    params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    params = map_tensors(lambda p: p.to(torch.float32), params)
    qparams, report = quantize_params(params, QuantPolicy(
        bits=4, block=64, solver="dp", min_size=1024), device=dev)
    print(f"[serve_api] quantized {len(report)} tensors (4-bit MSB, "
          "dp solver, no calibration)")
    return model, qparams


def build_engine(model, params, device=None, faults=None, **eng_kw):
    from repro_torch.serve import ContinuousEngine

    kw = dict(ENGINE_KW, **eng_kw)
    return ContinuousEngine(model, params, device=device, faults=faults,
                            **kw)


def _post(host, port, body):
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(body).encode(),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = resp.status, json.loads(resp.read().decode())
    conn.close()
    return out


def _stream(host, port, body, hang_up_after=None):
    """Raw-socket SSE client. Returns (token_ids, finish_reason); if
    ``hang_up_after`` is set, closes the socket after that many frames
    (the mid-stream disconnect path)."""
    payload = json.dumps(dict(body, stream=True)).encode()
    s = socket.create_connection((host, port), timeout=120)
    s.sendall((f"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
               f"Content-Type: application/json\r\n"
               f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload)
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += s.recv(65536)
    head, buf = buf.split(b"\r\n\r\n", 1)
    assert b"200 OK" in head and b"text/event-stream" in head, head
    toks, reason, n_frames = [], None, 0
    while True:
        while b"\n\n" in buf:
            frame, buf = buf.split(b"\n\n", 1)
            assert frame.startswith(b"data: "), f"bad SSE framing: {frame!r}"
            n_frames += 1
            if frame == b"data: [DONE]":
                s.close()
                return toks, reason
            chunk = json.loads(frame[6:])["choices"][0]
            toks.extend(chunk["token_ids"])
            reason = chunk["finish_reason"]
            if hang_up_after is not None and n_frames >= hang_up_after:
                s.close()                      # client walks away mid-stream
                return toks, None
        data = s.recv(65536)
        assert data, "server closed the stream before [DONE]"
        buf += data


def _healthz(host, port):
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("GET", "/healthz")
    resp = conn.getresponse()
    body = json.loads(resp.read().decode())
    retry = resp.getheader("Retry-After")
    conn.close()
    return resp.status, body, retry


def _await_warm(srv, host, port, timeout=600.0):
    """Block until the startup warmup finishes. While the engine loop is
    warming, ``/healthz`` must answer 503 + ``Retry-After``: the same
    come-back-later contract as the crash-recovery window."""
    loop = srv.engine_loop
    deadline = time.monotonic() + timeout
    while loop.warming or loop.engine.stats()["warmup_traces"] == 0:
        status, body, retry = _healthz(host, port)
        if body.get("status") == "warming":
            assert status == 503 and retry, (status, retry)
        assert time.monotonic() < deadline, "warmup did not finish"
        time.sleep(0.05)
    status, body, _ = _healthz(host, port)
    assert status == 200 and body["status"] == "ok", body
    # with the overload controller attached, an unloaded server reports
    # the brownout ladder parked at level 0
    assert body.get("brownout_level", 0) == 0, body


def _scrape(host, port):
    conn = http.client.HTTPConnection(host, port, timeout=30)
    conn.request("GET", "/metrics")
    scrape = conn.getresponse().read().decode()
    conn.close()
    return scrape


def self_check(srv, host, port, metrics_out):
    """The reference's self-check against a running server; returns what
    it printed, as a dict."""
    from repro_torch.serve import jit_trace_count

    eng = srv.engine_loop.engine
    _await_warm(srv, host, port)
    st = eng.stats()
    print(f"[self-check] warmup: {st['warmup_traces']} dispatch shapes "
          f"captured in {st['warmup_seconds']:.2f}s; /healthz ok")

    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 64, (9,)).astype(np.int32)
    body = {"prompt": prompt.tolist(), "max_tokens": 24}

    # reference: the same prompt through a direct engine (same config).
    # Unlike the reference's shared jit cache, a second engine captures
    # its own graphs, so the capture probe is read after it
    ref_eng = build_engine(eng.model, eng.params, eng.device,
                           max_waiting=None)
    rid = ref_eng.submit(prompt, 24)
    ref = ref_eng.run()[rid].tolist()
    ref_eng.close()
    traces0 = jit_trace_count()

    toks, reason = _stream(host, port, body)
    assert toks == ref, "streamed tokens differ from direct engine"
    assert reason == "length", reason
    print(f"[self-check] stream: {len(toks)} tokens, SSE framing ok, "
          "token-identical to direct engine")

    status, resp = _post(host, port, body)
    assert status == 200 and \
        resp["choices"][0]["token_ids"] == ref, "non-stream mismatch"
    assert resp["usage"]["completion_tokens"] == len(ref)
    print(f"[self-check] non-stream: 200, usage={resp['usage']}")

    aborts0 = eng.scheduler.n_aborts
    partial, _ = _stream(host, port,
                         {"prompt": prompt.tolist(), "max_tokens": 100},
                         hang_up_after=2)
    deadline = time.monotonic() + 15
    cache = eng.cache
    while time.monotonic() < deadline and (
            eng.scheduler.n_aborts == aborts0
            or cache.n_free_pages + cache.n_cached_pages
            < cache.num_pages - 1):
        time.sleep(0.05)
    assert eng.scheduler.n_aborts == aborts0 + 1, "disconnect did not abort"
    assert (cache.n_free_pages + cache.n_cached_pages
            == cache.num_pages - 1), "pages leaked after disconnect"
    print(f"[self-check] disconnect after {len(partial)} tokens: engine "
          "aborted the request, page pool back to baseline")

    n_new = jit_trace_count() - traces0
    assert n_new == 0, f"steady-state serving retraced ({n_new} new traces)"
    print("[self-check] no-retrace: 0 new jit traces (graph captures) "
          "across the entire serving phase (stream + non-stream + "
          "disconnect)")

    scrape = _scrape(host, port)
    assert "msb_ttft_seconds_count" in scrape
    assert "msb_warmup_seconds" in scrape
    assert "msb_traces_compiled_total" in scrape
    assert "msb_brownout_level" in scrape
    if metrics_out:
        with open(metrics_out, "w") as f:
            f.write(scrape)
        print(f"[self-check] /metrics scrape -> {metrics_out} "
              f"({len(scrape.splitlines())} lines)")
    print("[self-check] all assertions passed")
    return {"tokens": ref, "warmup_traces": st["warmup_traces"],
            "warmup_seconds": st["warmup_seconds"], "new_traces": n_new,
            "disconnect_tokens": len(partial)}


def _memory(device):
    """Device bytes in use by tensors (None on the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return torch.cuda.memory_allocated(dev)


def chaos_check(srv, sup, plan, host, port, prompts, refs, metrics_out):
    """Concurrent clients vs. the seeded fault plan: byte-identical
    streams, no hangs, zero leaked pages. Returns the supervisor's stats
    and the device memory in use after the first warm-up and at the
    end."""
    from concurrent.futures import ThreadPoolExecutor

    deadline = time.monotonic() + 600
    while srv.engine_loop.warming or sup.stats()["warmup_traces"] == 0:
        assert time.monotonic() < deadline, "warmup did not finish"
        time.sleep(0.05)
    mem_warm = _memory(sup.engine.device)

    def client(i):
        payload = json.dumps({"prompt": prompts[i], "max_tokens": 16,
                              "stream": True}).encode()
        deadline = time.monotonic() + 180
        while True:
            assert time.monotonic() < deadline, f"chaos client {i} hung"
            conn = http.client.HTTPConnection(host, port, timeout=120)
            conn.request("POST", "/v1/completions", payload,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = resp.read()
            conn.close()
            if resp.status in (429, 503):      # saturated / recovering
                time.sleep(0.05)
                continue
            assert resp.status == 200, (resp.status, body)
            frames = [f for f in body.decode().split("\n\n") if f]
            assert all(f.startswith("data: ") for f in frames), "bad framing"
            assert frames[-1] == "data: [DONE]", "stream ended without [DONE]"
            chunks = [json.loads(f[6:])["choices"][0] for f in frames[:-1]]
            return [t for c in chunks for t in c["token_ids"]]

    with ThreadPoolExecutor(len(prompts)) as pool:
        streams = list(pool.map(client, range(len(prompts))))
    for i, toks in enumerate(streams):
        assert toks == refs[i], (
            f"chaos client {i} diverged from the fault-free run")
    assert plan.exhausted, f"plan only fired {len(plan.fired)}/{plan.n_events}"
    assert sup.n_restarts > 0, "no fault actually crashed the engine"
    deadline = time.monotonic() + 15
    cache = sup.engine.cache
    while time.monotonic() < deadline and (
            cache.n_free_pages + cache.n_cached_pages < cache.num_pages - 1):
        time.sleep(0.05)
    cache.check_invariants(expect_idle=True)   # zero leaked pages
    st = sup.stats()
    # warmup is sticky across crashes: every rebuilt incarnation re-warms
    # inside its recovery window, so warmup_traces accumulates one full
    # shape set per incarnation (restarts + the original)
    per_inc = sup.engine.warmup_entries
    assert per_inc > 0, "rebuilt incarnation was not re-warmed"
    assert st["warmup_traces"] >= per_inc * (st["restarts"] + 1), st
    mem_end = _memory(sup.engine.device)
    graph_bytes = sup.engine.graphs.pool_bytes()
    print(f"[chaos] {len(prompts)} clients byte-identical through "
          f"{len(plan.fired)} injected faults ({st['restarts']} restarts, "
          f"{st['replayed_tokens']} tokens replayed, "
          f"{st['watchdog_trips']} watchdog trips); pool audit clean; "
          f"{st['restarts']} incarnations re-warmed "
          f"({st['warmup_traces']} shapes, {st['warmup_seconds']:.2f}s)")
    if mem_warm is not None:
        print(f"[chaos] device memory in use: {mem_warm / 1e6:.1f} MB after "
              f"the first warm-up, {mem_end / 1e6:.1f} MB at the end")
    if metrics_out:
        scrape = _scrape(host, port)
        assert "msb_engine_restarts_total" in scrape
        with open(metrics_out, "w") as f:
            f.write(scrape)
        print(f"[chaos] /metrics scrape -> {metrics_out} "
              f"({len(scrape.splitlines())} lines)")
    print("[chaos] all assertions passed")
    return {"restarts": st["restarts"],
            "replayed_tokens": st["replayed_tokens"],
            "warmup_traces": st["warmup_traces"],
            "warmup_seconds": st["warmup_seconds"],
            "faults_fired": [(site, kind) for site, _, kind in plan.fired],
            "memory_after_warmup": mem_warm, "memory_at_end": mem_end,
            "graph_bytes": graph_bytes}


def chaos_prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 64, (int(n),)).astype(np.int32).tolist()
            for n in rng.integers(4, 12, (6,))]


def run_chaos(model, params, device, host="127.0.0.1", chaos_seed=42,
              metrics_out=None):
    from repro_torch.serve import APIServer, EngineSupervisor, FaultPlan

    ref_eng = build_engine(model, params, device)
    prompts = chaos_prompts()
    rids = [ref_eng.submit(np.asarray(p, np.int32), 16) for p in prompts]
    out = ref_eng.run()
    refs = [out[r].tolist() for r in rids]
    ref_eng.close()
    print(f"[chaos] fault-free reference computed for {len(prompts)} prompts")

    # spread is small on purpose: decode_horizon=8 fuses 8 tokens per
    # engine step, so per-site indices advance slowly; a wide spread
    # would leave tail faults unfired by this short workload
    plan = FaultPlan.seeded(chaos_seed, n_faults=8,
                            sites=("step", "apply", "alloc"),
                            first=2, spread=10, stall_s=0.02)
    sup = EngineSupervisor(
        lambda: build_engine(model, params, device, faults=plan),
        watchdog=False, max_crashes_per_request=100)
    srv = APIServer(sup, host=host, port=0, max_timeout_s=300.0,
                    warmup=True)
    host, port = srv.serve_background()
    print(f"[chaos] seeded plan {plan} against http://{host}:{port}")
    try:
        return dict(chaos_check(srv, sup, plan, host, port, prompts, refs,
                                metrics_out), refs=refs)
    finally:
        srv.close()
        sup.close(check=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--self-check", action="store_true",
                    help="start in-process, exercise the API, then exit")
    ap.add_argument("--metrics-out", default=None,
                    help="with --self-check: write the /metrics scrape here")
    ap.add_argument("--chaos", action="store_true",
                    help="with --self-check: run the fault-injection chaos "
                         "check (supervised engine + seeded FaultPlan)")
    ap.add_argument("--chaos-seed", type=int, default=42,
                    help="seed for the --chaos fault plan")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    if args.chaos and not args.self_check:
        ap.error("--chaos requires --self-check")

    from repro_torch.device import resolve_device
    from repro_torch.serve import APIServer

    dev = resolve_device(args.device)
    model, params = build_model(device=dev)
    if args.chaos:
        return run_chaos(model, params, dev, args.host, args.chaos_seed,
                         args.metrics_out)

    engine = build_engine(model, params, dev)
    srv = APIServer(engine, host=args.host,
                    port=0 if args.self_check else args.port,
                    max_timeout_s=300.0, warmup=True, overload=True)
    if not args.self_check:
        srv.run()                               # blocks until interrupted
        return {}
    host, port = srv.serve_background()
    print(f"[serve_api] self-check against http://{host}:{port}")
    try:
        return self_check(srv, host, port, args.metrics_out)
    finally:
        srv.close()
        engine.close(check=False)


if __name__ == "__main__":
    main()
