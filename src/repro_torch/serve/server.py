"""Async serving front door: streaming HTTP API over the continuous engine.

Port of ``repro.serve.server`` by copy: the engine behind it is the port's
``ContinuousEngine`` (or an ``EngineSupervisor`` over it), whose
``warmup()`` captures the dispatch set as CUDA graphs on the card.

The production entry point that turns "an engine" into "a service"
(DESIGN.md Sec. 13). Stdlib-only by construction — ``asyncio`` plus a
minimal HTTP/1.1 + Server-Sent-Events layer — because the serving
container must not grow a web-framework dependency to expose four routes:

  * ``POST /v1/completions`` — OpenAI-compatible, stream and non-stream.
    ``prompt`` is token ids (this repo serves ids, not text); streaming
    responses are SSE ``data:`` frames ending in ``data: [DONE]``.
  * ``GET /v1/models``    — the one loaded model.
  * ``GET /healthz``      — liveness (503 once the engine loop dies).
  * ``GET /metrics``      — Prometheus text format (serve/metrics.py).

**Thread topology.** Three threads, one owner per mutable domain:

  1. The *engine step-loop thread* (``EngineLoop``) exclusively owns the
     ``ContinuousEngine``: it drains a command queue (submit/cancel),
     runs ``step()``, drains ``stream_updates()``, enforces per-request
     deadlines, and writes all engine-derived metrics. The engine is
     single-threaded by contract; every mutation funnels through this
     loop's command queue.
  2. The *detokenize thread* turns token-id bursts into text pieces and
     forwards events into each request's asyncio queue
     (``loop.call_soon_threadsafe``). String work and cross-thread
     hand-off stay off the hot loop; FIFO order is preserved because all
     events route through it.
  3. The *asyncio thread* runs the HTTP server: parse, validate (typed
     4xx), admission-probe (429 + Retry-After on saturation), then await
     per-request event queues and write frames.

**Request lifecycle.** Validation errors never touch the engine.
Accepted requests get a ``RequestLifecycle`` (serve/lifecycle.py) whose
TTFT/ITL the engine loop records at drain time. Client disconnects are
detected by an EOF watcher on the request socket (plus write failures
mid-stream) and propagate to ``ContinuousEngine.abort_request`` — pages,
horizon leases and prefix-cache refs all return to the allocator; server-
side timeouts take the same path with finish_reason ``timeout``.
Backpressure: the engine is built with ``max_waiting=`` so the scheduler's
``would_accept`` probe (read-only, called from the asyncio thread; the
engine-thread submit re-validates) can shed load before any state is
touched.
"""
from __future__ import annotations

import asyncio
import json
import queue
import threading
import time
from typing import Callable, Dict, Optional

from .faults import NO_FAULTS
from .lifecycle import (DONE, FINISH_CANCELLED, FINISH_ERROR, FINISH_LENGTH,
                        FINISH_STOP, FINISH_TIMEOUT, RequestLifecycle,
                        ValidationError, parse_completion_request)
from .metrics import Registry, ServeMetrics
from .overload import OverloadController, compute_retry_after
from .scheduler import Saturated
from .supervisor import DEAD, DEGRADED, DRAINING, OK, WARMING, Draining, \
    EngineDied, Recovering, Warming


def default_detokenize(token_id: int) -> str:
    """Token ids -> text without a real tokenizer: each token renders as
    a leading-space decimal id, so streams concatenate into ' 5 17 3'.
    Lossless (ids are also returned verbatim in ``token_ids``) and
    replaceable via ``APIServer(detokenize=...)``."""
    return f" {token_id}"


def _set_future(fut: asyncio.Future, err: Optional[Exception]):
    if not fut.cancelled():
        fut.set_result(err)


def _distribute(items):
    """Runs on the asyncio loop: fan one cross-thread wakeup out to many
    per-request queues. Batching events per engine step into a single
    ``call_soon_threadsafe`` matters on small hosts — each threadsafe call
    is a self-pipe write plus a loop wakeup, and paying that per request
    per token measurably taxes the engine thread it shares cores with."""
    for q, event in items:
        q.put_nowait(event)


class EngineLoop:
    """Background thread that exclusively owns a ``ContinuousEngine``.

    Commands (``submit``/``cancel``) arrive on a thread-safe queue and are
    applied between engine steps, so the engine never sees concurrent
    mutation. Token events leave through the detokenize backlog thread
    into per-request asyncio queues. The loop blocks on the command queue
    only when the engine is idle (with a short timeout so deadlines are
    still enforced); with work queued it drains commands non-blocking and
    steps flat out."""

    def __init__(self, engine, metrics: Optional[ServeMetrics] = None,
                 detokenize: Optional[Callable[[int], str]] = None,
                 idle_poll_s: float = 0.05, faults=NO_FAULTS,
                 max_detok_restarts: int = 3, warmup: bool = False,
                 overload: Optional[OverloadController] = None):
        self.engine = engine
        self.metrics = metrics or ServeMetrics()
        self.detokenize = detokenize or default_detokenize
        self.idle_poll_s = idle_poll_s
        self.faults = faults
        # overload control plane (DESIGN.md Sec. 17): ticked once per loop
        # iteration on this thread — the controller mutates scheduler/cache
        # state under the same single-writer discipline as the engine
        self.overload = overload
        self.warmup_requested = bool(warmup)
        self.warming = False           # startup AOT warmup in flight
        self.max_detok_restarts = int(max_detok_restarts)
        self.n_detok_restarts = 0
        self.detok_dead = False        # restart budget exhausted
        self.detok_err: Optional[BaseException] = None
        self.died: Optional[BaseException] = None   # _run escaped with this
        self.draining = False
        self._cmds: "queue.Queue" = queue.Queue()
        self._detok_q: "queue.Queue" = queue.Queue()
        self._by_rid: Dict[int, RequestLifecycle] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="msb-engine-loop")
        self._detok_thread = threading.Thread(target=self._detok_run,
                                              daemon=True,
                                              name="msb-detokenize")

    # -- API (any thread) ---------------------------------------------------
    def start(self):
        self._thread.start()
        self._detok_thread.start()

    def stop(self):
        self._stop.set()
        self._cmds.put(None)                    # wake a blocked get()
        self._thread.join(timeout=10)
        self._detok_q.put(None)
        self._detok_thread.join(timeout=10)

    @property
    def alive(self) -> bool:
        """False once the loop can no longer deliver events: the engine
        thread died (crash with an unsupervised engine — ``died`` holds
        the exception — or clean ``stop()``) or the detokenize thread
        exhausted its restart budget."""
        return self._thread.is_alive() and not self.detok_dead

    @property
    def health(self) -> str:
        """``ok | warming | degraded | draining | dead`` for ``/healthz``:
        dead/draining/warming are loop-level states; a supervised engine
        contributes its own warming/degraded/draining/dead states beneath
        them."""
        if not self.alive:
            return DEAD
        if self.draining:
            return DRAINING
        if self.warming:
            return WARMING
        return getattr(self.engine, "health", OK)

    def drain(self):
        """Stop admissions (``probe`` answers ``Draining`` -> 503) while
        in-flight work runs to completion; ``drained`` flips once the
        engine is empty. Callable from any thread."""
        self.draining = True
        if hasattr(self.engine, "drain"):
            self._cmds.put(("drain", None, None))

    @property
    def drained(self) -> bool:
        return (self.draining
                and not self.engine.has_work and not self._by_rid)

    def probe(self, prompt_len: int, max_tokens: int,
              priority: str = "standard") -> Optional[Exception]:
        """Read-only admission probe (safe off-thread: counters only; the
        engine-thread submit re-validates, so staleness costs one retry,
        never corrupted state)."""
        if not self.alive:
            return EngineDied("engine loop is dead"
                              + (f": {self.died}" if self.died else ""))
        if self.draining:
            return Draining("server is draining; not accepting work")
        if self.warming:
            return Warming("engine is warming up (capturing the dispatch "
                           "set); retry shortly")
        return self.engine.would_accept(prompt_len, max_tokens,
                                        priority=priority)

    def submit(self, lc: RequestLifecycle) -> asyncio.Future:
        """Enqueue a validated request; returns a future (on the caller's
        running loop) resolving to None on acceptance or the exception the
        engine submit raised (Saturated/ValueError race with the probe)."""
        lc.loop = asyncio.get_running_loop()
        lc.queue = asyncio.Queue()
        fut = lc.loop.create_future()
        self._cmds.put(("submit", lc, fut))
        return fut

    def cancel(self, lc: RequestLifecycle, reason: str):
        """Request cancellation (client disconnect, explicit abort). No-op
        if the request already finished by the time the command drains."""
        self._cmds.put(("cancel", lc, reason))

    # -- engine thread ------------------------------------------------------
    def _run(self):
        try:
            if self.warmup_requested and hasattr(self.engine, "warmup"):
                # capture the reachable dispatch set before accepting
                # work; probe/healthz answer Warming/503 until done
                self.warming = True
                try:
                    self.engine.warmup()
                finally:
                    self.warming = False
                self.metrics.sync_engine(self.engine)
            while not self._stop.is_set():
                busy = self.engine.has_work
                self._drain_cmds(block=not busy)
                if self._stop.is_set():
                    break
                if self.engine.has_work:
                    self.engine.step()
                    self._apply_updates(self.engine.stream_updates(),
                                        time.monotonic())
                self._drain_failures(time.monotonic())
                self._check_deadlines(time.monotonic())
                self._ensure_detok()
                self.metrics.sync_engine(self.engine)
                if self.overload is not None:
                    self.overload.tick()
        except BaseException as e:
            # an unsupervised engine's step() crashing lands here (a
            # supervised one contains it); record the cause so probe/
            # healthz can name it, then fail everything below
            self.died = e
        finally:
            # fail every in-flight request loudly rather than hanging its
            # handler forever (healthz flips to 503 via `alive`)
            now = time.monotonic()
            if self.died is not None:
                msg = (f"engine loop died: "
                       f"{type(self.died).__name__}: {self.died}")
                for rid, lc in list(self._by_rid.items()):
                    lc.on_finish(FINISH_ERROR, now)
                    self._emit(lc, ("error", msg))
            else:
                for rid, lc in list(self._by_rid.items()):
                    lc.on_finish(FINISH_CANCELLED, now)
                    self._emit(lc, ("finish", FINISH_CANCELLED))
            self._by_rid.clear()
            self._fail_queued_submits()

    def _fail_queued_submits(self):
        """Submit commands still queued when the loop exits would leave
        their handlers awaiting a future nobody will ever resolve."""
        err = EngineDied("engine loop is gone"
                         + (f": {self.died}" if self.died else ""))
        while True:
            try:
                cmd = self._cmds.get_nowait()
            except queue.Empty:
                return
            if cmd is not None and cmd[0] == "submit":
                lc, fut = cmd[1], cmd[2]
                try:
                    lc.loop.call_soon_threadsafe(_set_future, fut, err)
                except RuntimeError:
                    pass

    def _drain_failures(self, now: float):
        """Requests a supervised engine *failed* (poison quarantine, engine
        death) finish with an error event -> HTTP 500 naming the cause."""
        pop = getattr(self.engine, "pop_failures", None)
        if pop is None:
            return
        for rid, err in pop().items():
            lc = self._by_rid.pop(rid, None)
            if lc is None:
                continue
            lc.on_finish(FINISH_ERROR, now)
            self._emit(lc, ("error", f"{type(err).__name__}: {err}"))

    def _ensure_detok(self):
        """Detect a dead detokenize thread and restart it (bounded). The
        fault site fires *between* batches, so a dying thread never
        half-delivers an event; the queue content survives intact for its
        replacement."""
        if self._detok_thread.is_alive() or self._stop.is_set():
            return
        if self.n_detok_restarts >= self.max_detok_restarts:
            self.detok_dead = True              # alive -> False, healthz 503
            return
        self.n_detok_restarts += 1
        self.metrics.detok_restarts.set_to(self.n_detok_restarts)
        self._detok_thread = threading.Thread(target=self._detok_run,
                                              daemon=True,
                                              name="msb-detokenize")
        self._detok_thread.start()

    def _drain_cmds(self, block: bool):
        while True:
            try:
                cmd = (self._cmds.get(timeout=self.idle_poll_s) if block
                       else self._cmds.get_nowait())
            except queue.Empty:
                return
            block = False                       # only the first get blocks
            if cmd is None:
                return
            if cmd[0] == "submit":
                self._do_submit(cmd[1], cmd[2])
            elif cmd[0] == "cancel":
                self._do_cancel(cmd[1], cmd[2])
            elif cmd[0] == "drain":
                self.engine.drain()

    def _do_submit(self, lc: RequestLifecycle, fut: asyncio.Future):
        p = lc.params
        try:
            if self.draining:                   # raced the drain flag
                raise Draining("server is draining; not accepting work")
            rid = self.engine.submit(p.prompt, p.max_tokens,
                                     eos_id=p.eos_id, priority=p.priority,
                                     deadline_ms=p.deadline_ms)
        except Exception as e:                  # probe->submit race
            lc.loop.call_soon_threadsafe(_set_future, fut, e)
            return
        lc.engine_id = rid
        lc.on_accepted(time.monotonic())
        self._by_rid[rid] = lc
        lc.loop.call_soon_threadsafe(_set_future, fut, None)

    def _do_cancel(self, lc: RequestLifecycle, reason: str):
        rid = lc.engine_id
        if rid is None or rid not in self._by_rid:
            return                              # finished or never accepted
        del self._by_rid[rid]
        try:
            self.engine.abort_request(rid)
        except KeyError:
            pass
        lc.on_finish(reason, time.monotonic())
        self._emit(lc, ("finish", reason))

    def _apply_updates(self, updates, now: float):
        batch = []
        for rid, (new, done) in updates.items():
            lc = self._by_rid.get(rid)
            if lc is None:
                continue
            reason = None
            if len(lc.params.stop_ids) > 1:
                # multi-stop is monitored here (a single stop id rides the
                # engine's own eos path, including on-device mid-horizon)
                for j, t in enumerate(new):
                    if t in lc.params.stop_ids:
                        new, reason = new[:j + 1], FINISH_STOP
                        break
            if new:
                lc.on_tokens(new, now)
                batch.append((lc, ("tokens", list(new))))
            if reason is not None and not done:
                self.engine.abort_request(rid)
                done = True
            elif done:
                eos = lc.params.eos_id
                reason = (FINISH_STOP if eos is not None and lc.token_ids
                          and lc.token_ids[-1] == eos else FINISH_LENGTH)
            if done:
                del self._by_rid[rid]
                lc.on_finish(reason, now)
                batch.append((lc, ("finish", reason)))
        if batch:                  # one detok hand-off per engine step
            self._detok_q.put(batch)

    def _check_deadlines(self, now: float):
        for rid, lc in list(self._by_rid.items()):
            if lc.timed_out(now):
                del self._by_rid[rid]
                try:
                    self.engine.abort_request(rid)
                except KeyError:
                    pass
                lc.on_finish(FINISH_TIMEOUT, now)
                self._emit(lc, ("finish", FINISH_TIMEOUT))

    def _emit(self, lc: RequestLifecycle, event):
        self._detok_q.put([(lc, event)])

    # -- detokenize thread --------------------------------------------------
    def _detok_run(self):
        try:
            self._detok_batches()
        except Exception as e:                  # noqa: BLE001
            # the thread dies (injected or real); queued batches survive
            # untouched for the restarted thread (`_ensure_detok`)
            self.detok_err = e

    def _detok_batches(self):
        while True:
            if self.faults.armed:
                self.faults.fire("detok")       # pre-get: nothing is lost
            batch = self._detok_q.get()
            if batch is None:
                return
            by_loop: Dict[object, list] = {}
            for lc, event in batch:
                if event[0] == "tokens":
                    text = "".join(self.detokenize(t) for t in event[1])
                    event = ("tokens", event[1], text)
                by_loop.setdefault(lc.loop, []).append((lc.queue, event))
            for loop, items in by_loop.items():
                try:
                    loop.call_soon_threadsafe(_distribute, items)
                except RuntimeError:
                    pass                        # handler's loop shut down


class APIServer:
    """The HTTP front door. Owns an ``EngineLoop`` around the given
    ``ContinuousEngine`` (build the engine with ``max_waiting=`` to enable
    429 backpressure) and serves on ``host:port`` (port 0 = ephemeral).

    Use ``serve_background()`` (returns ``(host, port)``) for in-process
    embedding/tests and ``run()`` to block forever.
    Every connection is single-request (``Connection: close``): streaming
    bodies are EOF-delimited SSE, and a closed socket *is* the
    cancellation signal."""

    def __init__(self, engine, *, host: str = "127.0.0.1", port: int = 0,
                 model_name: Optional[str] = None,
                 metrics: Optional[ServeMetrics] = None,
                 detokenize: Optional[Callable[[int], str]] = None,
                 default_max_tokens: int = 16, max_tokens_cap: int = 2048,
                 max_timeout_s: Optional[float] = None,
                 retry_after_s: float = 1.0, faults=NO_FAULTS,
                 warmup: bool = False, overload=False):
        self.host, self.port = host, port
        model = getattr(engine, "engine", engine).model  # unwrap supervisor
        self.model_name = model_name or model.cfg.name
        self.vocab_size = int(model.cfg.vocab_size)
        self.default_max_tokens = default_max_tokens
        self.max_tokens_cap = max_tokens_cap
        self.max_timeout_s = max_timeout_s
        self.retry_after_s = retry_after_s
        self.faults = faults
        self.engine_loop = EngineLoop(engine, metrics=metrics,
                                      detokenize=detokenize, faults=faults,
                                      warmup=warmup)
        self.metrics = self.engine_loop.metrics
        # overload control plane (DESIGN.md Sec. 17): pass overload=True
        # for the default brownout ladder, a dict of OverloadController
        # kwargs to tune it, or a prebuilt controller. The engine loop
        # ticks it; rejections and /healthz read it.
        self.overload: Optional[OverloadController] = None
        if overload:
            if isinstance(overload, OverloadController):
                self.overload = overload
            elif isinstance(overload, dict):
                self.overload = OverloadController(
                    engine, self.metrics,
                    retry_after_base_s=retry_after_s, **overload)
            else:
                self.overload = OverloadController(
                    engine, self.metrics, retry_after_base_s=retry_after_s)
            self.engine_loop.overload = self.overload
        self._retry_salt = 0          # deterministic Retry-After jitter key
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._shutdown: Optional[asyncio.Event] = None
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------------
    def serve_background(self):
        """Start the engine loop + HTTP server on daemon threads; returns
        the bound ``(host, port)``. Pair with ``close()``."""
        self.engine_loop.start()
        ready = threading.Event()
        self._thread = threading.Thread(
            target=self._thread_main, args=(ready,), daemon=True,
            name="msb-api-server")
        self._thread.start()
        if not ready.wait(timeout=30):
            raise RuntimeError("API server failed to bind")
        return self.host, self.port

    def run(self, drain_grace_s: float = 30.0):
        """Serve until interrupted (the CLI path). SIGTERM/SIGINT initiate
        a graceful drain (``train.fault.PreemptionHandler``): admissions
        close with 503, in-flight requests finish (bounded by
        ``drain_grace_s``), then the process exits cleanly."""
        from ..train.fault import PreemptionHandler
        preemption = PreemptionHandler()
        self.engine_loop.start()
        try:
            asyncio.run(self._amain(None, preemption=preemption,
                                    drain_grace_s=drain_grace_s))
        finally:
            preemption.restore()
            self.engine_loop.stop()

    def drain(self):
        """Programmatic drain (same path SIGTERM takes in ``run()``)."""
        self.engine_loop.drain()

    def close(self):
        if self._loop is not None and self._shutdown is not None:
            try:
                self._loop.call_soon_threadsafe(self._shutdown.set)
            except RuntimeError:
                pass
        if self._thread is not None:
            self._thread.join(timeout=10)
        self.engine_loop.stop()

    def _thread_main(self, ready: threading.Event):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        try:
            self._loop.run_until_complete(self._amain(ready))
        finally:
            self._loop.close()

    async def _amain(self, ready: Optional[threading.Event],
                     preemption=None, drain_grace_s: float = 30.0):
        self._shutdown = asyncio.Event()
        server = await asyncio.start_server(self._handle, self.host,
                                            self.port)
        self.port = server.sockets[0].getsockname()[1]
        if ready is not None:
            ready.set()
        else:
            print(f"[serve] listening on http://{self.host}:{self.port} "
                  f"(model {self.model_name})")
        async with server:
            if preemption is None:
                await self._shutdown.wait()
            else:
                await self._wait_or_drain(preemption, drain_grace_s)

    async def _wait_or_drain(self, preemption, drain_grace_s: float):
        """Poll for SIGTERM/SIGINT; on arrival, drain: close admissions
        (503), let in-flight requests finish (up to ``drain_grace_s``),
        then fall out of ``_amain`` so the server sockets close."""
        while not self._shutdown.is_set():
            if preemption.should_stop():
                print("[serve] preemption signal: draining "
                      f"(grace {drain_grace_s:.0f}s)")
                self.engine_loop.drain()
                deadline = time.monotonic() + drain_grace_s
                while (not self.engine_loop.drained
                       and time.monotonic() < deadline):
                    await asyncio.sleep(0.05)
                print("[serve] drained" if self.engine_loop.drained
                      else "[serve] drain grace expired; exiting anyway")
                return
            try:
                await asyncio.wait_for(self._shutdown.wait(), timeout=0.1)
            except asyncio.TimeoutError:
                pass

    # -- HTTP plumbing ------------------------------------------------------
    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter):
        try:
            await self._handle_one(reader, writer)
        except (ConnectionError, asyncio.IncompleteReadError,
                asyncio.TimeoutError, asyncio.LimitOverrunError):
            pass
        except Exception as e:                  # pragma: no cover - backstop
            await self._send_json(writer, 500, {"error": {
                "message": f"internal error: {e}",
                "type": "internal_error"}}, best_effort=True)
        finally:
            try:
                writer.close()
            except Exception:
                pass

    async def _handle_one(self, reader, writer):
        head = await asyncio.wait_for(reader.readuntil(b"\r\n\r\n"),
                                      timeout=30)
        req_line, *header_lines = head.decode("latin-1").split("\r\n")
        parts = req_line.split(" ")
        if len(parts) < 3:
            return await self._send_json(writer, 400, _err("malformed "
                                         "request line", "protocol_error"))
        method, path = parts[0].upper(), parts[1].split("?", 1)[0]
        headers = {}
        for line in header_lines:
            if ":" in line:
                k, v = line.split(":", 1)
                headers[k.strip().lower()] = v.strip()
        n = int(headers.get("content-length", 0) or 0)
        body = await reader.readexactly(n) if n else b""

        if path == "/v1/completions":
            if method != "POST":
                return await self._send_json(writer, 405, _err(
                    f"{method} not allowed on {path}", "protocol_error"))
            return await self._completions(reader, writer, body)
        if method != "GET":
            return await self._send_json(writer, 405, _err(
                f"{method} not allowed on {path}", "protocol_error"))
        if path == "/healthz":
            health = self.engine_loop.health
            body = {"status": health, "model": self.model_name,
                    "brownout_level":
                        self.overload.level if self.overload else 0}
            stats = getattr(self.engine_loop.engine, "stats", None)
            if stats is not None:
                st = stats()
                for k in ("restarts", "watchdog_trips", "quarantined"):
                    if k in st:
                        body[k] = st[k]
            # ok/degraded keep serving (200); warming/draining/dead do
            # not (503) — warming adds Retry-After (transient, like a
            # recovery window) so probes know to re-check, not evict
            if health in (OK, DEGRADED):
                return await self._send_json(writer, 200, body)
            extra = ()
            if health == WARMING:
                extra = self._retry_after_header()
            return await self._send_json(writer, 503, body, extra=extra)
        if path == "/v1/models":
            return await self._send_json(writer, 200, {
                "object": "list",
                "data": [{"id": self.model_name, "object": "model",
                          "owned_by": "msb-repro"}]})
        if path == "/metrics":
            self.metrics.sync_engine(self.engine_loop.engine)
            return await self._send_raw(
                writer, 200, self.metrics.render().encode(),
                Registry.CONTENT_TYPE)
        return await self._send_json(writer, 404, _err(
            f"no route {path}", "not_found_error"))

    # -- /v1/completions ----------------------------------------------------
    async def _completions(self, reader, writer, body: bytes):
        try:
            payload = json.loads(body.decode() or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            self.metrics.requests.inc(outcome="rejected")
            return await self._send_json(writer, 400, _err(
                f"body is not valid JSON: {e}", "invalid_request_error"))
        if isinstance(payload, dict) and \
                payload.get("model") not in (None, self.model_name):
            self.metrics.requests.inc(outcome="rejected")
            return await self._send_json(writer, 404, _err(
                f"model {payload['model']!r} not found (serving "
                f"{self.model_name!r})", "not_found_error", param="model"))
        try:
            params = parse_completion_request(
                payload, vocab_size=self.vocab_size,
                default_max_tokens=self.default_max_tokens,
                max_tokens_cap=self.max_tokens_cap,
                max_timeout_s=self.max_timeout_s)
        except ValidationError as e:
            self.metrics.requests.inc(outcome="rejected")
            return await self._send_json(writer, 400, _err(
                str(e), "invalid_request_error", param=e.param))

        err = self.engine_loop.probe(len(params.prompt), params.max_tokens,
                                     priority=params.priority)
        if err is None:
            lc = RequestLifecycle(params, metrics=self.metrics)
            err = await self.engine_loop.submit(lc)
        if err is not None:
            return await self._reject(writer, err, params)

        watcher = asyncio.ensure_future(self._watch_disconnect(reader, lc))
        try:
            if params.stream:
                await self._stream_response(writer, lc)
            else:
                await self._json_response(writer, lc)
        finally:
            watcher.cancel()

    def _retry_after_value(self) -> int:
        """The one Retry-After computation, shared by the saturation 429,
        warming 503 and recovery 503 paths. With a controller attached the
        value scales with observed pressure and brownout level; without one
        it is the configured base with deterministic per-response jitter so
        synchronized clients don't re-arrive in lockstep."""
        if self.overload is not None:
            return self.overload.retry_after()
        self._retry_salt += 1
        return compute_retry_after(self.retry_after_s,
                                   salt=self._retry_salt)

    def _retry_after_header(self):
        return ((b"Retry-After", str(self._retry_after_value()).encode()),)

    async def _reject(self, writer, err: Exception, params=None):
        retry = self._retry_after_header()
        if isinstance(err, Saturated):
            # transient *capacity* condition: back off and retry (429).
            # Brownout sheds land here too — count them by class so the
            # shed fraction per priority is observable.
            self.metrics.requests.inc(outcome="saturated")
            if params is not None:
                self.metrics.sheds.inc(**{"class": params.priority})
            return await self._send_json(
                writer, 429, _err(f"server saturated, retry later: {err}",
                                  "overloaded_error"), extra=retry)
        if isinstance(err, Recovering):
            # transient *availability* condition: the replica is rebuilding
            # after a crash — distinct from saturation so load balancers
            # can tell "shed load" from "replica briefly down" (503)
            self.metrics.requests.inc(outcome="recovering")
            return await self._send_json(
                writer, 503, _err(str(err), "unavailable_error"),
                extra=retry)
        if isinstance(err, Warming):
            # transient, like Recovering: startup warmup is compiling the
            # dispatch set — the replica will accept shortly (503 + Retry-
            # After, distinct outcome so dashboards can tell them apart)
            self.metrics.requests.inc(outcome="warming")
            return await self._send_json(
                writer, 503, _err(str(err), "unavailable_error"),
                extra=retry)
        if isinstance(err, (Draining, EngineDied)):
            # permanent for this replica: go elsewhere (503, no Retry-After)
            self.metrics.requests.inc(
                outcome="draining" if isinstance(err, Draining) else "dead")
            return await self._send_json(
                writer, 503, _err(str(err), "unavailable_error"))
        self.metrics.requests.inc(outcome="rejected")
        return await self._send_json(writer, 400, _err(
            str(err), "invalid_request_error"))

    async def _watch_disconnect(self, reader, lc: RequestLifecycle):
        """EOF on the request socket = the client went away: propagate
        cancellation so the engine frees the request's pages. A client that
        pipelines extra bytes on this one-request connection is ignored."""
        try:
            data = await reader.read(1)
        except Exception:
            data = b""
        if not data and lc.state != DONE:
            self.engine_loop.cancel(lc, FINISH_CANCELLED)

    def _chunk(self, lc, text, token_ids, finish_reason):
        if lc.created is None:
            lc.created = int(time.time())
        return {"id": lc.request_id, "object": "text_completion",
                "created": lc.created, "model": self.model_name,
                "choices": [{"index": 0, "text": text,
                             "token_ids": token_ids,
                             "finish_reason": finish_reason}]}

    async def _stream_response(self, writer, lc: RequestLifecycle):
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"Content-Type: text/event-stream\r\n"
                     b"Cache-Control: no-cache\r\n"
                     b"Connection: close\r\n\r\n")
        await writer.drain()
        while True:
            # drain everything already queued and write it as one syscall:
            # still one SSE frame per token-bearing event (framing is the
            # contract), but a handler that fell behind the engine catches
            # up in a single write+drain instead of one per frame
            events = [await lc.queue.get()]
            while True:
                try:
                    events.append(lc.queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            out, done = bytearray(), False
            for event in events:
                if event[0] == "tokens":
                    if self.faults.armed:
                        try:
                            # injected mid-stream connection drop: fires
                            # per token-bearing frame
                            self.faults.fire("socket")
                        except Exception:
                            self.engine_loop.cancel(lc, FINISH_CANCELLED)
                            try:
                                writer.transport.abort()
                            except Exception:
                                pass
                            return
                    out += _sse(self._chunk(lc, event[2], event[1], None))
                elif event[0] == "error":       # engine-side failure
                    frame = self._chunk(lc, "", [], FINISH_ERROR)
                    frame["error"] = {"message": event[1],
                                      "type": "engine_error"}
                    out += _sse(frame)
                    out += b"data: [DONE]\n\n"
                    done = True
                    break
                else:                           # ("finish", reason)
                    out += _sse(self._chunk(lc, "", [], event[1]))
                    out += b"data: [DONE]\n\n"
                    done = True
                    break
            try:
                writer.write(bytes(out))
                await writer.drain()
            except (ConnectionError, BrokenPipeError):
                self.engine_loop.cancel(lc, FINISH_CANCELLED)
                return
            if done:
                return

    async def _json_response(self, writer, lc: RequestLifecycle):
        pieces, ids = [], []
        while True:
            event = await lc.queue.get()
            if event[0] == "tokens":
                ids.extend(event[1])
                pieces.append(event[2])
            elif event[0] == "error":           # engine-side failure: 500
                return await self._send_json(writer, 500, _err(
                    event[1], "engine_error"), best_effort=True)
            else:
                reason = event[1]
                break
        if reason == FINISH_CANCELLED:
            return                              # nobody left to answer
        n_prompt = int(len(lc.params.prompt))
        resp = self._chunk(lc, "".join(pieces), ids, reason)
        resp["usage"] = {"prompt_tokens": n_prompt,
                         "completion_tokens": len(ids),
                         "total_tokens": n_prompt + len(ids)}
        await self._send_json(writer, 200, resp)

    # -- response writers ---------------------------------------------------
    _REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
                405: "Method Not Allowed", 429: "Too Many Requests",
                500: "Internal Server Error", 503: "Service Unavailable"}

    async def _send_raw(self, writer, status, body: bytes, ctype: str,
                        extra=(), best_effort=False):
        try:
            head = (f"HTTP/1.1 {status} {self._REASONS.get(status, '')}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    "Connection: close\r\n").encode()
            for k, v in extra:
                head += k + b": " + v + b"\r\n"
            writer.write(head + b"\r\n" + body)
            await writer.drain()
        except (ConnectionError, BrokenPipeError):
            if not best_effort:
                raise

    async def _send_json(self, writer, status, obj, extra=(),
                         best_effort=False):
        await self._send_raw(writer, status, json.dumps(obj).encode(),
                             "application/json", extra, best_effort)


def _sse(frame) -> bytes:
    return (b"data: " + json.dumps(frame, separators=(",", ":")).encode()
            + b"\n\n")


def _err(message, type_, param=None):
    e = {"message": message, "type": type_}
    if param is not None:
        e["param"] = param
    return {"error": e}
