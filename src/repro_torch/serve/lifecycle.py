"""Request lifecycle for the serving front door: validation, state,
per-request timing (port of ``repro.serve.lifecycle`` by copy).

This module is transport-agnostic — no HTTP, no asyncio — so the request
state machine and the TTFT/ITL timing rules are testable with a fake clock
and reusable by any front end (the HTTP server, the benchmark client, a
future gRPC door).

**Validation** (``parse_completion_request``) turns an untrusted JSON body
into typed ``CompletionParams`` or raises ``ValidationError`` carrying the
offending ``param`` — the server maps that to an OpenAI-style 400 error
object. The model here has no text tokenizer (the repo serves token ids),
so ``prompt`` is a list of int token ids (or a string of
whitespace-separated ints, for curl ergonomics), each validated against
the vocabulary.

**Timing** (``RequestLifecycle``): TTFT is observed once, at the arrival
of the first token-bearing event — chunked prefill only delays that event.
Inter-token latency observes **one gap per token-bearing arrival**, never
one per token: a ``decode_horizon=H`` dispatch delivers up to H tokens in
one event, and the only latency a streaming client experienced is the
single gap since the previous flush. Recording H copies (or H-1 zeros)
would fabricate latencies nobody saw; the histogram's count therefore
tracks flushes, not tokens (tokens have their own counter).

States: ``QUEUED`` (accepted, engine-side) -> ``STREAMING`` (first token
seen) -> ``DONE`` with a finish reason in {``stop``, ``length``,
``cancelled``, ``timeout``}. Requests rejected before acceptance (4xx/429)
never get a lifecycle — they are counted by the server directly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

QUEUED, STREAMING, DONE = "queued", "streaming", "done"

FINISH_STOP = "stop"            # hit an eos/stop token (token included)
FINISH_LENGTH = "length"        # exhausted max_tokens
FINISH_CANCELLED = "cancelled"  # client disconnect / explicit abort
FINISH_TIMEOUT = "timeout"      # server-side deadline exceeded
FINISH_ERROR = "error"          # engine-side failure (quarantine, death)
FINISH_REASONS = (FINISH_STOP, FINISH_LENGTH, FINISH_CANCELLED,
                  FINISH_TIMEOUT, FINISH_ERROR)


class ValidationError(ValueError):
    """A request field failed validation. ``param`` names the field; the
    server renders it as an OpenAI-style ``invalid_request_error``."""

    def __init__(self, message: str, param: Optional[str] = None):
        super().__init__(message)
        self.param = param


PRIORITY_CLASSES = ("interactive", "standard", "batch")


@dataclasses.dataclass(frozen=True)
class CompletionParams:
    """A validated ``/v1/completions`` request body."""
    prompt: np.ndarray              # (P,) int32 token ids
    max_tokens: int
    temperature: float
    stop_ids: Tuple[int, ...]       # generation stops on any of these
    stream: bool
    timeout_s: Optional[float]      # per-request server-side deadline
    # overload control plane (DESIGN.md Sec. 17): the scheduling class and
    # an optional soft deadline. The deadline orders admission within a
    # class (EDF) and protects a nearly-due sequence from preemption; it
    # never aborts work — `timeout` owns hard cancellation.
    priority: str = "standard"
    deadline_ms: Optional[float] = None

    @property
    def eos_id(self) -> Optional[int]:
        """The engine-native stop token: with exactly one stop id the
        engine's own eos path handles it (including mid-horizon on-device
        retirement); multiple stop ids are monitored by the server loop."""
        return self.stop_ids[0] if len(self.stop_ids) == 1 else None


def _require_int(value, param, lo=None, hi=None):
    if isinstance(value, bool) or not isinstance(value, int):
        raise ValidationError(f"{param} must be an integer, got "
                              f"{type(value).__name__}", param=param)
    if lo is not None and value < lo:
        raise ValidationError(f"{param} must be >= {lo}, got {value}",
                              param=param)
    if hi is not None and value > hi:
        raise ValidationError(f"{param} must be <= {hi}, got {value}",
                              param=param)
    return value


def _parse_token_list(raw, param, vocab_size):
    if isinstance(raw, str):
        try:
            raw = [int(t) for t in raw.split()]
        except ValueError:
            raise ValidationError(
                f"{param} string form must be whitespace-separated integer "
                "token ids (this model serves token ids, not text)",
                param=param)
    if not isinstance(raw, (list, tuple)):
        raise ValidationError(f"{param} must be a list of integer token ids "
                              "or a string of whitespace-separated ids",
                              param=param)
    toks = [_require_int(t, param, lo=0, hi=vocab_size - 1) for t in raw]
    return toks


def parse_completion_request(body, *, vocab_size, default_max_tokens=16,
                             max_tokens_cap=2048,
                             max_timeout_s=None) -> CompletionParams:
    """Validate an OpenAI-style completions body. Raises ValidationError
    (maps to 400) naming the offending param. Notes vs stock OpenAI:
    ``prompt`` is token ids; ``temperature`` must be 0 (the continuous
    engine samples greedily on host and on device — reproducibility is the
    contract; non-zero sampling is a ROADMAP item) and defaults to 0;
    ``stop`` is up to 4 token ids; ``timeout`` (seconds) is an extension,
    capped at the server's configured maximum. ``priority``
    ("interactive" | "standard" | "batch", default "standard") and
    ``deadline_ms`` (positive, relative to arrival) are the overload
    control plane's extensions — see DESIGN.md Sec. 17."""
    if not isinstance(body, dict):
        raise ValidationError("request body must be a JSON object")
    if "n" in body and body["n"] != 1:
        raise ValidationError("n must be 1 (use fork_request for n-best)",
                              param="n")

    if "prompt" not in body:
        raise ValidationError("prompt is required", param="prompt")
    toks = _parse_token_list(body["prompt"], "prompt", vocab_size)
    if not toks:
        raise ValidationError("prompt must not be empty", param="prompt")

    max_tokens = _require_int(body.get("max_tokens", default_max_tokens),
                              "max_tokens", lo=1, hi=max_tokens_cap)

    temperature = body.get("temperature", 0.0)
    if isinstance(temperature, bool) or \
            not isinstance(temperature, (int, float)):
        raise ValidationError("temperature must be a number",
                              param="temperature")
    if temperature != 0:
        raise ValidationError(
            "temperature must be 0: this engine decodes greedily (on host "
            "and fused on device) so outputs are reproducible; sampled "
            "decoding is not implemented yet", param="temperature")

    stop_raw = body.get("stop", [])
    if isinstance(stop_raw, int) and not isinstance(stop_raw, bool):
        stop_raw = [stop_raw]
    stop_ids = tuple(_parse_token_list(stop_raw, "stop", vocab_size))
    if len(stop_ids) > 4:
        raise ValidationError("stop supports at most 4 token ids",
                              param="stop")

    stream = body.get("stream", False)
    if not isinstance(stream, bool):
        raise ValidationError("stream must be a boolean", param="stream")

    timeout_s = body.get("timeout")
    if timeout_s is not None:
        if isinstance(timeout_s, bool) or \
                not isinstance(timeout_s, (int, float)) or timeout_s <= 0:
            raise ValidationError("timeout must be a positive number of "
                                  "seconds", param="timeout")
        timeout_s = float(timeout_s)
    if max_timeout_s is not None:
        timeout_s = min(timeout_s or max_timeout_s, max_timeout_s)

    priority = body.get("priority", "standard")
    if priority not in PRIORITY_CLASSES:
        raise ValidationError(
            f"priority must be one of {list(PRIORITY_CLASSES)}, "
            f"got {priority!r}", param="priority")

    deadline_ms = body.get("deadline_ms")
    if deadline_ms is not None:
        if isinstance(deadline_ms, bool) or \
                not isinstance(deadline_ms, (int, float)) or deadline_ms <= 0:
            raise ValidationError("deadline_ms must be a positive number of "
                                  "milliseconds", param="deadline_ms")
        deadline_ms = float(deadline_ms)

    return CompletionParams(
        prompt=np.asarray(toks, np.int32), max_tokens=max_tokens,
        temperature=float(temperature), stop_ids=stop_ids, stream=stream,
        timeout_s=timeout_s, priority=priority, deadline_ms=deadline_ms)


class RequestLifecycle:
    """Timing + state for one accepted request.

    Driven by the engine loop: ``on_accepted(now)`` when the engine takes
    the submit, ``on_tokens(n, now)`` per token-bearing drain,
    ``on_finish(reason, now)`` exactly once. Metrics (a ``ServeMetrics``)
    are optional so the class unit-tests with a fake clock and no registry.
    """

    _ids = iter(range(1, 1 << 62))

    def __init__(self, params: CompletionParams, metrics=None,
                 request_id: Optional[str] = None):
        self.params = params
        self.metrics = metrics
        self.request_id = request_id or f"cmpl-{next(self._ids)}"
        self.engine_id: Optional[int] = None      # set at engine submit
        self.state = QUEUED
        self.finish_reason: Optional[str] = None
        self.n_tokens = 0
        self.token_ids: List[int] = []
        self.accepted_at: Optional[float] = None
        self.deadline: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.last_flush_at: Optional[float] = None
        # transport event sink, owned by the server: the asyncio loop and
        # per-request queue the engine loop forwards events into (None for
        # non-HTTP drivers, e.g. the unit tests), plus the wall-clock
        # `created` stamp shared by every response chunk of this request
        self.loop = None
        self.queue = None
        self.created = None

    def on_accepted(self, now: float):
        self.accepted_at = now
        if self.params.timeout_s is not None:
            self.deadline = now + self.params.timeout_s

    def timed_out(self, now: float) -> bool:
        return (self.state != DONE and self.deadline is not None
                and now >= self.deadline)

    def on_tokens(self, tokens: Sequence[int], now: float):
        """Record a token-bearing arrival: TTFT on the first, exactly one
        ITL gap observation per subsequent arrival (see module docstring
        for why horizon bursts must not multi-count)."""
        if not tokens:
            return
        self.token_ids.extend(int(t) for t in tokens)
        self.n_tokens += len(tokens)
        if self.first_token_at is None:
            self.first_token_at = now
            self.state = STREAMING
            if self.metrics is not None and self.accepted_at is not None:
                self.metrics.ttft.observe(now - self.accepted_at)
        else:
            if self.metrics is not None:
                self.metrics.itl.observe(now - self.last_flush_at)
        self.last_flush_at = now

    def on_finish(self, reason: str, now: float):
        if self.state == DONE:
            return
        if reason not in FINISH_REASONS:
            raise ValueError(f"unknown finish reason {reason!r}")
        self.state = DONE
        self.finish_reason = reason
        if self.metrics is not None:
            self.metrics.requests.inc(outcome=reason)
