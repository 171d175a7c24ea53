"""Continuous-batching serving engine over a paged KV cache.

Port of ``repro.serve.continuous.ContinuousEngine``. Step-driven API:
``submit()`` enqueues requests,
each ``step()`` runs one scheduler-chosen unit of work (a packed prefill
wave, a prefill chunk, or a decode batch), ``collect()`` drains finished
outputs. The scheduler, allocator and prefix registry are the reference's,
on the host; the data plane is ``Model.paged_step`` and friends on the
engine's device (``device=None`` = the card), where every packed projection
runs the msb_matmul kernel and every attention a paged-attention kernel.

Every dispatch goes through the engine's dispatch set (``serve/graphs.py``,
the port of the reference's module-level jits): on the card each dispatch
shape is captured once as a CUDA graph and replayed from then on;
``warmup()`` captures the whole reachable set up front (``serve/warmup.py``)
so steady-state serving captures nothing (``jit_trace_count``).

``kv_bits=8|4`` (DESIGN.md Sec. 15) stores committed KV pages
MSB-quantized: each slot keeps its partial page at full precision in a hot
row, every page a dispatch completes is quantized in that dispatch, and
attention runs the fused-dequant kernel. Every quantized dispatch passes the rows'
engine slots, which address the hot rows.

Decode batches are padded to the next power of two; inactive rows and chunk
tails carry ``q_pos == -1`` and write the reserved scratch page. With
``decode_horizon=1`` greedy sampling happens on the host from the returned
last-token logits; ``decode_horizon=H`` runs H decode iterations per
dispatch with the argmax on the device, and only (B, H) tokens come back.
Greedy outputs are identical across horizons, prefill packing on/off and
prefix caching on/off.

``execution="simulated"`` keeps the ``QTensor`` leaves and dequantizes them
per call (``serve/engine.py``).

``mesh=`` (a mesh of ``launch.mesh.make_tp_mesh``) serves tensor-parallel
(DESIGN.md Sec. 10): the weights are partitioned once
(``core.policy.tp_partition_params``), each rank holds its slices and
its own pools (KV/tp heads where the head counts divide the mesh), and
every dispatch runs on every rank with collectives inside the model code
(``serve/graphs.py:TPDispatch``, eagerly). The scheduler, allocator and
sampling stay on this process, rank 0: greedy tokens are those of one
device.

``parallel=`` (a ``ParallelContext`` of a process mesh, ``launch.mesh.
make_host_mesh``) serves GSPMD-style with the layout the reference's
constraints recommend for a paged step, q head-sharded over ``model``
and the pools unconstrained: the weights are partitioned over the
``model`` axis by the same planner (packed trees keep their codes, so
kernel A runs on each rank's slice) and replicated over the data axes,
each rank's pools hold its ``model`` index's KV heads, and every data
rank runs each whole step (the ranks of one ``model`` index do the same
work). Dispatches run eagerly, as on a ``mesh=``: gloo's collectives
cannot be captured, so ``warmup()`` reports 0 graphs. ``mesh=`` with
``parallel=`` is refused.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..device import resolve_device
from .graphs import (DispatchGraphs, TPDispatch,  # noqa: F401 (re-export)
                     jit_trace_count, tp_install_paged, tp_pool_copy)
from .paged_cache import PagedKVCache
from .scheduler import DECODE, FINISHED, Request, Scheduler, Sequence


@dataclasses.dataclass
class ContinuousEngine:
    model: object
    params: object
    max_batch: int = 8
    page_size: int = 16
    num_pages: int = 128
    max_seq: Optional[int] = None          # bounds block-table width
    max_pages_per_seq: Optional[int] = None
    prefill_chunk: int = 32
    parallel: object = None
    execution: Optional[str] = None   # "packed" | "simulated"; None=packed
    mesh: object = None
    prefix_cache: bool = True         # automatic cross-request prefix reuse
    decode_horizon: int = 1           # fused decode steps per dispatch
    kv_bits: int = 16                 # committed-page precision: 16 | 8 | 4
    max_waiting: Optional[int] = None  # backpressure: bound on waiting queue
    faults: object = None             # FaultPlan (testing); None = NO_FAULTS
    prefill_packing: bool = True      # pack prompts into ragged dispatches
    prefill_buckets: object = None    # packed lengths; None = derived ladder
    device: object = None             # None = the card

    def __post_init__(self):
        from ..models.model import shard_params
        from .engine import check_mesh, resolve_execution
        check_mesh(self.mesh, self.parallel)
        if not self.model.supports_paged():
            raise ValueError(
                f"{self.model.cfg.name}: paged serving needs a decoder-only "
                "attention stack (ssm/xlstm/enc-dec caches are not paged)")
        host = self.mesh if self.parallel is None else self.parallel.mesh
        if host is not None and self.device is None:
            self.device = host.device
        self.device = resolve_device(self.device)
        self.execution, self.params = resolve_execution(
            self.execution, self.params, self.device)
        self.tp_report = {}
        shards = None
        if host is not None:
            # tensor parallelism (DESIGN.md Sec. 10): partition once (over
            # the context's model axis under parallel=); this process
            # keeps rank 0's slices
            shards, self.tp_report = shard_params(
                self.model, self.params, host, self.device, self.parallel)
            self.params = shards[0]
        self.decode_horizon = int(self.decode_horizon)
        if self.decode_horizon < 1:
            raise ValueError(f"decode_horizon must be >= 1, "
                             f"got {self.decode_horizon}")
        self.kv_bits = int(self.kv_bits)
        if self.kv_bits not in (16, 8, 4):
            raise ValueError(f"kv_bits must be 16, 8 or 4, "
                             f"got {self.kv_bits}")
        if self.faults is None:
            from .faults import NO_FAULTS
            self.faults = NO_FAULTS
        mpps = self.max_pages_per_seq
        if mpps is None and self.max_seq is not None:
            mpps = -(-self.max_seq // self.page_size)
        self.cache = PagedKVCache(
            self.model, num_pages=self.num_pages, page_size=self.page_size,
            max_seqs=self.max_batch, max_pages_per_seq=mpps,
            prefix_cache=self.prefix_cache, faults=self.faults,
            kv_bits=self.kv_bits, device=self.device,
            parallel=None if host is None else (
                host.shard if self.parallel is None else host.ctx.par))
        # packed ragged prefill: the bucket ladder is the set of packed
        # token lengths, three powers-of-two steps from prefill_chunk
        # unless prefill_buckets= says otherwise
        if self.prefill_packing:
            if self.prefill_buckets is None:
                c = self.prefill_chunk
                self.prefill_buckets = (c, 2 * c, 4 * c)
            self.prefill_buckets = tuple(
                sorted(int(b) for b in self.prefill_buckets))
            if self.prefill_buckets[0] < 1:
                raise ValueError("prefill_buckets must be positive")
        else:
            self.prefill_buckets = None
        self.scheduler = Scheduler(self.cache, self.max_batch,
                                   self.prefill_chunk,
                                   decode_horizon=self.decode_horizon,
                                   max_waiting=self.max_waiting,
                                   prefill_buckets=self.prefill_buckets)
        if host is None:
            self.graphs = DispatchGraphs(self)
        else:
            self._init_tensor_parallel(host, shards)
        self._next_id = 0
        self._seqs: Dict[int, Sequence] = {}
        self._finished: Dict[int, np.ndarray] = {}
        self._stream_off: Dict[int, int] = {}   # tokens already streamed
        self.n_aborts = 0             # abort_request cancellations
        self.n_steps = 0
        self.n_decode_steps = 0       # decode dispatches (any horizon)
        self.n_host_syncs = 0         # blocking device->host transfers
        self.n_tokens_out = 0
        self.n_work_positions = 0     # device token-positions incl. padding
        self.n_forks = 0              # fork_request children that shared pages
        self.n_prefill_dispatches = 0  # prefill device dispatches (any kind)
        self.n_prefill_segments = 0    # sequences served across them
        self.packed_segment_obs: List[int] = []
        self.warmup_seconds = 0.0     # wall seconds spent in warmup()
        self.warmup_entries = 0       # dispatch shapes warmed
        # crash blame: request ids in the work unit the current (or most
        # recently crashed) step dispatched
        self.last_step_rids: Tuple[int, ...] = ()
        self.last_step_kind: str = ""

    def _init_tensor_parallel(self, mesh, shards):
        """Install every rank's slices and pools on the mesh (rank 0's are
        this engine's own) and dispatch through ``TPDispatch``; the fork's
        pool copy runs on every rank (``PagedKVCache.remote``). Under
        ``parallel=`` each rank steps with its ``ParallelContext``, which
        the model runs over the ``model`` axis."""
        key = mesh.new_key()
        pool_kw = dict(num_pages=self.num_pages, page_size=self.page_size,
                       kv_bits=self.kv_bits, max_seqs=self.max_batch)
        per_rank = [(shards[0], self.cache.pools)] + [
            (shard, None) for shard in shards[1:]]
        mesh.install(key, tp_install_paged, per_rank, self.model,
                     self.kv_bits, self.decode_horizon, pool_kw,
                     self.parallel is not None)
        self.params = mesh.ctx.states[key].params
        self.graphs = TPDispatch(mesh, key)
        self.cache.remote = (
            lambda kind, src, dst: mesh.run(tp_pool_copy, key, kind, src,
                                            dst))

    # -- API ----------------------------------------------------------------
    def submit(self, prompt, max_new_tokens, eos_id=None,
               priority="standard", deadline_ms=None,
               deadline_at=None) -> int:
        """Enqueue one request; returns its id (the ``collect()`` key).

        Non-blocking and device-free: nothing is scheduled or transferred
        until a ``step()``. Raises ``ValueError`` if ``prompt`` plus
        ``max_new_tokens`` can never fit the page pool (admission control —
        an accepted request is guaranteed to eventually complete, through
        preemption if need be), and ``Saturated`` when backpressure is on
        (``max_waiting=``) and the waiting queue or page-demand bound is
        exceeded, or a brownout level sheds ``priority``'s class — a
        transient condition the caller should retry (HTTP 429). Generation
        stops after ``max_new_tokens`` or on the first ``eos_id`` (which is
        included in the output).

        ``priority`` ("interactive" | "standard" | "batch") orders
        admission, preemption victims and brownout shedding (DESIGN.md
        Sec. 17); ``deadline_ms`` (relative, from now) orders admission
        within the class (EDF) and protects a nearly-due sequence from
        preemption — it never aborts work. ``deadline_at`` is the absolute
        ``time.monotonic()`` form the supervisor uses on replay so a crash
        does not extend a request's deadline.
        """
        req_id = self._next_id
        self._next_id += 1
        now = time.monotonic()
        if deadline_at is None and deadline_ms is not None:
            deadline_at = now + float(deadline_ms) / 1000.0
        req = Request(req_id, np.asarray(prompt, np.int32).reshape(-1),
                      int(max_new_tokens), eos_id, priority=priority,
                      deadline=deadline_at, submitted_at=now)
        self._seqs[req_id] = self.scheduler.submit(req)
        return req_id

    def would_accept(self, prompt_len, max_new_tokens,
                     priority="standard") -> Optional[Exception]:
        """Mutation-free admission probe: ``None`` when a ``submit`` of this
        size issued right now would be accepted, else the exception it would
        raise (``ValueError`` = can never fit, ``scheduler.Saturated`` =
        busy or class shed under brownout, retry later). Safe to call from
        a thread other than the one driving ``step()`` — it only reads
        counters, and ``submit`` re-validates, so a stale answer costs one
        exception, never state."""
        return self.scheduler.would_accept(
            int(prompt_len) + int(max_new_tokens), priority=priority)

    def step(self) -> bool:
        """Run one scheduler-chosen unit of work (one prefill chunk or one
        packed decode batch = one device dispatch, covering up to
        ``decode_horizon`` fused decode iterations per row); returns False
        when no submitted work remains. Safe to interleave with ``submit``
        — new requests join from the next step. Greedy sampling happens on
        host at ``decode_horizon=1`` and on device inside the fused scan
        otherwise; both are the same f32 argmax, so outputs are
        reproducible across horizons."""
        # blame is reset *before* the step fault-site fires so a crash here
        # (pre-schedule) attributes to no specific request
        self.last_step_rids = ()
        self.last_step_kind = ""
        if self.faults.armed:
            self.faults.fire("step")
        # a step a supervisor abandoned (a hang) may return here after the
        # engine was closed: it must touch neither the host state nor the
        # card any more
        self.graphs.check_open()
        work = self.scheduler.schedule()
        if work is None:
            return False
        self.last_step_kind = work[0]
        if work[0] == "prefill":
            self.last_step_rids = (work[1].req.req_id,)
        elif work[0] == "prefill_packed":
            self.last_step_rids = tuple(s.req.req_id for s, _, _ in work[1])
        else:
            self.last_step_rids = tuple(s.req.req_id for s in work[1])
        self.n_steps += 1
        if work[0] == "prefill":
            self._run_prefill(*work[1:])
        elif work[0] == "prefill_packed":
            self._run_prefill_packed(*work[1:])
        else:
            self._run_decode(work[1])
        return True

    def fork_request(self, req_id, n=1, max_new_tokens=None,
                     eos_id=None) -> List[int]:
        """Fork an unfinished request into ``n`` independent continuations;
        returns their new request ids (``collect()`` keys).

        Each child continues from the parent's current position — prompt
        plus everything sampled so far — with a fresh ``max_new_tokens``
        budget (the parent's unless overridden) and keeps decoding
        independently of the parent. A running parent's KV pages are shared
        by refcount via ``PagedKVCache.fork`` (device copy only for the
        final partial page); if the pool cannot host a fork right now the
        child falls back to the waiting queue as a plain resubmission of
        the parent's tokens, where admission-time prefix matching recovers
        the sharing — either way no slot or page leaks. Under greedy
        sampling every child reproduces the parent's own continuation,
        which is what makes the API testable; it exists for divergent
        continuations (n-best with different budgets/eos, speculative
        branches) once non-greedy sampling lands."""
        seq = self._seqs.get(req_id)
        if seq is None:
            raise KeyError(f"unknown request id {req_id}")
        if seq.state == FINISHED:
            raise ValueError(f"request {req_id} already finished; its pages "
                             "are released (resubmit its tokens instead)")
        budget = (seq.req.max_new_tokens if max_new_tokens is None
                  else int(max_new_tokens))
        # same admission-control gate as submit(): a child whose fork-point
        # prompt plus fresh budget can never fit would otherwise be admitted
        # on pool headroom alone and self-preempt forever at the
        # max_pages_per_seq reserve, livelocking the queue behind it
        why = self.cache.capacity_error(len(seq.tokens) + budget)
        if why is not None:
            raise ValueError(f"fork of request {req_id}: {why}")
        new_ids: List[int] = []
        for _ in range(int(n)):
            new_id = self._next_id
            self._next_id += 1
            req = Request(new_id, seq.tokens.copy(), budget,
                          seq.req.eos_id if eos_id is None else eos_id,
                          priority=seq.req.priority,
                          submitted_at=time.monotonic())
            child = Sequence(req)
            dst = self.cache.fork(seq.slot) if seq.slot >= 0 else None
            if dst is not None:
                child.slot = dst
                child.cache_len = int(self.cache.seq_lens[dst])
                self.scheduler.running.append(child)
                self.n_forks += 1
            else:
                self.scheduler.waiting.append(child)
            self._seqs[new_id] = child
            new_ids.append(new_id)
        return new_ids

    def abort_request(self, req_id) -> bool:
        """Cancel a request at any point in its lifecycle (client
        disconnect, server timeout). Frees everything it holds: a waiting
        request leaves the queue; a running one releases its slot — all its
        pages, including any outstanding decode-horizon lease, return to
        the allocator, and pages it adopted from (or registered into) the
        prefix cache are decref'd onto the reclaimable LRU. Pool accounting
        returns to baseline: nothing leaks (negative-tested).

        Returns True if the request was cancelled, False if it had already
        finished — in which case its uncollected output is *dropped* (the
        caller no longer wants it). Raises ``KeyError`` for ids never
        submitted or already collected/streamed. Must be called from the
        thread driving ``step()`` (the engine is single-threaded; a server
        serializes aborts through its engine loop)."""
        seq = self._seqs.pop(req_id, None)
        if seq is None:
            raise KeyError(f"unknown request id {req_id}")
        self._stream_off.pop(req_id, None)
        self._finished.pop(req_id, None)
        ok = self.scheduler.abort(seq)
        if ok:
            self.n_aborts += 1
        return ok

    def collect(self) -> Dict[int, np.ndarray]:
        """Drain outputs finished since the last ``collect()``: a dict
        ``req_id -> int32 generated tokens`` (prompt not included). Each
        finished request is returned exactly once; uncollected results are
        held, never dropped."""
        out, self._finished = self._finished, {}
        return out

    def stream_updates(self) -> Dict[int, Tuple[List[int], bool]]:
        """Per-token streaming drain: ``{req_id: (new_tokens, finished)}``
        for every request that produced tokens (or finished) since the last
        call. The streaming complement to ``collect()`` — call it after
        each ``step()`` to observe tokens as they are sampled instead of
        waiting for completion. Tokens are reported exactly once and in
        order (``generated`` is append-only, even across preemption, so
        offsets never rewind); with ``decode_horizon=H`` up to H tokens
        arrive per call. A finished request is reported with
        ``finished=True`` exactly once and then fully retired: it leaves
        the ``collect()`` buffer too, so use one drain style per request,
        not both."""
        out: Dict[int, Tuple[List[int], bool]] = {}
        for rid in list(self._seqs):
            seq = self._seqs[rid]
            off = self._stream_off.get(rid, 0)
            new = [int(t) for t in seq.generated[off:]]
            done = seq.state == FINISHED
            if new or done:
                out[rid] = (new, done)
            if done:
                del self._seqs[rid]
                self._stream_off.pop(rid, None)
                self._finished.pop(rid, None)
            elif new:
                self._stream_off[rid] = off + len(new)
        return out

    # -- metrics -------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        """True while any submitted request is unfinished. The generic
        driving predicate for engine owners (``EngineLoop``, benches) —
        the ``EngineSupervisor`` mirrors it, so loops written against
        ``has_work`` drive a raw engine and a supervised one alike."""
        return self.scheduler.has_work

    def stats(self) -> Dict[str, object]:
        """Counter snapshot for metrics exporters. Monotonic counts plus
        the two instantaneous gauges (``queue_depth``, ``running``). The
        ``EngineSupervisor`` exposes the same schema aggregated across
        engine rebuilds — ``ServeMetrics.sync_engine`` consumes either."""
        s = self.scheduler
        return {
            "tokens_out": self.n_tokens_out,
            "steps": self.n_steps,
            "decode_steps": self.n_decode_steps,
            "host_syncs": self.n_host_syncs,
            "work_positions": self.n_work_positions,
            "aborts": self.n_aborts,
            "preemptions": s.n_preemptions,
            "admissions": s.n_admissions,
            "prefix_hits": s.n_prefix_hits,
            "prefix_positions_saved": s.n_prefix_tokens,
            "forks": self.n_forks,
            "prefill_dispatches": self.n_prefill_dispatches,
            "prefill_segments": self.n_prefill_segments,
            "admission_waves": s.n_admission_waves,
            "warmup_seconds": self.warmup_seconds,
            "warmup_traces": self.warmup_entries,
            "preemptions_by_class": dict(s.n_preemptions_by_class),
            "admissions_by_class": dict(s.n_admissions_by_class),
            "sheds_by_class": dict(s.n_sheds_by_class),
            "queue_depth": len(s.waiting),
            "running": len(s.running),
        }

    def drain_observations(self) -> Dict[str, List[int]]:
        """Histogram samples accumulated since the last drain:
        ``admission_queue_depth`` (one per admission wave — NOT per prefill
        chunk) and ``packed_segments`` (one per packed prefill dispatch).
        The metrics sync consumes these; each sample is returned once."""
        s = self.scheduler
        out = {"admission_queue_depth": s.queue_depth_obs,
               "packed_segments": self.packed_segment_obs}
        s.queue_depth_obs = []
        self.packed_segment_obs = []
        return out

    def warmup(self) -> Dict[str, object]:
        """Capture every dispatch shape reachable from this engine's config
        (serve/warmup.py; CUDA graphs on the card) so steady-state serving
        never captures. Returns the warmup report and records it in
        ``stats()``."""
        from .warmup import warm_engine
        report = warm_engine(self)
        self.warmup_seconds += report["seconds"]
        self.warmup_entries += report["entries"]
        return report

    def close(self, check: bool = True):
        """Tear down the engine. With ``check=True`` (default) the page
        allocator's full invariant suite runs first — refcounts, free
        list, lease extents, registry/LRU consistency — and, when no
        request is live, the pool must be back at its post-init baseline:
        zero leaked pages (``PageStateError`` otherwise). Either way the
        engine's dispatch graphs and their memory pool are dropped."""
        try:
            if check:
                self.cache.check_invariants(
                    expect_idle=not self.scheduler.has_work)
        finally:
            self.graphs.close()

    @property
    def n_prefix_hits(self):
        """Admissions that longest-prefix-matched the page registry."""
        return self.scheduler.n_prefix_hits

    @property
    def n_prefix_positions_saved(self):
        """Token positions adopted from the prefix cache instead of being
        prefilled (``cache_len`` started at the matched page boundary)."""
        return self.scheduler.n_prefix_tokens

    def run(self):
        """Drive until all submitted work is complete; return all outputs."""
        done: Dict[int, np.ndarray] = {}
        while self.scheduler.has_work:
            if not self.step():
                break
            done.update(self.collect())
        done.update(self.collect())
        return done

    # -- work kinds ----------------------------------------------------------
    def _run_prefill(self, seq, chunk_tokens, start):
        c = self.prefill_chunk
        n = len(chunk_tokens)
        self.n_prefill_dispatches += 1
        self.n_prefill_segments += 1
        tokens = np.zeros((1, c), np.int32)
        tokens[0, :n] = chunk_tokens
        q_pos = np.full((1, c), -1, np.int32)
        q_pos[0, :n] = start + np.arange(n)
        kv_lens = np.asarray([start + n], np.int32)
        logits = self._dispatch("prefill", c, [seq.slot], tokens, q_pos,
                                kv_lens)
        if self.faults.armed:
            self.faults.fire("apply")   # device written, host not yet
        seq.cache_len = start + n
        self.cache.commit(seq.slot, seq.cache_len)
        self.cache.register_prefix(seq.slot, seq.tokens[:seq.cache_len])
        if seq.cache_len == len(seq.tokens):        # prompt fully in cache
            if not seq.is_done():                   # e.g. max_new_tokens=0
                self._sample_and_advance(seq, logits[0])
            seq.state = DECODE
            self._maybe_finish(seq)

    def _run_prefill_packed(self, segs, bucket):
        """One ragged dispatch over up to ``max_batch`` segments' chunks
        (DESIGN.md Sec. 16). The packed row concatenates each segment's
        tokens (per-token seg ids route KV writes and gathers to the
        segment's own pages), the bucket pads the row to a pre-compiled
        length, and each segment's next-token logits come back at its
        ``last_idx``. Post-dispatch bookkeeping is the unpacked path's, per
        segment: commit, prefix registration, and sample-or-continue."""
        t = bucket
        s_max = self.max_batch
        tokens = np.zeros((t,), np.int32)
        seg_ids = np.full((t,), -1, np.int32)
        q_pos = np.full((t,), -1, np.int32)
        kv_lens = np.zeros((s_max,), np.int32)
        slots = np.full((s_max,), -1, np.int32)
        last_idx = np.zeros((s_max,), np.int32)
        seg_off = np.zeros((s_max,), np.int32)
        off = 0
        for i, (seq, start, n) in enumerate(segs):
            toks = seq.tokens
            tokens[off:off + n] = toks[start:start + n]
            seg_ids[off:off + n] = i
            q_pos[off:off + n] = start + np.arange(n)
            kv_lens[i] = start + n
            slots[i] = seq.slot
            seg_off[i] = off
            last_idx[i] = off + n - 1
            off += n
        self.n_prefill_dispatches += 1
        self.n_prefill_segments += len(segs)
        if len(self.packed_segment_obs) < 4096:
            self.packed_segment_obs.append(len(segs))
        self.n_work_positions += t
        bt = self.cache.table_rows([int(s) for s in slots])
        (logits,) = self.graphs.run(
            "prefill_packed", t, dict(tokens=tokens, seg_ids=seg_ids,
                                      q_pos=q_pos, kv_lens=kv_lens,
                                      slots=slots, last_idx=last_idx,
                                      seg_off=seg_off), bt)
        self.n_host_syncs += 1          # blocking (S, vocab) logits fetch
        logits = logits.cpu().numpy()
        if self.faults.armed:
            self.faults.fire("apply")   # device written, host not yet
        for i, (seq, start, n) in enumerate(segs):
            seq.cache_len = start + n
            self.cache.commit(seq.slot, seq.cache_len)
            self.cache.register_prefix(seq.slot, seq.tokens[:seq.cache_len])
            if seq.cache_len == len(seq.tokens):    # prompt fully in cache
                if not seq.is_done():               # e.g. max_new_tokens=0
                    self._sample_and_advance(seq, logits[i])
                seq.state = DECODE
                self._maybe_finish(seq)

    def _decode_bucket(self, seqs):
        """Shared decode-batch shape policy: pad to the next power of two
        and gather each row's slot + last sampled (not-yet-cached) token.
        Both decode paths build on this so the bucket rounding and the
        last-token convention have one source of truth."""
        b = 1
        while b < len(seqs):
            b *= 2
        slots = [-1] * b
        last = np.zeros((b,), np.int32)
        for i, seq in enumerate(seqs):
            slots[i] = seq.slot
            last[i] = seq.generated[-1]
        return b, slots, last

    def _run_decode(self, seqs):
        self.n_decode_steps += 1
        if self.decode_horizon > 1:
            return self._run_decode_horizon(seqs)
        b, slots, last = self._decode_bucket(seqs)
        tokens = last[:, None]
        q_pos = np.full((b, 1), -1, np.int32)
        kv_lens = np.zeros((b,), np.int32)
        for i, seq in enumerate(seqs):
            q_pos[i, 0] = seq.n_total - 1
            kv_lens[i] = seq.n_total
        logits = self._dispatch("decode", b, slots, tokens, q_pos, kv_lens)
        if self.faults.armed:
            self.faults.fire("apply")   # device written, host not yet
        for i, seq in enumerate(seqs):
            seq.cache_len = seq.n_total
            self.cache.commit(seq.slot, seq.cache_len)
            # decode advances one position per step, so a page fills (and
            # becomes registrable) exactly on the boundary commits
            if self.prefix_cache and seq.cache_len % self.page_size == 0:
                self.cache.register_prefix(seq.slot,
                                           seq.tokens[:seq.cache_len])
            self._sample_and_advance(seq, logits[i])
            self._maybe_finish(seq)

    def _run_decode_horizon(self, seqs):
        """One fused dispatch = up to ``decode_horizon`` decode iterations
        with on-device greedy sampling (DESIGN.md Sec. 12). Only (B, H)
        tokens + done masks come back; the host applies them in bulk —
        commit to the row's final extent, registration catches every page
        boundary crossed inside the horizon (``register_prefix`` is
        incremental over newly filled pages), and finish/eos semantics are
        unchanged because ``valid`` row masks are exact prefix masks."""
        h = self.decode_horizon
        # brownout horizon clamp (DESIGN.md Sec. 17): the *static* trace
        # horizon h never changes — a reduced effective horizon only lowers
        # the dynamic per-row budget below, so the same compiled scan
        # retires fewer tokens per dispatch. Schedule-only, trace-free,
        # and token-identical (greedy output is horizon-independent).
        eff = self.scheduler.effective_horizon
        b, slots, tokens = self._decode_bucket(seqs)
        start_pos = np.full((b,), -1, np.int32)
        n_left = np.zeros((b,), np.int32)
        eos = np.full((b,), -1, np.int32)
        for i, seq in enumerate(seqs):
            start_pos[i] = seq.n_total - 1
            n_left[i] = min(seq.req.max_new_tokens - len(seq.generated), eff)
            if seq.req.eos_id is not None:
                eos[i] = seq.req.eos_id
        self.n_work_positions += b * h
        bt = self.cache.table_rows(slots)
        out_tok, valid = self.graphs.run(
            "decode_horizon", b, dict(tokens=tokens, start_pos=start_pos,
                                      n_left=n_left, eos=eos,
                                      slots=np.asarray(slots, np.int32)), bt)
        out_tok, valid = out_tok.cpu().numpy(), valid.cpu().numpy()
        self.n_host_syncs += 1
        if self.faults.armed:
            self.faults.fire("apply")   # device written, host not yet
        for i, seq in enumerate(seqs):
            k = int(valid[i].sum())     # valid is a prefix mask per row
            for t in out_tok[i, :k]:
                seq.generated.append(int(t))
            self.n_tokens_out += k
            # the dispatch wrote K/V for each *input* token: positions
            # n_total-1 .. n_total-2+k of the pre-dispatch sequence — the
            # final sampled token is, as ever, not yet in the cache
            seq.cache_len = seq.n_total - 1
            self.cache.commit(seq.slot, seq.cache_len)
            if self.prefix_cache:
                self.cache.register_prefix(seq.slot,
                                           seq.tokens[:seq.cache_len])
            self._maybe_finish(seq)

    # -- helpers --------------------------------------------------------------
    def _dispatch(self, kind, size, slots, tokens, q_pos, kv_lens):
        """One ``paged_step`` dispatch (a prefill chunk or a decode batch);
        returns its last-token logits on the host."""
        self.n_work_positions += tokens.size
        bt = self.cache.table_rows(slots)
        (logits,) = self.graphs.run(
            kind, size, dict(tokens=tokens, q_pos=q_pos, kv_lens=kv_lens,
                             slots=np.asarray(slots, np.int32)), bt)
        self.n_host_syncs += 1          # blocking (B, vocab) logits fetch
        return logits.cpu().numpy()

    def _sample_and_advance(self, seq, logits):
        seq.generated.append(int(np.argmax(logits)))
        self.n_tokens_out += 1

    def _maybe_finish(self, seq):
        if seq.is_done():
            self._finished[seq.req.req_id] = np.asarray(seq.generated,
                                                        np.int32)
            self.scheduler.finish(seq)
