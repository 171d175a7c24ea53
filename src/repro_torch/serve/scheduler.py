"""Continuous-batching scheduler: admission, chunked prefill, preemption.

The scheduler owns policy, not execution: each ``schedule()`` call returns
one unit of work — a prefill chunk for one sequence or a batched decode over
every decoding sequence — and the engine runs it. Port of
``repro.serve.scheduler`` by copy (it is numpy-only): shapes stay within a
finite set because prefill chunks come in fixed buckets and decode batches
are padded to powers of two.

Policy choices (deliberately simple and deterministic; see DESIGN.md §8):
  * Class-aware admission (DESIGN.md Sec. 17): requests carry a priority
    class (interactive/standard/batch). Waiting sequences queue per class,
    EDF-ordered within a class (earliest deadline first, FIFO among
    deadline-free requests), and the admission head is chosen across
    classes by rank with weighted aging — a lower-class head that has
    waited long enough is promoted one class per ``promote_after`` queue
    events, so batch work can never starve. Admission is still gated on a
    whole-sequence capacity check against the page pool (prompt +
    max_new_tokens must fit) so a lone sequence can never deadlock the
    pool, and still head-blocking: if the selected head does not fit,
    nothing behind it leapfrogs.
  * Prefill/decode interleaving alternates when both kinds of work exist,
    so a stream of long prompts cannot starve running decodes (and vice
    versa).
  * Horizon-aware decode leases: with ``decode_horizon=H`` the decode
    reservation covers ``n_total - 1 + min(H, remaining budget)`` positions
    up front, so one fused device dispatch can sample up to H tokens —
    crossing page boundaries mid-horizon — without coming back to the host
    (DESIGN.md Sec. 12). A lease is just a reservation: pages left
    unwritten when a row stops early stay reserved until the sequence
    finishes or is preempted, and release() returns them either way.
  * Preemption by recompute: when decode needs a page and the pool is dry,
    the lowest-class-youngest running sequence is evicted — its pages are
    freed and it re-enters the waiting queue (front of its class) with its
    generated-so-far tokens appended to the prompt, so greedy output is
    unchanged. A sequence past its deadline's point of no return (less
    than half its deadline window remaining) is protected from eviction
    while any unprotected victim exists. With the prefix
    cache on, ``reserve`` reclaims LRU-cached (unreferenced) prefix pages
    before ever reporting the pool dry, so cached pages are always spent
    before a live sequence is preempted — and a preempted sequence usually
    re-admits straight onto its own still-cached pages.
  * Automatic prefix caching (DESIGN.md Sec. 11): admission longest-prefix
    matches the page registry and adopts hits by refcount bump, so a
    request sharing a 2k-token system prompt with an earlier one skips
    that prefill entirely.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from .paged_cache import OutOfPages, PagedKVCache

PREFILL, DECODE, FINISHED = "prefill", "decode", "finished"

# Priority classes, best first. Rank is the admission sort key; the
# weighted-aging promotion in _WaitingQueue keeps the worst class from
# starving, and the brownout ladder (serve/overload.py) sheds from the
# worst class first.
CLASSES = ("interactive", "standard", "batch")
CLASS_RANK: Dict[str, int] = {c: i for i, c in enumerate(CLASSES)}


class Saturated(RuntimeError):
    """A submit was refused for *transient* load reasons (waiting queue
    full, page pool oversubscribed, brownout shedding) — distinct from the
    permanent ``ValueError`` a request that can *never* fit gets. Callers
    should shed load (HTTP 429 + Retry-After) and may retry the identical
    request later. Only raised when backpressure is enabled
    (``max_waiting=``) or a brownout level sheds the request's class."""


@dataclasses.dataclass
class Request:
    req_id: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int
    eos_id: Optional[int] = None
    # priority class ("interactive" | "standard" | "batch"): admission
    # order, preemption-victim order, and brownout shedding all key on it
    priority: str = "standard"
    # absolute monotonic deadline (seconds, time.monotonic() domain), or
    # None. Deadlines order admission within a class (EDF) and protect a
    # nearly-due sequence from preemption; they never abort work — the
    # lifecycle timeout owns hard cancellation.
    deadline: Optional[float] = None
    submitted_at: Optional[float] = None   # monotonic stamp, set at submit


class _WaitingQueue:
    """Per-class admission queues behind a deque-compatible facade.

    Within a class, entries are EDF-ordered: sorted by (deadline, arrival),
    deadline-free requests after deadlined ones, FIFO among themselves.
    ``appendleft`` (preemption re-entry) pins the sequence to the front of
    its class — a preempted sequence has head-of-line rights that a later
    arrival with an earlier deadline must not jump.

    Across classes, the logical head is chosen by *effective rank*:
    ``CLASS_RANK - waited // promote_after``, where ``waited`` counts queue
    events (appends + admissions) since the entry joined — deterministic,
    no wall clock. A batch request that has sat through ``promote_after``
    events competes as standard, through ``2*promote_after`` as
    interactive: bounded starvation by construction. Ties break by class
    rank, then EDF key.

    Only the deque operations the scheduler and engine actually use are
    implemented (append/appendleft/popleft/remove/len/bool/iter/[0])."""

    def __init__(self, promote_after: int = 8):
        self.promote_after = max(1, int(promote_after))
        self._q: Dict[str, List["Sequence"]] = {c: [] for c in CLASSES}
        self._clock = 0

    def __len__(self):
        return sum(len(q) for q in self._q.values())

    def __bool__(self):
        return any(self._q.values())

    def __iter__(self):
        for c in CLASSES:
            yield from self._q[c]

    @staticmethod
    def _edf_key(seq: "Sequence"):
        d = seq.req.deadline
        return (d if d is not None else math.inf, seq._queue_seq)

    def _select_class(self) -> Optional[str]:
        best = None
        for c in CLASSES:
            q = self._q[c]
            if not q:
                continue
            head = q[0]
            waited = self._clock - head._enq_clock
            eff = CLASS_RANK[c] - waited // self.promote_after
            key = (eff, CLASS_RANK[c], self._edf_key(head))
            if best is None or key < best[0]:
                best = (key, c)
        return None if best is None else best[1]

    def append(self, seq: "Sequence"):
        self._clock += 1
        seq._queue_seq = self._clock
        seq._enq_clock = self._clock
        q = self._q[seq.req.priority]
        key = self._edf_key(seq)
        i = len(q)
        while i > 0 and not q[i - 1]._hol and self._edf_key(q[i - 1]) > key:
            i -= 1
        q.insert(i, seq)

    def appendleft(self, seq: "Sequence"):
        # preemption re-entry: front of class, ahead of EDF order; keep the
        # original enqueue clock so accumulated aging credit survives
        seq._hol = True
        if seq._enq_clock is None:
            self._clock += 1
            seq._queue_seq = seq._enq_clock = self._clock
        self._q[seq.req.priority].insert(0, seq)

    def popleft(self) -> "Sequence":
        c = self._select_class()
        if c is None:
            raise IndexError("pop from an empty waiting queue")
        self._clock += 1
        seq = self._q[c].pop(0)
        seq._hol = False
        return seq

    def remove(self, seq: "Sequence"):
        self._q[seq.req.priority].remove(seq)   # ValueError when absent

    def __getitem__(self, i):
        if i != 0:
            raise IndexError("_WaitingQueue only exposes the head ([0])")
        c = self._select_class()
        if c is None:
            raise IndexError("waiting queue is empty")
        return self._q[c][0]

    def depth(self, priority: str) -> int:
        return len(self._q[priority])


class Sequence:
    """Scheduler-internal state for one request."""

    def __init__(self, request: Request):
        self.req = request
        self.slot = -1
        self.generated: List[int] = []
        self.cache_len = 0        # tokens written to the KV pool
        self.state = PREFILL
        self.n_preempted = 0
        self._prefix_match = None   # (registry_epoch, match) memo
        self._tokens_memo = None    # (len(generated), array) memo
        # _WaitingQueue bookkeeping: arrival order, aging epoch, and the
        # head-of-line pin a preempted sequence re-enters with
        self._queue_seq = 0
        self._enq_clock: Optional[int] = None
        self._hol = False

    @property
    def tokens(self) -> np.ndarray:
        """Prompt + everything sampled so far (the re-prefill source after a
        preemption; the last sampled token is not yet in the cache).

        Memoized on ``len(generated)`` — ``generated`` is append-only, so
        length identifies content — because every ``schedule()`` call,
        prefill chunk, and prefix registration reads this, and rebuilding
        the concatenation is O(sequence length) per access. The memo is
        returned read-only since callers share it (fork already copies)."""
        memo = self._tokens_memo
        if memo is not None and memo[0] == len(self.generated):
            return memo[1]
        toks = np.concatenate(
            [self.req.prompt,
             np.asarray(self.generated, np.int32)]).astype(np.int32)
        toks.setflags(write=False)
        self._tokens_memo = (len(self.generated), toks)
        return toks

    @property
    def n_total(self):
        return len(self.req.prompt) + len(self.generated)

    def is_done(self):
        if len(self.generated) >= self.req.max_new_tokens:
            return True
        return (self.req.eos_id is not None and self.generated
                and self.generated[-1] == self.req.eos_id)


class Scheduler:
    def __init__(self, cache: PagedKVCache, max_batch: int,
                 prefill_chunk: int, decode_horizon: int = 1,
                 max_waiting: Optional[int] = None,
                 oversubscribe: float = 2.0,
                 prefill_buckets: Optional[Tuple[int, ...]] = None,
                 promote_after: int = 8):
        self.cache = cache
        self.max_batch = max_batch
        self.prefill_chunk = prefill_chunk
        self.decode_horizon = int(decode_horizon)
        # brownout knobs (serve/overload.py writes these, always on the
        # engine thread). All three are schedule-only: they change which
        # work is dispatched and how much of it, never the dispatch shapes —
        # horizon_cap clamps the *dynamic* per-dispatch token budget under
        # the same static-horizon trace, max_wave_segments packs fewer
        # segments into the same (already-warmed) buckets, shed_classes
        # turns submits of the named classes into Saturated.
        self.horizon_cap: Optional[int] = None
        self.max_wave_segments: Optional[int] = None
        self.shed_classes: frozenset = frozenset()
        # packed ragged prefill (DESIGN.md Sec. 16): when a bucket set is
        # given, schedule() bins every waiting PREFILL sequence's next chunk
        # into ONE dispatch padded to the smallest covering bucket; None
        # keeps the classic one-chunk-per-sequence path
        self.prefill_buckets = (tuple(sorted(int(b) for b in prefill_buckets))
                                if prefill_buckets else None)
        self.isolate_prefill = False    # one segment per wave when True
        # backpressure (None = unbounded queueing, the pre-server behavior):
        # max_waiting bounds the waiting queue; oversubscribe bounds the
        # outstanding page demand of admitted-but-unfinished work to a
        # multiple of the pool, so a burst of feasible-but-huge requests is
        # shed instead of queued behind a full pool-drain of work
        self.max_waiting = max_waiting if max_waiting is None \
            else int(max_waiting)
        self.oversubscribe = float(oversubscribe)
        self.waiting = _WaitingQueue(promote_after=promote_after)
        self.running: List[Sequence] = []
        self._last_was_prefill = False
        self.n_preemptions = 0
        self.n_admissions = 0         # waiting -> running transitions
        self.n_admission_waves = 0    # _admit() calls that admitted >= 1 seq
        self.n_aborts = 0             # requests cancelled before finishing
        self.n_prefix_hits = 0        # admissions that matched the registry
        self.n_prefix_tokens = 0      # positions adopted instead of prefilled
        # per-class observability (msb_*_total{class=} in serve/metrics.py)
        self.n_preemptions_by_class = {c: 0 for c in CLASSES}
        self.n_admissions_by_class = {c: 0 for c in CLASSES}
        self.n_sheds_by_class = {c: 0 for c in CLASSES}
        # one queue-depth sample per admission wave (NOT per prefill chunk:
        # a long prompt's chunks would otherwise re-report the same depth
        # dozens of times and skew the distribution); drained by the engine
        self.queue_depth_obs: List[int] = []

    # -- queue entry points -------------------------------------------------
    def would_accept(self, n_tokens: int,
                     priority: str = "standard") -> Optional[Exception]:
        """Cheap, mutation-free admission probe for ``n_tokens`` (prompt +
        max_new_tokens) at ``priority``. Returns ``None`` when a ``submit``
        issued right now would be accepted, otherwise the exception instance
        a submit would raise: ``ValueError`` for permanent infeasibility
        (the request can never fit this pool, or the priority class is
        unknown) or ``Saturated`` for transient backpressure or brownout
        shedding (retry later). A server front door calls this before
        mutating any state so a 429/400 costs no allocator work; ``submit``
        re-checks, so the probe->submit race is benign."""
        if priority not in CLASS_RANK:
            return ValueError(f"unknown priority class {priority!r} "
                              f"(expected one of {CLASSES})")
        why = self.cache.capacity_error(n_tokens)
        if why is not None:
            return ValueError(why)
        if priority in self.shed_classes:
            return Saturated(
                f"{priority}-class requests are shed under brownout "
                "(transient overload; retry later)")
        if self.max_waiting is None:
            return None                       # backpressure disabled
        if len(self.waiting) >= self.max_waiting:
            # queue full — but an empty queue + free slot + pool headroom
            # means immediate admission, which max_waiting=0 ("no queueing")
            # must still allow
            if not (not self.waiting and len(self.running) < self.max_batch
                    and self.cache.n_free_slots > 0
                    and self.cache.pages_for(n_tokens)
                    <= self.cache.n_available_pages):
                return Saturated(
                    f"waiting queue full ({len(self.waiting)} waiting, "
                    f"max_waiting={self.max_waiting})")
        demand = sum(
            self.cache.pages_for(len(s.req.prompt) + s.req.max_new_tokens)
            for s in self.running) + sum(
            self.cache.pages_for(len(s.req.prompt) + s.req.max_new_tokens)
            for s in self.waiting)
        usable = self.cache.num_pages - 1
        if demand + self.cache.pages_for(n_tokens) \
                > self.oversubscribe * usable:
            return Saturated(
                f"page pool saturated ({demand} pages of work outstanding "
                f"against {usable} usable pages, "
                f"oversubscribe={self.oversubscribe})")
        return None

    def submit(self, request: Request) -> Sequence:
        # the HTTP layer rejects these with a 400; direct callers get the
        # same contract here (there is no token to prefill, so the packed
        # planner would never assign the sequence a segment)
        if len(request.prompt) == 0:
            raise ValueError(f"request {request.req_id}: prompt must not "
                             "be empty (nothing to prefill)")
        total = len(request.prompt) + request.max_new_tokens
        err = self.would_accept(total, priority=request.priority)
        if err is not None:        # names the limit that actually rejected
            if isinstance(err, Saturated):
                self.n_sheds_by_class[request.priority] += 1
            raise type(err)(f"request {request.req_id}: {err}")
        if request.submitted_at is None:
            request.submitted_at = time.monotonic()
        seq = Sequence(request)
        self.waiting.append(seq)
        return seq

    def abort(self, seq: Sequence) -> bool:
        """Cancel ``seq`` wherever it is in its lifecycle. A waiting
        sequence is dropped from the queue; a running one releases its slot
        — every page it holds (committed, leased-but-unwritten horizon
        pages, and adopted prefix pages alike) is decref'd by
        ``cache.release``, so registered pages park on the prefix-cache LRU
        (reclaimable, not leaked) and everything else returns to the free
        list. Returns False (no-op) when the sequence already finished."""
        if seq.state == FINISHED:
            return False
        if seq.slot >= 0:
            self.cache.release(seq.slot)
            seq.slot = -1
            self.running.remove(seq)
        else:
            try:
                self.waiting.remove(seq)
            except ValueError:
                pass                          # already gone
        seq.state = FINISHED
        self.n_aborts += 1
        return True

    @property
    def has_work(self):
        return bool(self.waiting or self.running)

    # -- internals ----------------------------------------------------------
    def _admit(self):
        """Class-ordered admission while slots, batch room, and pool
        headroom last (the _WaitingQueue head: class rank with aging
        promotion, EDF within a class).
        Headroom check is against the *whole* remaining sequence so an
        admitted sequence only ever blocks on pages another sequence can
        release (preemption handles that case); it counts LRU-cached prefix
        pages as available, since ``reserve`` reclaims them on demand.

        Each admitted sequence longest-prefix-matches the prefix registry
        first: matched pages are adopted by refcount bump and ``cache_len``
        starts at the matched boundary, so chunked prefill skips them. The
        match is capped at ``len(tokens) - 1`` — the last position must be
        prefilled for real so the sampler has logits to advance on."""
        depth_before = len(self.waiting)
        admitted_before = self.n_admissions
        while (self.waiting and len(self.running) < self.max_batch
               and self.cache.n_free_slots > 0):
            seq = self.waiting[0]
            toks = seq.tokens
            match = self._match_for(seq, toks)
            n_hit = len(match.pages) if match else 0
            need = self.cache.pages_for(
                len(toks) + seq.req.max_new_tokens
                - len(seq.generated)) - n_hit
            avail = self.cache.n_available_pages - (
                match.n_unreferenced if match else 0)
            if need > avail:
                break
            self.waiting.popleft()
            self.n_admissions += 1
            self.n_admissions_by_class[seq.req.priority] += 1
            seq.slot = self.cache.alloc_slot()
            seq.cache_len = 0
            if match is not None:
                self.cache.adopt_prefix(seq.slot, match)
                seq.cache_len = match.n_tokens
                self.n_prefix_hits += 1
                self.n_prefix_tokens += match.n_tokens
            seq.state = PREFILL
            self.running.append(seq)
        if self.n_admissions > admitted_before:
            self.n_admission_waves += 1
            if len(self.queue_depth_obs) < 4096:   # bounded if undrained
                self.queue_depth_obs.append(depth_before)

    def _match_for(self, seq, toks):
        """match_prefix memoized per sequence on the registry epoch: a
        page-blocked head-of-queue request would otherwise re-hash its
        whole prompt on every schedule() call while it waits. The memo can
        only go stale in LRU-membership accounting (registration state is
        epoch-versioned), which admission treats as advisory anyway —
        reserve-time OutOfPages and preemption backstop it."""
        epoch = self.cache.registry_epoch
        if seq._prefix_match is not None and seq._prefix_match[0] == epoch:
            return seq._prefix_match[1]
        match = self.cache.match_prefix(toks, max_tokens=len(toks) - 1)
        seq._prefix_match = (epoch, match)
        return match

    def _preempt(self, victim):
        """Evict ``victim`` (recompute-on-resume): free its pages and push it
        to the front of the waiting queue with generated tokens preserved."""
        self.cache.release(victim.slot)
        victim.slot = -1
        victim.cache_len = 0
        victim.state = PREFILL
        victim.n_preempted += 1
        victim._prefix_match = None   # tokens grew since the last match
        self.running.remove(victim)
        self.waiting.appendleft(victim)
        self.n_preemptions += 1
        self.n_preemptions_by_class[victim.req.priority] += 1

    @staticmethod
    def _past_point_of_no_return(seq, now: float) -> bool:
        """A deadlined sequence is past its point of no return once less
        than half its original deadline window remains: preempting it then
        (recompute-on-resume re-prefills everything generated so far) would
        all but guarantee a deadline miss, so the victim picker protects it
        while any unprotected candidate exists. Deadline-free sequences are
        never protected."""
        d = seq.req.deadline
        if d is None:
            return False
        sub = seq.req.submitted_at
        if sub is None or d <= sub:
            return now >= d
        return (d - now) < 0.5 * (d - sub)

    def _pick_victim(self, now: Optional[float] = None):
        """Lowest-class-youngest victim: among running sequences not past
        their deadline's point of no return, take the worst priority class,
        breaking ties by highest req_id (youngest). Protection is
        best-effort — if *every* running sequence is protected the pool
        still has to make progress, so the pick falls back to all of them."""
        now = time.monotonic() if now is None else now
        candidates = [s for s in self.running
                      if not self._past_point_of_no_return(s, now)]
        if not candidates:
            candidates = self.running
        return max(candidates,
                   key=lambda s: (CLASS_RANK[s.req.priority], s.req.req_id))

    def _reserve_or_preempt(self, seq, n_tokens) -> bool:
        """Reserve pages for ``seq``, evicting lowest-class-youngest-first
        until it fits. ``seq`` itself is evicted if it is the chosen victim
        (never steal pages from a better-ranked sequence); returns False in
        that case."""
        while True:
            try:
                self.cache.reserve(seq.slot, n_tokens)
                return True
            except OutOfPages:
                victim = self._pick_victim()
                self._preempt(victim)
                if victim is seq:
                    return False

    @property
    def effective_horizon(self) -> int:
        """Decode-horizon token budget per dispatch, after the brownout
        clamp. The *static* trace horizon never changes — a cap only lowers
        the dynamic ``n_left`` budget the device sees, so a capped dispatch
        runs the same compiled scan and just retires fewer tokens."""
        if self.horizon_cap is None:
            return self.decode_horizon
        return max(1, min(self.decode_horizon, int(self.horizon_cap)))

    def _decode_lease(self, seq) -> int:
        """Token positions the next decode dispatch may write for ``seq``:
        a horizon dispatch samples up to ``min(effective_horizon, remaining
        budget)`` tokens, writing K/V for each input token starting at
        ``n_total - 1``, so the lease covers ``n_total - 1 + h`` positions.
        Reserving the whole lease up front is what lets the device cross
        page boundaries mid-horizon with no host intervention (the block
        table already addresses every reserved page). ``decode_horizon=1``
        degenerates to the classic one-position reserve (``n_total``)."""
        h = min(self.effective_horizon,
                seq.req.max_new_tokens - len(seq.generated))
        return seq.n_total - 1 + max(h, 1)

    def _try_decode(self):
        decodes = [s for s in self.running if s.state == DECODE]
        for seq in list(decodes):
            if seq in self.running:        # a peer's reserve may evict it
                self._reserve_or_preempt(seq, self._decode_lease(seq))
        decodes = [s for s in decodes if s in self.running]
        if not decodes:
            return None
        self._last_was_prefill = False
        return ("decode", decodes)

    def _try_prefill(self):
        prefills = [s for s in self.running if s.state == PREFILL]
        if not prefills:
            return None
        seq = prefills[0]
        toks = seq.tokens
        start = seq.cache_len
        chunk = min(self.prefill_chunk, len(toks) - start)
        if not self._reserve_or_preempt(seq, start + chunk):
            return None                    # self-preempted; decode instead
        self._last_was_prefill = True
        return ("prefill", seq, toks[start:start + chunk], start)

    def _try_prefill_packed(self):
        """Pack every runnable PREFILL sequence's next chunk into one
        dispatch (DESIGN.md Sec. 16): segments are assigned in running
        (FIFO-admission) order under a token budget of the largest bucket,
        each segment resuming at its own ``cache_len`` — so prefix-cache
        adoptions pack at the matched boundary and a prompt longer than the
        largest bucket simply continues across successive waves (chunking
        falls out, no special case). Returns
        ``("prefill_packed", [(seq, start, n), ...], bucket)`` with
        ``bucket`` the smallest bucket covering the assigned tokens.

        Reservation order is planning order; a reservation that preempts
        evicts the *youngest* running sequence, which may be a segment
        planned earlier in this very wave — the final membership filter
        drops any segment preemption took back (its reservation was
        released with its slot, so nothing leaks)."""
        if not any(s.state == PREFILL for s in self.running):
            return None
        budget = self.prefill_buckets[-1]
        # crash isolation (set by the supervisor after a crash blamed on a
        # multi-segment packed dispatch): pack one segment per wave so
        # blame — and poison quarantine — stays per-request precise.
        # max_wave_segments is the brownout wave-width cap: fewer segments
        # per wave means a smaller covering bucket, and every bucket is
        # already warmed, so the cap never introduces a new trace.
        if self.isolate_prefill:
            max_segs = 1
        elif self.max_wave_segments is not None:
            max_segs = max(1, min(self.max_batch,
                                  int(self.max_wave_segments)))
        else:
            max_segs = self.max_batch
        segs: List[Tuple[Sequence, int, int]] = []
        used = 0
        for seq in list(self.running):
            if seq.state != PREFILL or seq not in self.running:
                continue
            if len(segs) >= max_segs or used >= budget:
                break
            start = seq.cache_len
            n = min(budget - used, len(seq.tokens) - start)
            if n <= 0:
                continue
            if not self._reserve_or_preempt(seq, start + n):
                continue                   # self-preempted mid-wave
            segs.append((seq, start, n))
            used += n
        segs = [s for s in segs if s[0] in self.running]
        if not segs:
            return None
        used = sum(n for _, _, n in segs)
        bucket = next(b for b in self.prefill_buckets if b >= used)
        self._last_was_prefill = True
        return ("prefill_packed", segs, bucket)

    # -- the policy ----------------------------------------------------------
    def schedule(self):
        """Return the next unit of work, or None when idle:
          ("prefill", seq, chunk_tokens (C,), start_pos)   — one chunk
          ("prefill_packed", [(seq, start, n)], bucket)    — packed wave
          ("decode", [seqs])                               — packed batch

        Alternates prefill/decode when both exist; whichever kind is tried
        first, the other is the fallback, so one failed reservation (which
        preempts the requester) never idles a step that has runnable work.
        """
        self._admit()
        has_decode = any(s.state == DECODE for s in self.running)
        has_prefill = any(s.state == PREFILL for s in self.running)
        prefer_decode = has_decode and (not has_prefill
                                        or self._last_was_prefill)
        prefill = (self._try_prefill_packed if self.prefill_buckets
                   else self._try_prefill)
        order = (self._try_decode, prefill)
        if not prefer_decode:
            order = order[::-1]
        for attempt in order:
            work = attempt()
            if work is not None:
                return work
        return None

    # -- completions ----------------------------------------------------------
    def finish(self, seq):
        seq.state = FINISHED
        self.cache.release(seq.slot)
        seq.slot = -1
        self.running.remove(seq)
