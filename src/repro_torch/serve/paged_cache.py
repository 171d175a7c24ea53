"""Paged KV-cache: a global page pool + per-sequence block tables.

Port of ``repro.serve.paged_cache`` (kv16 and kv_bits 8|4 pools): the
host-side allocator is the reference's, copied; the device work it does —
the fork's page (or hot-row) copy and the block-table upload — is torch on
the engine's device. On a tensor-parallel mesh the pools are rank 0's
(``parallel=``: KV/tp heads a rank where heads split, the reference's
``heads_ok``), and ``remote`` repeats the fork's copy on the other ranks'
pools; the allocator itself, like every host decision, runs once.

The data plane (the pools themselves) is a tree of device tensors written,
in place, by the serving step (models.Model.paged_step); this class is the *control*
plane: a host-side allocator that hands out fixed-size pages from a free
list, maintains the block table and length of every sequence slot, and
reference-counts pages so forked sequences share their common prefix
(copy-on-write only for the final partial page, which is the only page that
can still be written).

Page 0 is reserved as a scratch page: padding rows of the packed batch
scatter their (garbage) K/V there, so the jitted step needs no masking
branches. The allocator never hands page 0 to a sequence.

**Automatic prefix cache** (DESIGN.md Sec. 11). With ``prefix_cache=True``
the allocator keeps a registry of committed, immutable *full* pages keyed
by a rolling content hash of the token chain that produced them (the K/V
of page *i* depends on every token before it, so the hash chains:
``h_i = H(h_{i-1} || tokens[i*ps:(i+1)*ps])``). A registered page whose
refcount drops to zero is *cached-but-alive*: it moves to an LRU list
instead of the free list, and is reclaimed (unregistered + freed) only
under pool pressure — always before any live sequence is preempted. New
sequences longest-prefix-match the registry at admission and adopt the
matched pages by refcount bump, so chunked prefill skips the shared
prefix entirely.

"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch


class OutOfPages(Exception):
    """Raised when a reservation cannot be satisfied (caller preempts)."""


class PageStateError(RuntimeError):
    """An allocator lifecycle invariant was violated (double release,
    commit past the reservation, adopt into a dirty slot). Unlike the bare
    ``assert`` this replaced, it survives ``python -O`` — silently
    corrupting the free list is strictly worse than failing loudly."""


def _chain_digest(prev: bytes, page_tokens: np.ndarray) -> bytes:
    """Rolling hash step: digest of (parent digest, this page's tokens)."""
    h = hashlib.blake2b(prev, digest_size=16)
    h.update(np.ascontiguousarray(page_tokens, np.int32).tobytes())
    return h.digest()


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """A longest-prefix registry hit: ``pages`` (and their chain digests)
    cover the first ``n_tokens`` positions; ``n_unreferenced`` of them are
    currently LRU-cached (refcount 0) and leave the reclaimable set when
    adopted."""
    pages: Tuple[int, ...]
    digests: Tuple[bytes, ...]
    n_tokens: int
    n_unreferenced: int


def copy_pool_page(pools, kind, src, dst):
    """In place: ``kind`` "page" copies page ``src`` to ``dst`` in every
    kv16 pool leaf (n_periods, num_pages, page_size, KV, hd); "hot" copies
    hot row ``src`` to ``dst`` in every ``*_hot`` leaf (n_periods, max_seqs
    + 1, page_size, KV, hd) of quantized pools, whose code and scale pools
    are page-indexed and stay untouched."""
    for slot in pools["layers"].values():
        for name, leaf in slot["attn"].items():
            if kind == "page" or name.endswith("_hot"):
                leaf[:, dst] = leaf[:, src]


class PagedKVCache:
    """Host-side page allocator + device page pools.

    Contract: ``reserve`` is all-or-nothing (raises ``OutOfPages`` with no
    partial allocation), ``commit`` only ever records lengths the caller
    has actually written device-side, ``release`` returns a slot's pages in
    reverse order (LIFO reuse keeps prefixes warm), and ``fork`` shares
    full pages by refcount while copying only the final partial page.
    With ``prefix_cache=True`` a released page that is registered in the
    prefix registry parks on an LRU list instead of the free list;
    ``reserve``/``fork`` reclaim from that list before reporting the pool
    exhausted, so cached pages never cause a preemption.
    ``pools`` is a tree of device tensors owned by the serving step; this
    class never reads it, and writes it only in fork's page copy.
    ``device`` (``None`` = the card) is where the pools and the uploaded
    block-table rows live. ``parallel`` (a ``TPShard``) sizes the pools to
    one rank's; ``remote``, when set, is called as ``remote(kind, src,
    dst)`` after each fork copy (``copy_pool_page``'s kinds) so the other
    ranks copy too.
    """

    def __init__(self, model, *, num_pages, page_size, max_seqs,
                 max_pages_per_seq=None, prefix_cache=False, faults=None,
                 kv_bits=16, device=None, parallel=None):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved scratch)")
        if kv_bits not in (16, 8, 4):
            raise ValueError(f"kv_bits must be 16, 8 or 4, got {kv_bits}")
        if faults is None:
            from .faults import NO_FAULTS
            faults = NO_FAULTS
        self.faults = faults
        self.page_size = int(page_size)
        self.num_pages = int(num_pages)
        self.max_seqs = int(max_seqs)
        self.max_pages_per_seq = int(max_pages_per_seq or num_pages - 1)
        self.prefix_cache = bool(prefix_cache)
        self.kv_bits = int(kv_bits)
        self.pools = model.init_paged_pools(num_pages, page_size,
                                            kv_bits=self.kv_bits,
                                            max_seqs=max_seqs, device=device,
                                            parallel=parallel)
        self.remote = None
        self.device = next(iter(self.pools["layers"]["s0"]["attn"].values())
                           ).device
        # quantization frontier: full pages of each slot whose content is
        # committed into the packed code/scale pools (kv_bits < 16). The
        # device quantizes every page completed by a dispatch, so after the
        # host commit this must equal seq_lens // page_size — "no committed
        # page left unquantized" (check_invariants enforces it).
        self._quant_frontier = np.zeros((max_seqs,), np.int64)
        # host metadata
        self.block_tables = np.zeros((max_seqs, self.max_pages_per_seq),
                                     np.int32)
        self.seq_pages: List[List[int]] = [[] for _ in range(max_seqs)]
        self.seq_lens = np.zeros((max_seqs,), np.int32)
        self.ref_counts = np.zeros((num_pages,), np.int32)
        self.ref_counts[0] = 1                    # scratch page, never freed
        self._free = list(range(num_pages - 1, 0, -1))    # LIFO free list
        self._free_slots = list(range(max_seqs - 1, -1, -1))
        # prefix registry: digest <-> page (one-to-one), LRU of refcount-0
        # registered pages (insertion order == eviction order)
        self._registry: Dict[bytes, int] = {}
        self._page_digest: Dict[int, bytes] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._slot_digests: List[List[bytes]] = [[] for _ in range(max_seqs)]
        self.n_cache_evictions = 0
        # bumped whenever the digest->page mapping changes (register /
        # reclaim); lets callers memoize match_prefix results — an epoch
        # match can only go stale in LRU-membership (avail accounting),
        # never in page validity, and reserve-time OutOfPages + preemption
        # already backstop optimistic admission
        self.registry_epoch = 0
        # block-table row upload cache: slot versions bump on any table
        # mutation, so an unchanged (slots, tables) dispatch reuses the
        # already-transferred device rows instead of re-uploading
        self._versions = np.zeros((max_seqs,), np.int64)
        self._rows_cache: Dict[Tuple[int, ...],
                               Tuple[Tuple[int, ...], torch.Tensor]] = {}

    # -- capacity ----------------------------------------------------------
    @property
    def n_free_pages(self):
        return len(self._free)

    @property
    def n_cached_pages(self):
        """Registered pages no sequence references (reclaimable on demand)."""
        return len(self._lru)

    @property
    def n_available_pages(self):
        """Pages a reservation can obtain: free now + reclaimable LRU."""
        return len(self._free) + len(self._lru)

    @property
    def n_free_slots(self):
        return len(self._free_slots)

    def pages_for(self, n_tokens):
        return -(-int(n_tokens) // self.page_size)

    def fits(self, n_tokens):
        """Whole-sequence capacity check (used at submit/admission time)."""
        return self.capacity_error(n_tokens) is None

    def capacity_error(self, n_tokens) -> Optional[str]:
        """Why ``n_tokens`` can never fit, or None if it can. Names every
        limit the request actually exceeds — a request bounded by
        ``max_pages_per_seq`` must not be told the pool is too small."""
        need = self.pages_for(n_tokens)
        limits = []
        if need > self.max_pages_per_seq:
            limits.append(f"max_pages_per_seq={self.max_pages_per_seq}")
        if need > self.num_pages - 1:
            limits.append(f"the page pool ({self.num_pages - 1} usable "
                          f"pages x {self.page_size})")
        if not limits:
            return None
        return (f"{n_tokens} tokens need {need} pages, exceeding "
                + " and ".join(limits))

    # -- slots -------------------------------------------------------------
    def alloc_slot(self) -> Optional[int]:
        if not self._free_slots:
            return None
        slot = self._free_slots.pop()
        self.seq_pages[slot] = []
        self.seq_lens[slot] = 0
        self.block_tables[slot] = 0
        self._slot_digests[slot] = []
        self._quant_frontier[slot] = 0
        self._versions[slot] += 1
        return slot

    def release(self, slot):
        """Free the slot: decref every page. Dead pages return to the free
        list (reverse order so LIFO reuse stays prefix-friendly) — unless
        registered in the prefix cache, in which case they park on the LRU
        list, content intact, until reclaimed under pressure."""
        for page in reversed(self.seq_pages[slot]):
            if self.ref_counts[page] <= 0:
                raise PageStateError(
                    f"release(slot={slot}): page {page} refcount "
                    f"{int(self.ref_counts[page])} already zero "
                    "(double release?)")
            self.ref_counts[page] -= 1
            if self.ref_counts[page] == 0:
                if page in self._page_digest:
                    self._lru[page] = None       # newest at the end
                else:
                    self._free.append(page)
        self.seq_pages[slot] = []
        self.seq_lens[slot] = 0
        self.block_tables[slot] = 0
        self._slot_digests[slot] = []
        self._quant_frontier[slot] = 0
        self._versions[slot] += 1
        self._free_slots.append(slot)

    # -- pages -------------------------------------------------------------
    def _reclaim(self, n) -> int:
        """Evict up to ``n`` LRU-cached pages back onto the free list
        (oldest first); returns how many were reclaimed."""
        freed = 0
        while freed < n and self._lru:
            page, _ = self._lru.popitem(last=False)
            digest = self._page_digest.pop(page)
            del self._registry[digest]
            self._free.append(page)
            self.n_cache_evictions += 1
            freed += 1
        if freed:
            self.registry_epoch += 1
        return freed

    def shrink_lru(self, floor_pages: int) -> int:
        """Evict LRU-parked prefix pages until at most ``floor_pages``
        remain parked; returns how many were evicted. The brownout ladder's
        cache-pressure lever (DESIGN.md Sec. 17): trading cold prefix
        residency for free pages is host-only bookkeeping — no live
        sequence is touched and no device state moves — so it is always
        safe to apply between steps. A no-op when the park is already at
        or under the floor."""
        excess = len(self._lru) - max(0, int(floor_pages))
        return self._reclaim(excess) if excess > 0 else 0

    def n_covered_tokens(self, slot) -> int:
        """Token positions ``slot``'s reserved pages can hold — the extent
        of its current lease. A decode-horizon dispatch (DESIGN.md Sec. 12)
        may write any position below this without host intervention;
        ``commit`` may trail it when a row stopped early (eos mid-horizon),
        and ``release`` returns trailing never-written pages all the same."""
        return len(self.seq_pages[slot]) * self.page_size

    def reserve(self, slot, n_tokens):
        """Grow ``slot``'s block table to cover ``n_tokens``. All-or-nothing:
        raises OutOfPages without partial allocation if the pool is short
        (after reclaiming LRU-cached prefix pages, which are always spent
        before the caller resorts to preempting a live sequence).

        A reservation is a *lease*: the pages are addressable device-side
        (``table_rows`` uploads the whole row) the moment this returns, so
        a fused multi-token dispatch can fill them without further host
        round trips. Reserved-but-unwritten pages hold stale data until
        written; the attention mask (``kpos < kv_lens``) keeps them
        invisible, and ``commit`` only ever ratifies what was written."""
        need = self.pages_for(n_tokens) - len(self.seq_pages[slot])
        if need <= 0:
            return
        if self.faults.armed:
            # fires before any allocation, so the all-or-nothing contract
            # holds for injected OOM exactly as for real exhaustion
            self.faults.fire("alloc")
        if self.pages_for(n_tokens) > self.max_pages_per_seq:
            raise OutOfPages(f"slot {slot}: {n_tokens} tokens exceed "
                             f"max_pages_per_seq={self.max_pages_per_seq}")
        if need > len(self._free):
            self._reclaim(need - len(self._free))
        if need > len(self._free):
            raise OutOfPages(f"slot {slot}: need {need} pages, "
                             f"{len(self._free)} free")
        for _ in range(need):
            page = self._free.pop()
            self.ref_counts[page] += 1
            self.block_tables[slot, len(self.seq_pages[slot])] = page
            self.seq_pages[slot].append(page)
        self._versions[slot] += 1

    def commit(self, slot, n_tokens):
        """Record that ``n_tokens`` of ``slot`` are now written device-side."""
        if self.pages_for(n_tokens) > len(self.seq_pages[slot]):
            raise PageStateError(
                f"commit(slot={slot}, n_tokens={n_tokens}): only "
                f"{len(self.seq_pages[slot])} pages reserved "
                f"({len(self.seq_pages[slot]) * self.page_size} tokens)")
        self.seq_lens[slot] = n_tokens
        # the dispatch that wrote these tokens also quantized every page it
        # completed (quantize-on-commit), so the frontier rides the commit
        self._quant_frontier[slot] = int(n_tokens) // self.page_size

    # -- prefix registry ---------------------------------------------------
    def register_prefix(self, slot, tokens):
        """Register ``slot``'s committed full pages under the rolling hash
        of ``tokens`` (the committed token chain, ``tokens[:seq_lens]``).
        Idempotent and incremental: the per-slot digest chain is extended
        only for newly-filled pages, so per-step decode calls are O(new
        pages), not O(sequence length). First-writer-wins: a digest already
        mapping to an equal-content page is left alone."""
        if not self.prefix_cache:
            return
        ps = self.page_size
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        n_full = min(len(tokens) // ps, len(self.seq_pages[slot]))
        digests = self._slot_digests[slot]
        prev = digests[-1] if digests else b""
        for i in range(len(digests), n_full):
            prev = _chain_digest(prev, tokens[i * ps:(i + 1) * ps])
            digests.append(prev)
            page = self.seq_pages[slot][i]
            if prev not in self._registry and page not in self._page_digest:
                self._registry[prev] = page
                self._page_digest[page] = prev
                self.registry_epoch += 1

    def match_prefix(self, tokens, max_tokens=None) -> Optional[PrefixMatch]:
        """Longest-prefix registry lookup for a token chain. Pure (no
        allocator mutation); returns None when disabled or nothing matches.
        ``max_tokens`` caps the match (admission passes ``len(tokens)-1``
        so at least one position is always left to prefill — the sampler
        needs its logits)."""
        if not self.prefix_cache or not self._registry:
            return None
        ps = self.page_size
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        limit = len(tokens) if max_tokens is None else min(len(tokens),
                                                           int(max_tokens))
        n_full = min(limit // ps, self.max_pages_per_seq)
        pages, digests = [], []
        prev = b""
        for i in range(n_full):
            prev = _chain_digest(prev, tokens[i * ps:(i + 1) * ps])
            page = self._registry.get(prev)
            if page is None:
                break
            pages.append(page)
            digests.append(prev)
        if not pages:
            return None
        n_unref = sum(1 for p in pages if p in self._lru)
        return PrefixMatch(tuple(pages), tuple(digests),
                           len(pages) * ps, n_unref)

    def adopt_prefix(self, slot, match: PrefixMatch):
        """Bump the matched pages into ``slot``'s block table and record
        their content as committed (it already is, device-side). The slot
        must be freshly allocated — adopted pages are always a sequence's
        first pages (position 0 onward), by construction of the hash chain.
        """
        if self.seq_pages[slot]:
            raise PageStateError(f"adopt_prefix(slot={slot}): slot already "
                                 f"holds {len(self.seq_pages[slot])} pages")
        for i, page in enumerate(match.pages):
            self._lru.pop(page, None)            # referenced again
            self.ref_counts[page] += 1
            self.block_tables[slot, i] = page
            self.seq_pages[slot].append(page)
        self._slot_digests[slot] = list(match.digests)
        self.seq_lens[slot] = match.n_tokens
        # adopted pages are committed full pages: under kv_bits < 16 their
        # content already lives quantized in the packed pools
        self._quant_frontier[slot] = match.n_tokens // self.page_size
        self._versions[slot] += 1

    # -- prefix sharing ----------------------------------------------------
    def fork(self, src_slot) -> Optional[int]:
        """Fork ``src_slot``: full pages are shared by refcount; a partial
        final page is copied device-side (copy-on-write at fork time — full
        pages are never written again, so sharing them is safe). Returns
        None, with no slot or page leaked, when slots are exhausted or the
        partial-page copy cannot get a page even after reclaiming the
        prefix-cache LRU."""
        dst = self.alloc_slot()
        if dst is None:
            return None
        n = int(self.seq_lens[src_slot])
        n_full = n // self.page_size
        partial = n % self.page_size > 0
        if partial and not self._free and not self._reclaim(1):
            self.release(dst)
            return None
        try:
            for i, page in enumerate(self.seq_pages[src_slot][:n_full]):
                self.ref_counts[page] += 1
                self.block_tables[dst, i] = page
                self.seq_pages[dst].append(page)
            if partial:
                page = self._free.pop()
                self.ref_counts[page] += 1
                self.block_tables[dst, n_full] = page
                self.seq_pages[dst].append(page)
                if self.kv_bits == 16:
                    self._copy_page(self.seq_pages[src_slot][n_full], page)
                else:
                    # quantized pools keep the partial page in the slot's
                    # hot row; the packed page just allocated is address
                    # space for its eventual commit. Copy the hot row.
                    self._copy_hot(src_slot + 1, dst + 1)
        except Exception:
            self.release(dst)
            raise
        self.seq_lens[dst] = n
        self._quant_frontier[dst] = n // self.page_size
        self._slot_digests[dst] = self._slot_digests[src_slot][:n_full]
        self._versions[dst] += 1
        return dst

    def _copy_page(self, src, dst):
        copy_pool_page(self.pools, "page", src, dst)
        if self.remote is not None:
            self.remote("page", src, dst)

    def _copy_hot(self, src_row, dst_row):
        copy_pool_page(self.pools, "hot", src_row, dst_row)
        if self.remote is not None:
            self.remote("hot", src_row, dst_row)

    # -- packed-batch views -------------------------------------------------
    def table_rows(self, slots):
        """Device block-table rows for the given slots, zero-padded to the
        packed batch size implied by ``len(slots)`` (-1 slots = pad rows).
        Each row carries the slot's *entire* reservation — every leased
        page, committed or not — which is what lets a decode-horizon
        dispatch cross page boundaries mid-scan with no host intervention
        (DESIGN.md Sec. 12). Memoized on (slots, per-slot table versions):
        the steady-state decode loop re-dispatches the same rows every
        step, so the (B, max_pages_per_seq) host build + transfer happens
        only when a slot's table actually changed."""
        key = tuple(int(s) for s in slots)
        vers = tuple(int(self._versions[s]) if s >= 0 else -1 for s in key)
        hit = self._rows_cache.get(key)
        if hit is not None and hit[0] == vers:
            return hit[1]
        rows = np.zeros((len(key), self.max_pages_per_seq), np.int32)
        for i, s in enumerate(key):
            if s >= 0:
                rows[i] = self.block_tables[s]
        dev = torch.from_numpy(rows).to(self.device)
        if len(self._rows_cache) >= 256:          # bound stale batch shapes
            self._rows_cache.clear()
        self._rows_cache[key] = (vers, dev)
        return dev

    # -- invariants ----------------------------------------------------------
    def check_invariants(self, expect_idle: bool = False):
        """Full-state allocator audit; raises ``PageStateError`` naming the
        first violated invariant, returns None when consistent.

        Checks: the refcount of every page equals its occurrence count
        across live block tables (scratch page 0 pinned at 1, LRU-parked
        pages at 0); the free list is duplicate-free and disjoint from
        every live table, the LRU and the registry; every usable page is
        in exactly one of {free, LRU-cached, referenced} — conservation,
        i.e. zero leaked pages; block-table rows mirror ``seq_pages``;
        committed lengths fit inside reserved leases; the registry and its
        page->digest inverse are a bijection and the LRU is a subset of the
        registered refcount-0 pages; free slots are duplicate-free with
        fully cleared state. Under ``kv_bits < 16`` additionally: every live
        slot's quantization frontier equals its committed full-page count
        (no committed page left unquantized, none quantized ahead of
        commit) and fits its lease; free slots sit at frontier 0.

        ``expect_idle=True`` additionally requires no live sequence at all
        — every slot free and every usable page free or LRU-reclaimable,
        the post-drain / teardown baseline the chaos tests assert.

        This is the ground truth the supervisor's recovery story leans on:
        an engine incarnation that crashed mid-mutation is *discarded*,
        never repaired, precisely because this audit can only certify a
        pool that finished its bookkeeping."""
        def fail(msg):
            raise PageStateError(f"check_invariants: {msg}")

        live = [s for s in range(self.max_seqs) if s not in self._free_slots]
        if len(set(self._free_slots)) != len(self._free_slots):
            fail(f"duplicate slots on the free-slot list: {self._free_slots}")
        for s in self._free_slots:
            if self.seq_pages[s] or self.seq_lens[s] or self._slot_digests[s]:
                fail(f"free slot {s} still holds state: "
                     f"pages={self.seq_pages[s]}, "
                     f"len={int(self.seq_lens[s])}")
            if self._quant_frontier[s] != 0:
                fail(f"free slot {s} has nonzero quant frontier "
                     f"{int(self._quant_frontier[s])}")
        # refcount reconstruction from live block tables (+ scratch pin)
        expected = np.zeros((self.num_pages,), np.int64)
        expected[0] = 1
        for s in live:
            pages = self.seq_pages[s]
            for i, p in enumerate(pages):
                if not 1 <= p < self.num_pages:
                    fail(f"slot {s} holds invalid page id {p}")
                expected[p] += 1
                if self.block_tables[s, i] != p:
                    fail(f"block_tables[{s}, {i}] = "
                         f"{int(self.block_tables[s, i])} but seq_pages "
                         f"says page {p}")
            if np.any(self.block_tables[s, len(pages):] != 0):
                fail(f"slot {s}: block-table tail past its {len(pages)} "
                     "pages is not zeroed")
            if self.seq_lens[s] > len(pages) * self.page_size:
                fail(f"slot {s}: committed length {int(self.seq_lens[s])} "
                     f"exceeds its lease of {len(pages)} pages "
                     f"({len(pages) * self.page_size} tokens)")
            if len(self._slot_digests[s]) > len(pages):
                fail(f"slot {s}: {len(self._slot_digests[s])} chain digests "
                     f"for {len(pages)} pages")
            if self.kv_bits < 16:
                fr = int(self._quant_frontier[s])
                want = int(self.seq_lens[s]) // self.page_size
                if fr < want:
                    fail(f"slot {s}: committed pages left unquantized — "
                         f"quant frontier {fr} behind {want} committed full "
                         f"pages (kv_bits={self.kv_bits})")
                if fr > want:
                    fail(f"slot {s}: quant frontier {fr} ahead of {want} "
                         "committed full pages — pages marked quantized "
                         "that were never committed")
                if fr > len(pages):
                    fail(f"slot {s}: quant frontier {fr} exceeds its lease "
                         f"of {len(pages)} pages")
        mism = [p for p in range(self.num_pages)
                if int(self.ref_counts[p]) != int(expected[p])]
        if mism:
            p = mism[0]
            fail(f"page {p}: refcount {int(self.ref_counts[p])} but "
                 f"{int(expected[p])} live references reconstruct "
                 f"({len(mism)} pages disagree)")
        # free list: unique, refcount 0, unregistered, not scratch
        free = set(self._free)
        if len(free) != len(self._free):
            fail("duplicate pages on the free list")
        if 0 in free:
            fail("scratch page 0 is on the free list")
        for p in self._free:
            if self.ref_counts[p] != 0:
                fail(f"free page {p} has refcount {int(self.ref_counts[p])}")
            if p in self._page_digest:
                fail(f"free page {p} is still registered in the prefix "
                     "registry")
        # registry <-> page digest bijection; LRU subset of registered@0
        if len(self._registry) != len(self._page_digest):
            fail(f"registry has {len(self._registry)} digests but "
                 f"{len(self._page_digest)} pages carry one")
        for digest, p in self._registry.items():
            if self._page_digest.get(p) != digest:
                fail(f"registry maps digest->page {p} but page maps back "
                     f"to a different digest")
        for p in self._lru:
            if p not in self._page_digest:
                fail(f"LRU page {p} is not registered")
            if self.ref_counts[p] != 0:
                fail(f"LRU page {p} has refcount {int(self.ref_counts[p])}")
            if p in free:
                fail(f"page {p} is on both the LRU and the free list")
        # conservation: every usable page in exactly one of the three states
        referenced = {p for p in range(1, self.num_pages)
                      if self.ref_counts[p] > 0}
        lru = set(self._lru)
        if free & referenced:
            fail(f"pages both free and referenced: {sorted(free & referenced)}")
        n_accounted = len(free) + len(lru) + len(referenced)
        if n_accounted != self.num_pages - 1:
            missing = (set(range(1, self.num_pages))
                       - free - lru - referenced)
            fail(f"page conservation violated: {len(free)} free + "
                 f"{len(lru)} cached + {len(referenced)} referenced = "
                 f"{n_accounted}, expected {self.num_pages - 1} "
                 f"(leaked: {sorted(missing)})")
        if expect_idle:
            if live:
                fail(f"expected idle pool but slots {live} are live")
            if referenced:
                fail(f"expected idle pool but pages {sorted(referenced)} "
                     "are still referenced (leak)")
