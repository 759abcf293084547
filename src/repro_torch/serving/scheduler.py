"""Continuous-batching scheduler: request queue, slot state machine,
per-step admission/eviction, and block-exhaustion preemption.

The scheduler is pure host-side bookkeeping (deterministic Python over the
numpy prompt arrays) — it never touches device memory.  Each engine step it
produces a :class:`StepPlan`:

* **admissions** — FCFS by arrival.  A request is admitted when a slot is
  free and (for a preempted request resuming) every page it held can be
  re-allocated; the engine then swaps its saved pages back in.  With
  ``prefix_caching`` on, a fresh admission first adopts the longest cached
  prefix of its prompt (ref-counted page sharing + copy-on-write at a
  mid-page divergence) and chunked prefill starts at the first uncached
  token — see `_attach_prefix` / `BlockAllocator.lookup_prefix`.
* **prefill chunks** — up to ``max_prefills`` requests that still have
  prompt tokens uncached each get their next ``prefill_chunk`` tokens, in
  strict ``(arrival, uid)`` order (the one-prefill-per-step FCFS limit of
  the two-call engine is lifted; the first candidate that cannot reserve
  pages stops the scan so later arrivals never prefill past it).  Prefill
  is chunked *between* decode steps rather than bucket-padded up front, so
  a long prompt never stalls the running batch for more than one chunk.
  Non-final chunk ends are aligned down to multiples of
  ``transform_window`` so a chunk never splits a STaMP transform block
  mid-window (window ≤ chunk; a window larger than the chunk cannot be
  aligned — the per-chunk sequence transform spans the whole chunk anyway,
  so there is no intra-chunk window to preserve and the chunk is scheduled
  unaligned).
* **the decode batch** — every RUNNING slot decodes one token.  Requests
  join and leave this batch at step granularity; there is no lockstep
  bucket.

Together these form one **ragged step**: each planned prefill chunk is a
query span of ``end - start`` tokens and each RUNNING slot a span of one
token; :meth:`Scheduler.plan_step` returns the per-span ``(query_start,
query_len)`` metadata (`StepPlan.spans`) over the flattened token batch
that `serving/engine.py` hands to `models/lm.paged_unified_step` as a
single device program.

Hybrid stacks (Mamba + attention) add a second state family: per-slot
conv/SSM state, fixed-size per request (``SchedulerConfig.
state_bytes_per_slot``).  Admission already gates on a free slot, which is
exactly the capacity unit of that family — so admission needs no extra
arithmetic, and a preemption victim's SSM state swaps to host *together
with* its pages (the engine's swap callbacks read ``sreq.slot``, which is
still assigned at swap-out time and re-assigned before swap-in).  A stack
with no attention layers (``needs_kv_pages=False``) skips page reservation
entirely — decode can then never be preempted, because a running request's
footprint stops growing once its slot is held.

Preemption: when a decode step needs a fresh page and the pools are
exhausted, the victim is the **latest-admitted** active request (vLLM's
priority rule — earlier arrivals are never starved by later ones).  Pages
reserved ahead of the victim's materialized prefix (a prefill chunk's
reservation not yet executed) are released empty; the rest are swapped to
host memory via the engine callback *before* they are freed, and the
request re-enters the waiting queue at its original arrival rank.  On
resume the saved pages are swapped back in at whatever page ids are then
free — block tables indirect through the pools, so placement is
irrelevant — and generation continues from the exact cache state it was
evicted with (bit-identical, no recompute).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, List, Optional

import numpy as np

from repro_torch.serving.paged_kvcache import (BlockAllocator, OutOfBlocks,
                                         PagedCacheConfig)

WAITING = "waiting"
PREFILLING = "prefilling"
RUNNING = "running"
FINISHED = "finished"
FAILED = "failed"
CANCELLED = "cancelled"
REJECTED = "rejected"

#: States a request never leaves.  Every submitted request ends in exactly
#: one of these; the engine's run() loop terminates when all have.
TERMINAL = (FINISHED, FAILED, CANCELLED, REJECTED)


@dataclasses.dataclass
class SchedRequest:
    """Scheduler-side state for one engine request."""

    uid: int
    prompt: np.ndarray               # (len,) int32
    max_new_tokens: int
    arrival: int                     # FCFS rank (never changes)
    state: str = WAITING
    slot: int = -1
    pos: int = 0                     # tokens materialized in the cache
    generated: List[int] = dataclasses.field(default_factory=list)
    hi_pages: List[int] = dataclasses.field(default_factory=list)
    lo_pages: List[int] = dataclasses.field(default_factory=list)
    swapped: Optional[dict] = None   # host-side pages while preempted
    admit_seq: int = -1              # preemption priority (latest = victim)
    preemptions: int = 0
    prefix_matched: int = 0          # tokens served from the prefix cache
    error: Optional[str] = None      # set when state is FAILED / REJECTED

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    def pages_for(self, pos: int, cfg: PagedCacheConfig) -> tuple[int, int]:
        """(hi, lo) page counts needed to hold positions [0, pos)."""
        bs = cfg.block_size
        hi_tokens = min(pos, cfg.num_hi)
        lo_tokens = pos - hi_tokens
        return -(-hi_tokens // bs), -(-lo_tokens // bs)


@dataclasses.dataclass
class PrefillWork:
    """One planned prefill chunk: ``sreq.prompt[start:end]`` runs this step
    (pages for [0, end) are already reserved)."""

    sreq: SchedRequest
    start: int
    end: int


@dataclasses.dataclass
class StepPlan:
    admitted: List[SchedRequest]
    resumed: List[SchedRequest]      # subset of admitted that swapped back in
    prefills: List[PrefillWork]      # FCFS-ordered chunks, ≤ max_prefills
    decode: List[SchedRequest]       # RUNNING slots, slot-index order
    preempted: List[SchedRequest]    # evicted (already swapped out + freed)

    @property
    def prefill(self) -> Optional[SchedRequest]:
        """Two-call compatibility view: the single FCFS prefill candidate."""
        return self.prefills[0].sreq if self.prefills else None

    def spans(self) -> List[tuple]:
        """Ragged metadata for the flattened unified batch:
        ``(uid, query_start, query_len)`` per span — prefill chunks first
        (in plan order), then one 1-token span per decode slot.  Offsets are
        cumulative over the flattened token stream."""
        out, off = [], 0
        for w in self.prefills:
            out.append((w.sreq.uid, off, w.end - w.start))
            off += w.end - w.start
        for sreq in self.decode:
            out.append((sreq.uid, off, 1))
            off += 1
        return out


@dataclasses.dataclass
class SchedulerConfig:
    max_slots: int = 8
    prefill_chunk: int = 64
    max_prefills: int = 1            # prefill chunks per (unified) step
    transform_window: int = 1        # align non-final chunk ends to this
    # Hybrid / SSM accounting: a slot pins `state_bytes_per_slot` of HBM the
    # moment a request is admitted (per-slot conv + SSM state across every
    # Mamba layer) — a *fixed* cost, independent of request length, so the
    # free-slot gate in `_admit` IS the capacity check for this state
    # family and no admission arithmetic consumes the number: it is
    # recorded here (set by the engine from the allocated pools) purely
    # for observability — stats and the serving bench report it.  Pages
    # only ever cover the attention layers; a stack with none at all
    # (pure SSM) sets `needs_kv_pages=False`: reservation and
    # preemption-by-page-exhaustion are then no-ops — the only capacity
    # dimension is the slot count.
    state_bytes_per_slot: int = 0
    needs_kv_pages: bool = True
    # High-watermark early preemption: when page-pool occupancy exceeds this
    # fraction of total capacity, the latest arrival is evicted *before*
    # anything actually runs out — exhaustion becomes a planned degradation
    # (one clean swap-out between steps) instead of a mid-reservation
    # scramble.  1.0 disables the watermark (preempt only on true
    # exhaustion, the pre-robustness behavior).
    preempt_watermark: float = 1.0
    # Prefix caching: on fresh admission, look up the longest cached prefix
    # of the prompt (BlockAllocator's hash-addressed page store) and start
    # chunked prefill at the first uncached token, sharing the covered
    # pages by ref count.  Off by default so direct-Scheduler callers are
    # unaffected; `PagedServingEngine` turns it on (and registers completed
    # prompt pages after every chunk).
    prefix_caching: bool = False


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, cache_cfg: PagedCacheConfig,
                 swap_out: Callable[[SchedRequest], None],
                 swap_in: Callable[[SchedRequest], None],
                 cow: Optional[Callable[[SchedRequest, str, int, int],
                                        None]] = None,
                 on_prefix: Optional[Callable] = None):
        self.cfg = cfg
        self.cache_cfg = cache_cfg
        self.alloc = BlockAllocator(cache_cfg)
        self._swap_out = swap_out
        self._swap_in = swap_in
        # copy-on-write device copy: cow(sreq, pool, src_page, dst_page)
        # duplicates one physical page before the request's first divergent
        # write; on_prefix(sreq, match_or_None) observes every lookup
        self._cow = cow
        self._on_prefix = on_prefix
        self.waiting: List[SchedRequest] = []    # sorted by (arrival, uid)
        self.active: List[SchedRequest] = []     # PREFILLING | RUNNING
        # min-heap: O(log n) admission instead of pop(0) + sort(), and the
        # lowest-free-slot-first placement stays deterministic at high slot
        # counts (an ascending range is already a valid heap)
        self._free_slots = list(range(cfg.max_slots))
        self._admit_counter = 0
        self.num_preemptions = 0
        self._step_preempted: List[SchedRequest] = []

    # ------------------------------------------------------------------
    def submit(self, sreq: SchedRequest) -> None:
        self.waiting.append(sreq)
        # (arrival, uid): equal-arrival submissions keep a reproducible
        # order instead of whatever the sort happens to preserve
        self.waiting.sort(key=lambda r: (r.arrival, r.uid))

    def has_work(self) -> bool:
        return bool(self.waiting or self.active)

    # ------------------------------------------------------------------
    def plan_step(self) -> StepPlan:
        self._step_preempted: List[SchedRequest] = []
        admitted, resumed = self._admit()
        self._apply_watermark(skip=admitted)
        prefills = self._pick_prefills()
        self._ensure_decode_capacity()
        decode = sorted((r for r in self.active if r.state == RUNNING),
                        key=lambda r: r.slot)
        # a decode-capacity preemption can evict a planned prefill candidate
        prefills = [w for w in prefills if w.sreq.state == PREFILLING]
        return StepPlan(admitted=admitted, resumed=resumed,
                        prefills=prefills, decode=decode,
                        preempted=self._step_preempted)

    def finish(self, sreq: SchedRequest) -> None:
        sreq.state = FINISHED
        self._release(sreq)

    def fail(self, sreq: SchedRequest, error: str) -> None:
        """Move one request to FAILED and return every resource it holds —
        the batch keeps running; nothing else is touched."""
        sreq.state = FAILED
        sreq.error = error
        self._release(sreq)

    def cancel(self, uid: int, state: str = CANCELLED,
               error: Optional[str] = None) -> Optional[SchedRequest]:
        """Terminate a request by uid wherever it currently is — waiting,
        mid-prefill, running, or preempted-with-swapped-pages — releasing
        exactly the slot/pages it holds.  Returns the request, or None if
        the uid is unknown or already terminal."""
        for sreq in self.active + self.waiting:
            if sreq.uid == uid:
                sreq.state = state
                sreq.error = error
                self._release(sreq)
                return sreq
        return None

    def quiescent(self) -> bool:
        """True when nothing is queued or active and every resource is back
        in its pool: all slots free, all pages free.  The chaos suite's
        no-leak invariant."""
        return (not self.waiting and not self.active
                and len(self._free_slots) == self.cfg.max_slots
                and self.alloc.all_free())

    def load(self) -> dict:
        """Occupancy snapshot for the engine's per-step gauges: queue
        depths, free decode slots, and free pages per pool family."""
        free_hi, free_lo = self.alloc.free_counts()
        return {"waiting": len(self.waiting),
                "active": len(self.active),
                "free_slots": len(self._free_slots),
                "free_hi_pages": free_hi,
                "free_lo_pages": free_lo}

    def _release(self, sreq: SchedRequest) -> None:
        """Return everything a request holds: its slot (if placed), its
        device pages (if any — including pages reserved ahead of the
        materialized prefix, which is why this must free the *lists*, not
        a pages_for() recomputation), and its host-side swap copy."""
        if sreq in self.active:
            self.active.remove(sreq)
            heapq.heappush(self._free_slots, sreq.slot)
            sreq.slot = -1
        elif sreq in self.waiting:
            self.waiting.remove(sreq)
        self.alloc.free(sreq.hi_pages, sreq.lo_pages)
        sreq.hi_pages, sreq.lo_pages = [], []
        sreq.swapped = None

    # ------------------------------------------------------------------
    def _admit(self) -> tuple[List[SchedRequest], List[SchedRequest]]:
        admitted, resumed = [], []
        while self.waiting and self._free_slots:
            sreq = self.waiting[0]
            if sreq.swapped is not None:
                nh, nl = self._pages_for(sreq, sreq.pos)
                if not self.alloc.can_allocate(nh, nl):
                    break            # resume needs every page back at once
                self.waiting.pop(0)
                sreq.hi_pages = [self.alloc.alloc_hi() for _ in range(nh)]
                sreq.lo_pages = [self.alloc.alloc_lo() for _ in range(nl)]
                self._place(sreq)
                self._swap_in(sreq)
                sreq.swapped = None
                sreq.state = RUNNING if sreq.pos >= sreq.prompt_len \
                    else PREFILLING
                resumed.append(sreq)
            else:
                self.waiting.pop(0)
                self._place(sreq)
                sreq.state = PREFILLING
                self._attach_prefix(sreq)
            admitted.append(sreq)
        return admitted, resumed

    # -- prefix caching -------------------------------------------------
    def prefix_quantum(self) -> int:
        """Prefix-match granularity: the *aligned* chunk length.  Every
        cache-off non-final chunk spans exactly this many tokens
        (`_align_chunk_end`), so a match that is a multiple of it restarts
        prefill on a boundary the cache-off engine would also have used —
        identical chunk splits mean identical online-softmax merge order,
        which is what makes cache-on tokens bit-identical."""
        c, w = self.cfg.prefill_chunk, self.cfg.transform_window
        return (c // w) * w if 1 < w <= c else c

    def _prefix_on(self) -> bool:
        return self.cfg.prefix_caching and self.cfg.needs_kv_pages

    def probe_prefix(self, prompt: np.ndarray) -> int:
        """Side-effect-free: tokens a fresh admission of ``prompt`` would
        serve from the cache right now — the submit-time capacity check's
        prefix credit."""
        if not self._prefix_on():
            return 0
        prompt = np.asarray(prompt)
        limit = max(int(prompt.shape[0]) - 1, 0)
        return self.alloc.peek_prefix(prompt, limit, self.prefix_quantum())

    def _attach_prefix(self, sreq: SchedRequest) -> None:
        """Fresh admission: adopt the longest cached prefix of the prompt.
        The match is capped at ``prompt_len - 1`` so at least one prompt
        token always runs through prefill (the final chunk computes the
        first sampled logit).  A match ending mid-page triggers
        copy-on-write: the partial page is duplicated (engine device copy)
        before this request's first chunk scatters into it, and the shared
        original's reference is dropped."""
        if not self._prefix_on():
            return
        limit = sreq.prompt_len - 1
        m = self.alloc.lookup_prefix(sreq.prompt, limit,
                                     self.prefix_quantum()) \
            if limit > 0 else None
        if self._on_prefix is not None:
            self._on_prefix(sreq, m)
        if m is None:
            return
        if m.cow is not None:
            pool, idx = m.cow
            pages = m.hi_pages if pool == "hi" else m.lo_pages
            src = pages[idx]
            try:
                dst = self.alloc.alloc_hi() if pool == "hi" \
                    else self.alloc.alloc_lo()
            except OutOfBlocks:
                # raced out of the copy page lookup_prefix checked for:
                # fall back to an uncached start rather than fail
                self.alloc.release(m.hi_pages, m.lo_pages)
                return
            if self._cow is not None:
                self._cow(sreq, pool, src, dst)
            pages[idx] = dst
            self.alloc.release([src] if pool == "hi" else [],
                               [src] if pool == "lo" else [])
        sreq.hi_pages = m.hi_pages
        sreq.lo_pages = m.lo_pages
        sreq.pos = m.matched
        sreq.prefix_matched = m.matched

    def register_prefix(self, sreq: SchedRequest) -> int:
        """Register the request's fully-materialized prompt pages in the
        prefix cache (the engine calls this after every completed prefill
        chunk, before any release).  Returns new registrations."""
        if not self._prefix_on():
            return 0
        return self.alloc.register_prefix(sreq.prompt, sreq.pos,
                                          sreq.hi_pages, sreq.lo_pages)

    def _place(self, sreq: SchedRequest) -> None:
        sreq.slot = heapq.heappop(self._free_slots)
        sreq.admit_seq = self._admit_counter
        self._admit_counter += 1
        self.active.append(sreq)

    def _align_chunk_end(self, sreq: SchedRequest, end: int) -> int:
        """Transform-aware chunk boundary: align a *non-final* chunk end
        down to a multiple of ``transform_window`` tokens from the chunk
        start, so the per-chunk STaMP sequence transform never operates on
        a split transform block.  Chunk starts stay aligned by induction
        (every earlier non-final chunk had aligned length).  The final
        chunk keeps the exact prompt end.  window > chunk budget cannot be
        aligned — the per-chunk transform covers the whole chunk, so there
        is no intra-chunk window to preserve and the end is kept as is
        (the documented fallback)."""
        w = self.cfg.transform_window
        if w <= 1 or end >= sreq.prompt_len:
            return end
        span = (end - sreq.pos) // w * w
        return sreq.pos + span if span > 0 else end

    def _apply_watermark(self, skip: List[SchedRequest]) -> None:
        """High-watermark early preemption (``preempt_watermark`` < 1.0):
        while page occupancy exceeds the watermark fraction, swap out the
        latest-admitted page-holder so upcoming reservations find planned
        headroom instead of hitting exhaustion mid-plan.  Requests admitted
        *this step* are exempt — evicting one the same step it came in
        would thrash swap-in/swap-out without ever making progress."""
        wm = self.cfg.preempt_watermark
        if wm >= 1.0 or not self.cfg.needs_kv_pages:
            return
        cap_hi, cap_lo = self.alloc.capacity()
        total = cap_hi + cap_lo
        if total == 0:
            return
        while True:
            # evictable (zero-ref cached) pages count as headroom: they are
            # reclaimed inside alloc_* on demand, so cache occupancy alone
            # must never trigger a preemption
            avail_hi, avail_lo = self.alloc.available_counts()
            if total - avail_hi - avail_lo <= wm * total:
                return
            cands = [r for r in self.active
                     if (r.hi_pages or r.lo_pages) and r not in skip]
            if len(cands) <= 1:
                return               # never evict the only page-holder
            self._preempt(max(cands, key=lambda r: (r.arrival, r.uid)))

    def _pick_prefills(self) -> List[PrefillWork]:
        """Strict FCFS over PREFILLING requests, ``(arrival, uid)`` order:
        up to ``max_prefills`` of them get a chunk this step.  The first
        candidate that cannot reserve its pages stops the scan — a later
        arrival never prefills past an earlier blocked one."""
        cands = sorted((r for r in self.active if r.state == PREFILLING),
                       key=lambda r: (r.arrival, r.uid))
        out: List[PrefillWork] = []
        for sreq in cands[: self.cfg.max_prefills]:
            if sreq.state != PREFILLING:
                continue             # preempted by an earlier reservation
            end = min(sreq.pos + self.cfg.prefill_chunk, sreq.prompt_len)
            end = self._align_chunk_end(sreq, end)
            if not self._reserve(sreq, end):
                break
            out.append(PrefillWork(sreq, sreq.pos, end))
        return out

    def _ensure_decode_capacity(self) -> None:
        """Every RUNNING slot writes one token this step; make sure the page
        holding that position exists.  On exhaustion the latest arrival is
        evicted — possibly the requester itself, if nothing younger holds
        pages (earlier arrivals are never sacrificed for later ones)."""
        for sreq in sorted((r for r in self.active if r.state == RUNNING),
                           key=lambda r: r.arrival):
            if sreq.state != RUNNING:
                continue             # preempted earlier in this very loop
            if not self._reserve(sreq, sreq.pos + 1):
                # no younger page-holder exists, so sreq is the youngest:
                # swap itself out rather than rob an earlier arrival
                self._preempt(sreq)

    def _pages_for(self, sreq: SchedRequest, pos: int) -> tuple[int, int]:
        """Page demand for positions [0, pos) — zero for a pageless stack
        (pure SSM: the per-slot state is the whole cache and is already
        accounted by the slot the request holds)."""
        if not self.cfg.needs_kv_pages:
            return 0, 0
        return sreq.pages_for(pos, self.cache_cfg)

    def _reserve(self, sreq: SchedRequest, upto: int) -> bool:
        """Grow the request's page lists to cover positions [0, upto),
        preempting later arrivals as needed."""
        nh, nl = self._pages_for(sreq, upto)
        need_hi = nh - len(sreq.hi_pages)
        need_lo = nl - len(sreq.lo_pages)
        if need_hi <= 0 and need_lo <= 0:
            return True
        while not self.alloc.can_allocate(max(need_hi, 0), max(need_lo, 0)):
            victim = self._pick_victim(exclude=sreq, after=sreq.arrival)
            if victim is None:
                # Nobody younger holds pages.  This used to raise
                # OutOfBlocks when sreq was alone (tearing down the whole
                # engine); capacity-infeasible requests are now rejected at
                # submit() and anything else that lands here — injected
                # exhaustion, a transiently blocked resume — is a per-step
                # "no" the caller degrades around (preempt-self / wait),
                # with the engine watchdog as the livelock backstop.
                return False
            self._preempt(victim)
        sreq.hi_pages += [self.alloc.alloc_hi() for _ in range(need_hi)]
        sreq.lo_pages += [self.alloc.alloc_lo() for _ in range(need_lo)]
        return True

    def _pick_victim(self, exclude: Optional[SchedRequest],
                     after: Optional[int] = None) -> Optional[SchedRequest]:
        cands = [r for r in self.active
                 if r is not exclude and (r.hi_pages or r.lo_pages)]
        if after is not None:
            cands = [r for r in cands if r.arrival > after]
        if not cands:
            return None
        # (arrival, uid): equal-arrival candidates evict reproducibly —
        # `max` alone would pick whichever tied request came first in the
        # active list, an artifact of admission history
        return max(cands, key=lambda r: (r.arrival, r.uid))

    def _preempt(self, victim: SchedRequest) -> None:
        # A prefill reservation runs ahead of execution (`_pick_prefill`
        # covers [0, end) while only [0, pos) is materialized), so a victim
        # caught mid-plan can hold more pages than its materialized prefix.
        # Those extra pages carry no data: release them before the swap so
        # the saved page set always equals the pages_for(pos) re-allocation
        # at resume (extract/insert page counts must agree).
        nh, nl = self._pages_for(victim, victim.pos)
        extra_hi, extra_lo = victim.hi_pages[nh:], victim.lo_pages[nl:]
        if extra_hi or extra_lo:
            victim.hi_pages = victim.hi_pages[:nh]
            victim.lo_pages = victim.lo_pages[:nl]
            self.alloc.free(extra_hi, extra_lo)
        self._swap_out(victim)       # copies pages to host BEFORE freeing
        self.alloc.free(victim.hi_pages, victim.lo_pages)
        victim.hi_pages, victim.lo_pages = [], []
        self.active.remove(victim)
        heapq.heappush(self._free_slots, victim.slot)
        victim.slot = -1
        victim.state = WAITING
        victim.preemptions += 1
        self.num_preemptions += 1
        self._step_preempted.append(victim)
        self.submit(victim)          # re-enters at its original arrival rank
