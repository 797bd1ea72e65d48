"""Continuous-batching scheduler (PyTorch port of ``repro.serving.scheduler``,
pure Python and unchanged): request admission, prefill/decode interleaving
under a token budget, decode-slot assignment, completion and eviction over
the paged KV pool.

The scheduler is pure host-side control flow -- it never touches tensors.
Each engine iteration asks it two questions:

  1. ``admit(now)``        -- which WAITING requests start prefilling this
                              step (arrival order, gated by a free decode
                              slot, pool pages for the worst case
                              ``len(prompt) + max_new_tokens``, and the
                              per-step prefill token budget);
  2. ``decode_batch()``    -- the fixed-width slot arrays (token, cur_len,
                              seq ids) for one dynamic-batch decode step.

and reports back with ``start`` (prefill done, first token sampled) and
``post_decode`` (one token per active slot), after which the scheduler
retires finished requests and frees their slot + pages.

Request lifecycle::

    WAITING --admit/prefill--> RUNNING --eos | max_new | len cap--> FINISHED

Admission reserves pages for the whole worst-case sequence up front, so a
running request can never deadlock on pool growth mid-decode (no preemption
needed); ``KVPagePool.append`` exists for schedulers that want optimistic
allocation + eviction instead.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence

from .pagepool import KVPagePool

WAITING = "waiting"
RUNNING = "running"
FINISHED = "finished"


@dataclasses.dataclass
class Request:
    """One serving request plus its measured lifecycle stats."""

    rid: int
    prompt: List[int]
    max_new_tokens: int
    arrival: float = 0.0
    eos_id: int = -1  # -1: never stop early

    # filled in by the scheduler / engine
    state: str = WAITING
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    prefill_start: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # prefix-cache outcome: leading prompt tokens whose KV came from shared /
    # copied pool pages instead of being recomputed (0 = cache off or miss)
    cached_tokens: int = 0
    # same-batch dedup: rid of an identical-prompt request admitted earlier in
    # the SAME admit() batch whose pages (and greedy first token) this request
    # joins outright -- the engine skips its prefill entirely
    dedup_of: Optional[int] = None

    @property
    def cur_len(self) -> int:
        """Valid KV positions: prompt + generated tokens already written.
        The newest sampled token is fed (and written) by the NEXT decode
        step, so it does not count yet."""
        return len(self.prompt) + max(len(self.out_tokens) - 1, 0)

    @property
    def done(self) -> bool:
        return len(self.out_tokens) >= self.max_new_tokens or (
            bool(self.out_tokens) and self.out_tokens[-1] == self.eos_id
        )


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Continuous-batching knobs.

    ``max_slots`` is the decode batch width the step function is compiled
    for; ``prefill_token_budget`` caps prompt tokens admitted per iteration
    so a burst of long prompts cannot starve running decodes (the
    prefill/decode interleave ratio knob).

    ``speculate_k`` > 0 (speculative decoding, serving/speculative.py) widens
    the worst-case reservation to ``len(prompt) + max_new_tokens + k``: a
    verify step writes up to k speculative positions past the committed
    length before rollback, so those pages must exist even at the length cap.
    Rolled-back tail pages return to the free list (``KVPagePool.truncate``)
    but stay RESERVED for their sequence -- admission subtracts that headroom
    (see ``_available_pages``) so re-appending them can never fail."""

    max_slots: int = 8
    prefill_token_budget: int = 512
    speculate_k: int = 0


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, pool: KVPagePool, cache=None,
                 tracer=None):
        """``cache`` is an optional ``serving.prefixcache.PrefixCache`` over
        the same pool: admission then charges only the uncached suffix against
        the prefill token budget, shared pages reserve no free pages, and pool
        pressure triggers LRU eviction of unreferenced cached pages.

        ``tracer`` is an optional ``obs.Tracer``: admission and retirement
        emit instant events on it, timestamped with the ``now`` the engine
        already threads through every scheduler call (so a fake-clock serve
        traces deterministically).  Default is the no-op recorder."""
        from repro_torch.obs import NULL_TRACER

        self.cfg = cfg
        self.pool = pool
        self.cache = cache
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.waiting: List[Request] = []  # kept sorted by arrival (FIFO on ties)
        self.running: Dict[int, Request] = {}  # slot -> request
        self.finished: List[Request] = []
        self._free_slots: List[int] = list(range(cfg.max_slots - 1, -1, -1))
        # rid -> worst-case page reservation made at admission.  With
        # speculate_k > 0 a rollback (pool.truncate) can return reserved tail
        # pages to the free list mid-decode; they remain spoken for, so
        # admission must not hand them to a new request (_available_pages)
        self._need_pages: Dict[int, int] = {}

    def _available_pages(self) -> int:
        """Free pages admission may actually claim: the pool's free count
        minus speculative-rollback headroom (pages reserved for admitted
        sequences that truncate() returned to the free list -- their next
        draft/verify burst re-appends them, and that append must never fail)."""
        headroom = 0
        for rid, need in self._need_pages.items():
            headroom += max(need - len(self.pool.sequence_pages(rid)), 0)
        return self.pool.num_free_pages - headroom

    # -- submission ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        need = len(req.prompt) + req.max_new_tokens + self.cfg.speculate_k
        if req.state != WAITING or req.out_tokens or req.slot is not None:
            raise ValueError(
                f"request {req.rid} carries stale serving state "
                f"(state={req.state!r}, {len(req.out_tokens)} generated tokens); "
                f"submit a fresh Request per serve call"
            )
        if any(req.rid == r.rid for r in (*self.waiting, *self.running.values(),
                                          *self.finished)):
            raise ValueError(
                f"duplicate request id {req.rid}: rids key page-pool ownership "
                f"and must be unique within one serve run"
            )
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.rid}: empty prompt (need >= 1 token)")
        if need > self.pool.pool_cfg.max_len:
            spec = (f" + speculate_k ({self.cfg.speculate_k})"
                    if self.cfg.speculate_k else "")
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + max_new_tokens "
                f"({req.max_new_tokens}){spec} = {need} exceeds the pool max_len "
                f"{self.pool.pool_cfg.max_len}; raise PagePoolConfig.max_len or "
                f"shorten the request"
            )
        if self.pool.pages_for(need) > self.pool.pool_cfg.num_pages:
            raise ValueError(
                f"request {req.rid} needs {self.pool.pages_for(need)} pages but the "
                f"pool has only {self.pool.pool_cfg.num_pages}; grow "
                f"PagePoolConfig.num_pages"
            )
        # admission order is arrival order (stable on ties), regardless of
        # submission order -- the serve loop relies on waiting[0] being the
        # next request to become admissible
        bisect.insort(self.waiting, req, key=lambda r: r.arrival)

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def next_arrival(self) -> Optional[float]:
        """Earliest arrival among still-waiting requests (None if none)."""
        return self.waiting[0].arrival if self.waiting else None

    # -- admission (prefill phase) -------------------------------------------
    def _reserve(self, req: Request, match) -> bool:
        """Try to free enough pool pages for ``req`` given a prefix-cache
        ``match`` (or None): shared pages reserve nothing; the COW fork and
        every page past the cached prefix come from the free list, evicting
        LRU unreferenced cached pages under pressure (matched pages pinned)."""
        shared = list(match.pages) if match is not None else []
        need = self.pool.pages_for(
            len(req.prompt) + req.max_new_tokens + self.cfg.speculate_k)
        fresh = need - len(shared)
        short = fresh - self._available_pages()
        if short > 0 and self.cache is not None:
            protect = shared + ([match.cow_page] if match and match.cow_page is not None
                                else [])
            self.cache.evict(short, protect=protect)
        return fresh <= self._available_pages()

    def admit(self, now: float) -> List[Request]:
        """Admit WAITING requests in arrival order (FIFO on ties) that (a)
        have arrived, (b) get a free
        decode slot, (c) fit in the pool at worst case, (d) fit this step's
        prefill token budget.  Head-of-line blocking is intentional: skipping
        a too-big head request would starve it forever.

        With a prefix cache attached, the head request's prompt is first
        matched against the radix tree: only the uncached suffix counts
        against the prefill token budget, shared pages reserve no free pages,
        and a page shortfall evicts LRU unreferenced cached pages before
        giving up.  If the pool cannot host the request WITH its match (the
        matched pages themselves are pinned against eviction), admission
        retries matchless rather than stalling on a full-but-idle pool.

        Identical prompts within one admit() batch DEDUP (cache on or off):
        the second copy joins the first's pages through the shared-allocation
        path (full pages shared outright, the partial last page forked
        copy-on-write for its own decode writes), charges nothing against the
        prefill token budget, and is marked ``dedup_of`` so the engine skips
        its prefill and copies the donor's greedy first token -- identical
        prompts sample identical first tokens, so outputs are unchanged."""
        admitted: List[Request] = []
        batch_prompts: Dict[tuple, Request] = {}
        budget = self.cfg.prefill_token_budget
        while self.waiting and self._free_slots:
            req = self.waiting[0]
            if req.arrival > now:
                break
            donor = batch_prompts.get(tuple(req.prompt))
            if donor is not None:
                if not self._admit_dedup(req, donor, now):
                    break  # maximal sharing still does not fit: wait for pages
                admitted.append(req)
                continue
            match = self.cache.match(req.prompt) if self.cache is not None else None
            cached = match.cached_len if match is not None else 0
            if len(req.prompt) - cached > budget and admitted:
                break  # budget spent this step; prefill next iteration
            if not self._reserve(req, match):
                if match is None or not cached:
                    break  # wait for a running request to finish and free pages
                match, cached = None, 0  # pinning the match starved the pool
                if len(req.prompt) > budget and admitted:
                    break
                if not self._reserve(req, None):
                    break
            self.waiting.pop(0)
            need = len(req.prompt) + req.max_new_tokens + self.cfg.speculate_k
            self.pool.allocate(
                req.rid, need,
                shared=match.pages if match is not None else (),
                cow_src=match.cow_page if match is not None else None)
            self._need_pages[req.rid] = self.pool.pages_for(need)
            if self.cache is not None:
                self.cache.record(match)  # one lookup/hit per admitted request
                # publish the request's full prompt chunks NOW, pointing at its
                # just-allocated pages: the engine prefills admitted requests
                # in order, so a same-batch sharer's suffix prefill always
                # reads pages this request's prefill has already written
                self.cache.insert(req.prompt, self.pool.sequence_pages(req.rid))
            req.cached_tokens = cached
            req.slot = self._free_slots.pop()
            req.prefill_start = now
            budget -= len(req.prompt) - cached
            self.tracer.instant("admit", ts=now, rid=req.rid,
                                prompt=len(req.prompt), cached=cached)
            admitted.append(req)
            batch_prompts[tuple(req.prompt)] = req
            if budget <= 0:
                break
        return admitted

    def _admit_dedup(self, req: Request, donor: Request, now: float) -> bool:
        """Admit ``req`` as a same-batch duplicate of ``donor``: share every
        fully-covered prompt page, fork the partial last page copy-on-write
        (its tail receives this request's own decode writes; the copy is
        flushed after the donor's prefill lands), reserve only the remaining
        worst-case decode pages.  No prefill-budget charge -- nothing is
        recomputed."""
        from .prefixcache import PrefixMatch

        ps = self.pool.pool_cfg.page_size
        full, partial = len(req.prompt) // ps, len(req.prompt) % ps
        donor_pages = self.pool.sequence_pages(donor.rid)
        match = PrefixMatch(
            pages=tuple(donor_pages[:full]),
            cow_page=donor_pages[full] if partial else None,
            partial=partial, _full_tokens=full * ps)
        if not self._reserve(req, match):
            return False
        self.waiting.pop(0)
        need = len(req.prompt) + req.max_new_tokens + self.cfg.speculate_k
        self.pool.allocate(req.rid, need,
                           shared=match.pages, cow_src=match.cow_page)
        self._need_pages[req.rid] = self.pool.pages_for(need)
        if self.cache is not None:
            self.cache.record(match)  # a dedup is the strongest possible hit
        req.cached_tokens = len(req.prompt)
        req.dedup_of = donor.rid
        req.slot = self._free_slots.pop()
        req.prefill_start = now
        self.tracer.instant("admit", ts=now, rid=req.rid,
                            prompt=len(req.prompt), cached=len(req.prompt),
                            dedup_of=donor.rid)
        return True

    def start(self, req: Request, first_token: int, now: float) -> None:
        """Prefill finished: record the first sampled token and either retire
        the request (eos / max_new == 1) or move it into the decode pool."""
        req.out_tokens.append(first_token)
        req.first_token_time = now
        if req.done:
            self._retire(req, now)
        else:
            req.state = RUNNING
            self.running[req.slot] = req

    # -- decode phase ---------------------------------------------------------
    def decode_batch(self):
        """(seq_ids, tokens, cur_lens) padded to ``max_slots``.

        ``seq_ids[i]`` is None for idle slots; their token is 0 and cur_len 0
        (the page table maps them to the null page, so their garbage write and
        logits are inert).  Returns None when nothing is running."""
        if not self.running:
            return None
        seq_ids: List[Optional[int]] = [None] * self.cfg.max_slots
        tokens = [0] * self.cfg.max_slots
        cur_lens = [0] * self.cfg.max_slots
        for slot, req in self.running.items():
            seq_ids[slot] = req.rid
            tokens[slot] = req.out_tokens[-1]
            cur_lens[slot] = req.cur_len
        return seq_ids, tokens, cur_lens

    def post_decode(self, slot_tokens: Sequence[int], now: float) -> List[Request]:
        """Record one sampled token per RUNNING slot; retire finished
        requests (slot + pages freed).  Returns the newly finished."""
        return self.post_verify([[t] for t in slot_tokens], now)

    def post_verify(self, slot_commits: Sequence[Sequence[int]], now: float
                    ) -> List[Request]:
        """Record a BURST of verified tokens per RUNNING slot (speculative
        decode commit: the accepted drafts plus the target model's own token).
        Tokens append one at a time with the vanilla done-check between them,
        so eos / max_new truncation lands exactly where step-by-step decode
        would and surplus verified tokens are dropped.  Returns the newly
        finished requests."""
        done: List[Request] = []
        for slot, req in list(self.running.items()):
            for tok in slot_commits[slot]:
                req.out_tokens.append(int(tok))
                if req.done:
                    break
            if req.done:
                del self.running[slot]
                self._retire(req, now)
                done.append(req)
        return done

    def _retire(self, req: Request, now: float) -> None:
        req.state = FINISHED
        req.finish_time = now
        self.tracer.instant("retire", ts=now, rid=req.rid,
                            new_tokens=len(req.out_tokens))
        self.pool.release(req.rid)
        self._need_pages.pop(req.rid, None)
        self._free_slots.append(req.slot)
        req.slot = None
        self.finished.append(req)
