"""Prefill and decode workers for disaggregated serving (PyTorch port of
``repro.serving.disagg.workers``).

Each worker owns its OWN ``KVPagePool`` (its replica's KV memory) and shares
the parent engine's params and forwards: replicas of one model differ only
in cache state.  The split follows the JetStream prefill / insert / generate
staging:

* ``PrefillWorker``: a FIFO of prefill jobs.  One ``step()`` runs ONE chunk
  of at most ``chunk_tokens`` tokens of the head job through the engine's
  bucketed or suffix prefill (``Engine._prefill_range``), so a long prompt
  never holds the replica's queue for more than a chunk.  Admission matches
  the replica's prefix cache (suffix-only compute on a hit) as the
  single-engine scheduler does.  When the last chunk lands the worker
  samples the first token, exports the sequence's pages as a wire-format
  ``PageShipment`` and releases the sequence: a prefill pool holds only
  prompts in flight plus the prefix cache.
* ``DecodeWorker``: pending shipments + decode slots over its own pool.  The
  **insert** stage imports arrived shipments (worst-case ``len(prompt) +
  max_new_tokens`` reservation, so decode never runs out of pages) and
  seats them in slots; ``step()`` runs one dynamic-batch paged decode step
  over every running slot.

Workers are clock-agnostic: the orchestrator measures each ``step()`` and
advances per-worker virtual clocks.  On the card every step ends with its
device work done (see ``_sync``), so a measured duration covers the kernels
and not only their launch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..pagepool import KVPagePool, PagePoolConfig, PageShipment
from ..prefixcache import PrefixCache
from ..scheduler import FINISHED, RUNNING, Request

__all__ = ["PrefillJob", "PrefillWorker", "DecodeWorker"]


def _sync(device: torch.device) -> None:
    """Wait for the device's queued work.  The orchestrator reads its clock
    right after a step: a step that hands nothing back to the host would
    otherwise be timed at its launch cost, and the virtual timeline would
    measure the host, not the card."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class PrefillJob:
    """One queued prompt: ``done`` counts its prefilled tokens across chunks."""

    req: Request
    ready_at: float = 0.0  # routed-at time: the job cannot start earlier
    done: int = 0
    started: bool = False


class PrefillWorker:
    """One prefill replica: pool + prefix cache + a chunked FIFO queue."""

    def __init__(self, wid: int, engine, pool_cfg: PagePoolConfig, *, chunk_tokens: int = 64,
                 prefix_cache: bool = True, listener=None):
        if chunk_tokens < 1:
            raise ValueError("chunk_tokens must be >= 1")
        self.wid = wid
        self.engine = engine
        self.chunk_tokens = int(chunk_tokens)
        self.pool = KVPagePool(engine.cfg, pool_cfg, device=engine.device)
        self.cache = PrefixCache(self.pool, listener=listener) if prefix_cache else None
        self.queue: List[PrefillJob] = []
        # orchestrator-owned virtual clock and busy time (seconds)
        self.t = 0.0
        self.busy = 0.0
        self.prefill_tokens = 0
        self.cached_tokens = 0
        self.jobs_done = 0
        self.peak_pages = 0

    def submit(self, req: Request, ready_at: float = 0.0) -> None:
        if self.pool.pages_for(len(req.prompt)) > self.pool.pool_cfg.num_pages:
            raise ValueError(f"request {req.rid}: prompt needs {self.pool.pages_for(len(req.prompt))} pages but "
                             f"prefill replica {self.wid} has only {self.pool.pool_cfg.num_pages}")
        if len(req.prompt) + req.max_new_tokens > self.pool.pool_cfg.max_len:
            raise ValueError(f"request {req.rid}: prompt + max_new_tokens exceeds pool max_len "
                             f"{self.pool.pool_cfg.max_len}")
        self.queue.append(PrefillJob(req=req, ready_at=ready_at))

    @property
    def has_work(self) -> bool:
        return bool(self.queue)

    def next_ready(self) -> float:
        return self.queue[0].ready_at

    def _reserve(self, match) -> bool:
        """Evict LRU cache pages until the head job's prompt fits (shared
        pages reserve nothing; matched pages are pinned)."""
        job = self.queue[0]
        shared = list(match.pages) if match is not None else []
        fresh = self.pool.pages_for(len(job.req.prompt)) - len(shared)
        short = fresh - self.pool.num_free_pages
        if short > 0 and self.cache is not None:
            protect = shared + ([match.cow_page] if match and match.cow_page is not None else [])
            self.cache.evict(short, protect=protect)
        return fresh <= self.pool.num_free_pages

    def _admit(self, job: PrefillJob) -> None:
        """Allocate the head job's PROMPT pages (a prefill replica never holds
        decode growth), reusing the replica's cached prefix when it fits.
        Jobs run one at a time, so beyond the prefix cache the pool is empty
        and -- ``submit`` having checked that the prompt fits the pool --
        the matchless fallback cannot fail."""
        req = job.req
        match = self.cache.match(req.prompt) if self.cache is not None else None
        cached = match.cached_len if match is not None else 0
        if not self._reserve(match):
            match, cached = None, 0  # the pinned match starved the pool: go matchless
            if not self._reserve(None):
                raise RuntimeError(f"prefill replica {self.wid}: pool exhausted with an idle queue head -- "
                                   f"page refcount invariant broken")
        self.pool.allocate(req.rid, len(req.prompt), shared=match.pages if match is not None else (),
                           cow_src=match.cow_page if match is not None else None)
        if self.cache is not None:
            self.cache.record(match)
            self.cache.insert(req.prompt, self.pool.sequence_pages(req.rid))
        self.pool.flush_forks(req.rid)  # jobs run one at a time: the COW source is fully written
        req.cached_tokens = cached
        job.done = cached
        job.started = True
        self.cached_tokens += cached

    @torch.no_grad()
    def step(self, now: float = 0.0) -> Optional[Tuple[Request, PageShipment, int]]:
        """Run ONE prefill chunk (at most ``chunk_tokens`` tokens) of the
        head job.  Returns ``(request, shipment, first_token)`` when the
        job's last chunk lands, else None (more chunks pending)."""
        if not self.queue:
            return None
        job = self.queue[0]
        req = job.req
        if not job.started:
            self._admit(job)
            req.prefill_start = now
        end = min(len(req.prompt), job.done + self.chunk_tokens)
        last, caches = self.engine._prefill_range(req.prompt, job.done, end, self.pool, req.rid)
        self.pool.write_prefill(req.rid, caches, end, start=job.done)
        self.prefill_tokens += end - job.done
        job.done = end
        self.peak_pages = max(self.peak_pages, self.pool.pages_in_use)
        if job.done < len(req.prompt):
            _sync(self.pool.device)  # nothing of this chunk comes back to the host: wait for its kernels
            return None
        first = int(torch.argmax(last[0]))
        shipment = self.pool.export_pages(req.rid, n_tokens=len(req.prompt))
        self.pool.release(req.rid)  # cache references keep shared pages alive
        self.queue.pop(0)
        self.jobs_done += 1
        return req, shipment, first


class DecodeWorker:
    """One decode replica: pending shipments -> insert stage -> decode slots."""

    def __init__(self, wid: int, engine, pool_cfg: PagePoolConfig, *, max_slots: int = 8):
        self.wid = wid
        self.engine = engine
        self.pool = KVPagePool(engine.cfg, pool_cfg, device=engine.device)
        self.max_slots = int(max_slots)
        self._free_slots: List[int] = list(range(self.max_slots - 1, -1, -1))
        # (request, shipment, first_token, ready_at), arrival order
        self.pending: List[Tuple[Request, PageShipment, int, float]] = []
        self.running: Dict[int, Request] = {}
        self._page_table = None  # the device table, kept until a slot changes
        # orchestrator-owned virtual clock and busy time (seconds)
        self.t = 0.0
        self.busy = 0.0
        self.decode_steps = 0
        self.imported_bytes = 0
        self.imported_bf16_bytes = 0
        self.shipments = 0
        self.peak_pages = 0
        self.peak_slots = 0

    def enqueue(self, req: Request, shipment: PageShipment, first_token: int, ready_at: float) -> None:
        need = len(req.prompt) + req.max_new_tokens
        if self.pool.pages_for(need) > self.pool.pool_cfg.num_pages:
            raise ValueError(f"request {req.rid} needs {self.pool.pages_for(need)} pages but decode replica "
                             f"{self.wid} has only {self.pool.pool_cfg.num_pages}")
        self.pending.append((req, shipment, first_token, ready_at))

    @property
    def has_work(self) -> bool:
        return bool(self.pending or self.running)

    def next_ready(self) -> float:
        return self.pending[0][3]

    def insert(self, now: float) -> List[Request]:
        """The insert stage: move arrived shipments into decode slots, in
        order (a shipment inserts only after every earlier one on this
        replica), with a worst-case page reservation, through
        ``import_pages``.  Returns the requests retired AT insert (eos or
        ``max_new_tokens == 1`` on the prefill-sampled first token)."""
        retired: List[Request] = []
        while self.pending and self._free_slots:
            req, shipment, first, ready_at = self.pending[0]
            if ready_at > now:
                break
            need = len(req.prompt) + req.max_new_tokens
            if not self.pool.can_allocate(need):
                break  # a running request must retire first
            self.pending.pop(0)
            self.pool.import_pages(shipment, seq_id=req.rid, reserve_tokens=need)
            self.imported_bytes += shipment.nbytes
            self.imported_bf16_bytes += shipment.bf16_bytes
            self.shipments += 1
            req.slot = self._free_slots.pop()
            req.out_tokens.append(first)
            req.first_token_time = ready_at if req.first_token_time is None else req.first_token_time
            if req.done:
                self._retire(req, now)
                retired.append(req)
            else:
                req.state = RUNNING
                self.running[req.slot] = req
            self._page_table = None
        _sync(self.pool.device)  # the imported pages are on the card before the insert is timed
        self.peak_pages = max(self.peak_pages, self.pool.pages_in_use)
        self.peak_slots = max(self.peak_slots, len(self.running))
        return retired

    def step(self, now: float) -> List[Request]:
        """One dynamic-batch decode step over the running slots.  Returns
        the newly finished requests."""
        if not self.running:
            return []
        seq_ids: List[Optional[int]] = [None] * self.max_slots
        tokens = [0] * self.max_slots
        cur_lens = [0] * self.max_slots
        for slot, req in self.running.items():
            seq_ids[slot] = req.rid
            tokens[slot] = req.out_tokens[-1]
            cur_lens[slot] = req.cur_len
        if self._page_table is None:
            self._page_table = self.pool.page_table(seq_ids)
        toks = self.engine._paged_decode_step(tokens, self.pool, self._page_table, cur_lens)
        self.decode_steps += 1
        finished: List[Request] = []
        for slot, req in list(self.running.items()):
            req.out_tokens.append(int(toks[slot]))
            if req.done:
                del self.running[slot]
                self._retire(req, now)
                finished.append(req)
        return finished

    def _retire(self, req: Request, now: float) -> None:
        req.state = FINISHED
        req.finish_time = now
        self.pool.release(req.rid)
        self._free_slots.append(req.slot)
        req.slot = None
        self._page_table = None
