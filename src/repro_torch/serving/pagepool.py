"""Paged RaZeR-quantized KV pool for continuous batching (PyTorch port of
``repro.serving.pagepool``).

KV storage is carved into fixed-size **pages** of ``page_size`` tokens shared
by all sequences, with a per-sequence page table mapping logical token
positions to physical pages -- the vLLM PagedAttention layout, applied to the
4.5-bit wire format of ``serving.kvcache`` (paper App. C.1).  Quant blocks run
along hd and never span tokens, so a page of whole tokens is an integer
number of quant blocks and ``kv_quantize`` applies per page unchanged:

    k_codes[page, slot, kvh, hd//2]   two FP4 codes per byte
    k_meta [page, slot, kvh, hd//16]  E4M3 scale (7 bits) + SV-sign bit

Physical page 0 is the reserved **null page**: page-table rows of idle decode
slots (and the tails of short sequences) point at it, so the fixed-width
decode step writes their garbage somewhere harmless.

The buffers keep the JAX package's layout: ``caches`` is one dict of
``(count, P, ps, KVH, ...)`` uint8 arrays per layer group (a dense decoder
has one group; an MoE decoder with leading dense layers two), and ``layers``
holds each layer's ``(P, ps, KVH, ...)`` views of them, in layer order,
which the decode step updates in place.  Allocation
(free list, refcounts, page lists) is host-side Python.

``export_pages`` / ``import_pages`` move a sequence's pages between pools as
a ``PageShipment`` of host tensors in the wire format (disaggregated
serving, ``serving.disagg``).  ``install_pool_metrics`` exports occupancy and
allocator traffic into a ``MetricsRegistry``, and ``set_kv_audit`` attaches a
read-only ``obs.KVAuditor`` to ``write_prefill``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import layer_groups

__all__ = ["NULL_PAGE", "PagePoolConfig", "PageShipment", "KVPagePool", "install_pool_metrics"]

NULL_PAGE = 0
_KV_NAMES = ("k_codes", "k_meta", "v_codes", "v_meta")


@dataclasses.dataclass(frozen=True)
class PagePoolConfig:
    """Sizing knobs for the paged KV pool.

    ``num_pages`` counts usable pages EXCLUDING the reserved null page;
    ``max_len`` bounds any single sequence (prompt + generated) and fixes the
    page-table width ``ceil(max_len / page_size)``.
    """

    num_pages: int
    page_size: int = 16
    max_len: int = 256

    def __post_init__(self):
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {self.num_pages}")

    @property
    def pages_per_seq(self) -> int:
        """Page-table width: worst-case pages one sequence can touch."""
        return -(-self.max_len // self.page_size)


@dataclasses.dataclass
class PageShipment:
    """Wire-format KV pages of one sequence on the host, ready to cross a
    process or host boundary (``serving.disagg``).

    ``buffers`` mirrors the pool's per-layer-group ``caches``: one
    ``{"k_codes": (count, n_pages, ps, KVH, hd/2) uint8, "k_meta": ...}``
    dict of CPU tensors per group, in LOGICAL page order (entry ``i`` along
    the page axis holds tokens ``[i * ps, (i + 1) * ps)``).  The payload is
    the App. C.1 wire format, so shipping KV costs 4.5 bits an element
    (``nbytes``) instead of bf16's 16 (``bf16_bytes``).  ``n_tokens`` counts
    the valid leading positions; the tail of the last page is whatever the
    source page held, which the importer's decode overwrites or masks."""

    seq_id: int
    n_tokens: int
    page_size: int
    buffers: List[Dict[str, torch.Tensor]]

    @property
    def n_pages(self) -> int:
        return self.buffers[0]["k_codes"].shape[1]

    @property
    def nbytes(self) -> int:
        """Transfer payload: the wire-format bytes shipped."""
        return sum(t.numel() for g in self.buffers for t in g.values())

    @property
    def bf16_bytes(self) -> int:
        """What the same K and V would cost in bf16 (2 bytes an element)."""
        hd = self.buffers[0]["k_codes"].shape[-1] * 2
        return sum(int(np.prod(g["k_codes"].shape[:-1])) * hd * 2 * 2 for g in self.buffers)


def _check_paged_arch(cfg: ArchConfig) -> None:
    """The pool stores the GQA wire format; archs whose decode state is not a
    per-token GQA cache cannot page it (they keep the static engine path).
    Modality frontends are refused too: ``serve`` has no extras path, so a
    VLM or audio prefill would drop its frontend embeddings."""
    if cfg.mla or cfg.ssm or cfg.block_pattern or cfg.encoder_decoder or cfg.frontend != "none":
        raise ValueError(
            "paged KV serving supports pure GQA-attention stacks (dense or MoE); "
            f"arch {cfg.name!r} has "
            + ", ".join(k for k, v in [("mla", cfg.mla), ("ssm", cfg.ssm), ("block_pattern", bool(cfg.block_pattern)),
                                       ("encoder_decoder", cfg.encoder_decoder),
                                       (f"a {cfg.frontend} frontend", cfg.frontend != "none")] if v)
            + " -- use Engine.generate (static batching) for it")
    if cfg.hd % 16 != 0:
        raise ValueError(f"quantized KV pages need head_dim % 16 == 0, got hd={cfg.hd}")


class KVPagePool:
    """Block-quantized KV page pool + free-list allocator + page tables.

    Device state lives in ``caches`` (and its per-layer views ``layers``),
    written in place by prefill writes, decode steps and COW forks;
    everything else is host bookkeeping."""

    def __init__(self, cfg: ArchConfig, pool_cfg: PagePoolConfig, *, device="cuda"):
        _check_paged_arch(cfg)
        self.cfg = cfg
        self.pool_cfg = pool_cfg
        self.device = resolve_device(device)
        hd, kvh, ps = cfg.hd, cfg.num_kv_heads, pool_cfg.page_size
        p = pool_cfg.num_pages + 1  # + reserved null page 0
        widths = {"k_codes": hd // 2, "k_meta": hd // 16, "v_codes": hd // 2, "v_meta": hd // 16}
        self.caches: List[Dict[str, torch.Tensor]] = [
            {name: torch.zeros((count, p, ps, kvh, widths[name]), dtype=torch.uint8, device=self.device)
             for name in _KV_NAMES} for _, count in layer_groups(cfg)]
        self.layers: List[Dict[str, torch.Tensor]] = [
            {name: buf[i] for name, buf in group.items()}
            for group in self.caches for i in range(group["k_codes"].shape[0])]
        self._free: List[int] = list(range(p - 1, NULL_PAGE, -1))  # pop() -> lowest first
        self._seq_pages: Dict[int, List[int]] = {}
        self._pending_forks: Dict[int, tuple] = {}  # seq -> (dst, src), see flush_forks
        # physical page -> owner count: one per sequence whose page list holds
        # it, plus one per prefix-cache radix node.  A page returns to the
        # free list when its last owner lets go; a shared page (refcount > 1)
        # is never written: prefill and decode write only past the shared
        # prefix, into sequence-private pages
        self._refs: Dict[int, int] = {}
        # listener(event, n_pages), event in {"alloc", "append", "release",
        # "truncate", "cow_fork"}: install_pool_metrics and test probes
        self._listeners: List = []
        # the numerics-audit hook (obs.KVAuditor): a read-only observer of
        # prefill K/V, a no-op when None (the default)
        self._kv_audit = None
        self._group_sizes = [count for _, count in layer_groups(cfg)]

    def set_kv_audit(self, auditor) -> None:
        """Attach a ``KVAuditor`` (or None to detach).  The auditor only
        reads the prefill caches: pool contents and serve outputs are
        bit-identical with or without it."""
        self._kv_audit = auditor

    def add_listener(self, fn) -> None:
        """Subscribe ``fn(event, n_pages)`` to allocator events."""
        self._listeners.append(fn)

    def _notify(self, event: str, n: int) -> None:
        for fn in self._listeners:
            fn(event, n)

    # -- accounting ----------------------------------------------------------
    @property
    def num_free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.pool_cfg.num_pages - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.pool_cfg.page_size)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= len(self._free)

    def bytes_per_page(self) -> int:
        """Wire-format bytes one page holds across all layers (K+V)."""
        hd, kvh, ps = self.cfg.hd, self.cfg.num_kv_heads, self.pool_cfg.page_size
        return self.cfg.num_layers * ps * kvh * 2 * (hd // 2 + hd // 16)

    def total_bytes(self) -> int:
        return self.bytes_per_page() * (self.pool_cfg.num_pages + 1)

    # -- refcounting ---------------------------------------------------------
    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def incref(self, page: int) -> None:
        """Add an owner to a live page (prefix-cache publication)."""
        if page not in self._refs:
            raise ValueError(f"page {page} is not allocated; only live pages can gain owners")
        self._refs[page] += 1

    def decref(self, page: int) -> None:
        """Drop one owner; the last owner's decref frees the page."""
        n = self._refs.get(page, 0)
        if n <= 0:
            raise ValueError(f"page {page} has no owners to release (double free?)")
        if n == 1:
            del self._refs[page]
            self._free.append(page)
        else:
            self._refs[page] = n - 1

    # -- alloc / free --------------------------------------------------------
    def allocate(self, seq_id: int, n_tokens: int, shared: Sequence[int] = (),
                 cow_src: Optional[int] = None) -> List[int]:
        """Reserve pages covering ``n_tokens`` positions for a new sequence.

        ``shared`` are live pages (a cached prefix, in logical order) the
        sequence joins as a co-owner, at no free-page cost.  ``cow_src`` forks
        one more page: a fresh page is popped and the sequence owns the copy.
        The byte copy is deferred to ``flush_forks``, because a same-batch
        donor may not have prefilled the source yet; the source holds an
        extra ref until then.  The remainder comes fresh from the free list."""
        if seq_id in self._seq_pages:
            raise ValueError(
                f"double allocation: sequence {seq_id} already holds pages "
                f"{self._seq_pages[seq_id]}; release() it first (decode growth goes through append())")
        need = self.pages_for(n_tokens)
        if n_tokens > self.pool_cfg.max_len:
            raise ValueError(f"sequence {seq_id} wants {n_tokens} tokens > pool max_len "
                             f"{self.pool_cfg.max_len} (the page-table width is fixed)")
        n_fresh = need - len(shared)
        if n_fresh < 0 or (cow_src is not None and n_fresh < 1):
            raise ValueError(f"sequence {seq_id}: {len(shared)} shared pages"
                             + ("" if cow_src is None else " + a COW fork")
                             + f" exceed the {need} pages {n_tokens} tokens need")
        if n_fresh > len(self._free):
            raise RuntimeError(f"KV pool exhausted: need {n_fresh} fresh pages, {len(self._free)} "
                               f"free (admit fewer sequences or grow num_pages)")
        for pg in shared:
            self.incref(pg)
        pages = list(shared)
        if cow_src is not None:
            dst = self._free.pop()
            self._refs[dst] = 1
            self.incref(cow_src)  # pin the source until the copy happens
            self._pending_forks[seq_id] = (dst, cow_src)
            pages.append(dst)
        while len(pages) < need:
            pg = self._free.pop()
            self._refs[pg] = 1
            pages.append(pg)
        self._seq_pages[seq_id] = pages
        if self._listeners:
            self._notify("alloc", need - len(shared))
        return pages

    def append(self, seq_id: int, new_len: int) -> List[int]:
        """Grow a sequence's page list to cover ``new_len`` tokens; returns
        the newly added physical pages."""
        if seq_id not in self._seq_pages:
            raise ValueError(f"append() for unknown sequence {seq_id}: it holds no pages "
                             f"(allocate() it first, or it was already released)")
        pages = self._seq_pages[seq_id]
        need = self.pages_for(new_len)
        added: List[int] = []
        if need > self.pool_cfg.pages_per_seq:
            raise ValueError(f"sequence {seq_id} grew past pool max_len {self.pool_cfg.max_len}")
        while len(pages) < need:
            if not self._free:
                raise RuntimeError(f"KV pool exhausted appending to sequence {seq_id}; the "
                                   f"scheduler must reserve decode headroom at admission")
            pages.append(self._free.pop())
            self._refs[pages[-1]] = 1
            added.append(pages[-1])
        if added and self._listeners:
            self._notify("append", len(added))
        return added

    def truncate(self, seq_id: int, new_len: int) -> List[int]:
        """Shrink a sequence's page list to cover ``new_len`` tokens, dropping
        its ownership of the tail pages (speculative-decode rollback).  The
        bytes are not erased: positions >= ``new_len`` never attend.  Returns
        the popped pages, newest first."""
        if seq_id not in self._seq_pages:
            raise ValueError(f"truncate() for unknown sequence {seq_id}: it holds no pages "
                             f"(never allocated, or already released)")
        if new_len < 0:
            raise ValueError(f"truncate() to negative length {new_len}")
        pages = self._seq_pages[seq_id]
        keep = self.pages_for(new_len)
        popped: List[int] = []
        while len(pages) > keep:
            pg = pages.pop()
            if self._pending_forks.get(seq_id, (None,))[0] == pg:
                # the deferred COW copy targeted this page: cancel the fork
                # and unpin its source
                self.decref(self._pending_forks.pop(seq_id)[1])
            self.decref(pg)
            popped.append(pg)
        if popped and self._listeners:
            self._notify("truncate", len(popped))
        return popped

    def flush_forks(self, seq_id: int) -> None:
        """Run the sequence's deferred copy-on-write page copy (no-op if none
        is pending), right before its own prefill reads the copy."""
        if seq_id in self._pending_forks:
            dst, src = self._pending_forks.pop(seq_id)
            for group in self.caches:
                for buf in group.values():
                    buf[:, dst] = buf[:, src]
            self.decref(src)
            if self._listeners:
                self._notify("cow_fork", 1)

    def release(self, seq_id: int) -> None:
        """Drop a finished sequence's ownership of its pages.  Private pages
        return to the free list; pages a prefix cache (or another sequence)
        still owns merely lose one owner."""
        if seq_id in self._pending_forks:  # released before it ever prefilled
            self.decref(self._pending_forks.pop(seq_id)[1])
        if seq_id not in self._seq_pages:
            raise ValueError(f"release() for unknown sequence {seq_id}: it holds no pages "
                             f"(never allocated, or already released)")
        free_before = len(self._free)
        for pg in self._seq_pages.pop(seq_id):
            self.decref(pg)
        if self._listeners:
            self._notify("release", len(self._free) - free_before)

    def sequence_pages(self, seq_id: int) -> List[int]:
        return list(self._seq_pages[seq_id])

    # -- page tables ---------------------------------------------------------
    def page_row(self, seq_id: Optional[int]) -> np.ndarray:
        """(pages_per_seq,) int32 row; the unused tail (and a ``None``
        sequence, an idle decode slot) points at the null page."""
        row = np.full((self.pool_cfg.pages_per_seq,), NULL_PAGE, np.int32)
        if seq_id is not None:
            pages = self._seq_pages[seq_id]
            row[: len(pages)] = pages
        return row

    def page_table(self, seq_ids: Sequence[Optional[int]]) -> torch.Tensor:
        """(len(seq_ids), pages_per_seq) int32 table on the pool's device."""
        return torch.from_numpy(np.stack([self.page_row(s) for s in seq_ids])).to(self.device)

    # -- prefill writes ------------------------------------------------------
    def write_prefill(self, seq_id: int, caches: List[Dict[str, torch.Tensor]], length: int,
                      start: int = 0) -> None:
        """Quantize a prefill's K/V and write it into the sequence's pages.

        ``caches`` is the prefill's per-layer list of ``{"k": (1, S, KVH,
        hd), "v": ...}``, S the padded bucket.  Cache index j holds token
        ``start + j`` (a prefix-cached suffix prefill passes ``start`` = the
        cached length, and never touches the shared prefix pages); positions
        ``[start, length)`` go to ``(page_of(start + j), (start + j) %
        page_size)`` and the padded tail to the null page.  All layers
        quantize in one ``kv_quantize`` call per K and V (the quantizer works
        along hd, so this gives the bytes of the JAX package's call per layer
        group) and scatter in one write per array and group."""
        from repro_torch.serving.kvcache import kv_quantize

        ps = self.pool_cfg.page_size
        row = self.page_row(seq_id)
        s = caches[0]["k"].shape[1]
        pos = start + np.arange(s)
        logical = np.minimum(pos // ps, row.shape[0] - 1)
        pids = torch.from_numpy(np.where(pos < length, row[logical], NULL_PAGE).astype(np.int64)).to(self.device)
        sids = torch.from_numpy((pos % ps).astype(np.int64)).to(self.device)
        kc, km = kv_quantize(torch.stack([c["k"][0] for c in caches]))  # (count, S, KVH, .)
        vc, vm = kv_quantize(torch.stack([c["v"][0] for c in caches]))
        first = 0
        for group in self.caches:
            count = group["k_codes"].shape[0]
            for name, val in (("k_codes", kc), ("k_meta", km), ("v_codes", vc), ("v_meta", vm)):
                group[name][:, pids, sids] = val[first:first + count]
            first += count
        if self._kv_audit is not None:
            self._kv_audit.observe_prefill(seq_id, caches, length, start, ps, group_sizes=self._group_sizes)

    # -- wire-format page transfer (serving.disagg) --------------------------
    def export_pages(self, seq_id: Optional[int] = None, *, page_ids: Optional[Sequence[int]] = None,
                     n_tokens: Optional[int] = None) -> PageShipment:
        """Gather a sequence's pages (or an explicit logical-order
        ``page_ids`` list) to the host as a ``PageShipment``.

        The sequence's pending copy-on-write fork is flushed first, so the
        shipment carries its own last-page bytes, not its donor's.  The
        pages are gathered on the device and then copied to the host, the
        boundary the shipment models.  ``n_tokens`` bounds the export to
        the pages covering that many leading tokens (default: every page
        the sequence holds)."""
        if (seq_id is None) == (page_ids is None):
            raise ValueError("export_pages: pass exactly one of seq_id / page_ids")
        if seq_id is not None:
            self.flush_forks(seq_id)
            pages = self._seq_pages.get(seq_id)
            if pages is None:
                raise ValueError(f"export_pages() for unknown sequence {seq_id}: it holds no pages "
                                 f"(never allocated, or already released)")
            if n_tokens is None:
                n_tokens = len(pages) * self.pool_cfg.page_size
            pages = pages[: self.pages_for(n_tokens)]
        else:
            pages = list(page_ids)
            if n_tokens is None:
                n_tokens = len(pages) * self.pool_cfg.page_size
            if self.pages_for(n_tokens) != len(pages):
                raise ValueError(f"export_pages: {len(pages)} pages cannot cover n_tokens={n_tokens} (need "
                                 f"{self.pages_for(n_tokens)} at page_size {self.pool_cfg.page_size})")
        ids = torch.as_tensor(pages, dtype=torch.long, device=self.device)
        buffers = [{name: buf[:, ids].cpu() for name, buf in group.items()} for group in self.caches]
        return PageShipment(seq_id=seq_id if seq_id is not None else -1, n_tokens=int(n_tokens),
                            page_size=self.pool_cfg.page_size, buffers=buffers)

    def import_pages(self, shipment: PageShipment, *, seq_id: Optional[int] = None,
                     reserve_tokens: Optional[int] = None) -> List[int]:
        """Allocate fresh pages for the sequence in THIS pool and write the
        shipped wire bytes into the leading ones.

        ``reserve_tokens`` (default ``shipment.n_tokens``) sizes the
        allocation: a decode replica reserves ``len(prompt) +
        max_new_tokens`` up front, as single-engine admission does.  Returns
        the sequence's page list in logical order; the shipment's page ``i``
        now lives in physical page ``pages[i]``."""
        sid = shipment.seq_id if seq_id is None else seq_id
        n_tok = shipment.n_tokens if reserve_tokens is None else reserve_tokens
        if shipment.page_size != self.pool_cfg.page_size:
            raise ValueError(f"shipment page_size {shipment.page_size} != pool page_size "
                             f"{self.pool_cfg.page_size}; replicas must agree on the page layout")
        if len(shipment.buffers) != len(self.caches) or any(
                s[k].shape[0] != c[k].shape[0] or s[k].shape[2:] != c[k].shape[2:]
                for s, c in zip(shipment.buffers, self.caches) for k in c):
            raise ValueError("shipment layer-group/head layout does not match this pool (different arch?)")
        if n_tok < shipment.n_tokens:
            raise ValueError(f"reserve_tokens={n_tok} < shipment.n_tokens={shipment.n_tokens}: the "
                             f"reservation must cover every shipped page")
        pages = self.allocate(sid, n_tok)
        dst = torch.as_tensor(pages[: shipment.n_pages], dtype=torch.long, device=self.device)
        for group, host in zip(self.caches, shipment.buffers):
            for name, buf in group.items():
                buf[:, dst] = host[name].to(self.device)
        return pages

    # -- debug / tests -------------------------------------------------------
    def gather_sequence(self, seq_id: int, length: int, group: int = 0):
        """Dequantized (count, length, KVH, hd) K and V of one sequence's
        first ``length`` positions in layer group ``group``: a test path;
        decode never materializes this."""
        from repro_torch.serving.kvcache import kv_dequantize

        ps = self.pool_cfg.page_size
        pos = np.arange(length)
        pids = torch.as_tensor(self.page_row(seq_id)[pos // ps], dtype=torch.long, device=self.device)
        sids = torch.as_tensor(pos % ps, dtype=torch.long, device=self.device)
        c = self.caches[group]
        k = kv_dequantize(c["k_codes"][:, pids, sids], c["k_meta"][:, pids, sids], self.cfg.hd)
        v = kv_dequantize(c["v_codes"][:, pids, sids], c["v_meta"][:, pids, sids], self.cfg.hd)
        return k, v


def install_pool_metrics(registry, pool: KVPagePool, *, stage: str = "engine", replica: str = "0") -> None:
    """Export a pool's occupancy and allocator traffic into ``registry``.

    Occupancy is function-backed gauges (``pool_pages{state=...}``,
    ``pool_refcount_total``): the registry reads the pool at collection
    time and the allocator never touches a metric.  Allocator traffic
    (``pool_page_events_total{event=...}``) rides the listener hook.
    ``stage`` / ``replica`` tell disaggregated fleet members sharing one
    registry apart; the single engine uses the defaults."""
    pages = registry.gauge("pool_pages", "KV pool pages by state", labels=("stage", "replica", "state"))
    pages.set_function(lambda: pool.num_free_pages, stage=stage, replica=replica, state="free")
    pages.set_function(lambda: pool.pages_in_use, stage=stage, replica=replica, state="live")
    pages.set_function(lambda: 1, stage=stage, replica=replica, state="null")  # the reserved null page
    refs = registry.gauge("pool_refcount_total", "Sum of page owner counts (> live pages means prefix sharing)",
                          labels=("stage", "replica"))
    refs.set_function(lambda: sum(pool._refs.values()), stage=stage, replica=replica)
    events = registry.counter("pool_page_events_total", "Allocator events by type (pages moved per event)",
                              labels=("stage", "replica", "event"))
    pool.add_listener(lambda event, n: events.inc(n, stage=stage, replica=replica, event=event))
