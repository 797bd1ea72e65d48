"""Prefix cache: a radix tree of page-aligned token chunks over the paged
RaZeR-quantized KV pool (PyTorch port of ``repro.serving.prefixcache``, pure
Python and unchanged but for the metrics installer, which comes with the
observability slice).

Production traffic re-prefills the same prompt prefix constantly -- chat
system prompts, few-shot templates, agentic loops.  Because the page layout
IS the 4.5-bit KV wire format (quant blocks never span tokens) and the serve
path's prefill attends quantize-dequantized K/V (``tf.prefill(qdq_kv=True)``),
a cached page is byte-identical to a freshly quantized one, so a request that
shares a prompt prefix with an earlier request can simply point its page
table at the earlier request's pages and prefill only the suffix -- with
bit-identical greedy decode to the uncached run.

Structure
---------
The tree's edges are **whole page chunks**: a node maps a tuple of
``page_size`` token ids to the physical page holding those tokens' quantized
K/V, and a root-to-node path spells out a cached prefix page by page.  Nodes
hold one pool reference on their page (``KVPagePool._refs``), so a cached
page survives its donor sequence finishing; a sequence admitted onto a cached
prefix co-owns the shared pages (refcount += 1), which makes them immutable
for as long as anyone reads them.

``match`` walks the tree chunk-by-chunk and is clamped to ``len(prompt) - 1``
tokens: at least one suffix token is always recomputed, because sampling the
first output token needs that position's logits.  A hit may end INSIDE a
cached page (the tree holds a longer prefix than the prompt, or the clamp
cut a full-page match short); that page cannot be shared outright -- the new
sequence must write its own tokens into the page's tail slots -- so the
match reports it as a **copy-on-write** source: admission forks the page
(device-side byte copy) and the sequence owns the copy.

Eviction is LRU over refcount-1 leaves: a node owned only by the cache whose
page no live sequence reads, with no children.  Evicting a leaf may expose
its parent as the next candidate (cascade).  Interior nodes are never removed
ahead of their children -- a child is only reachable (and only correct to
match) through its full prefix path.  Pinned nodes are prefix-closed: a
sequence that shares a chunk shares every chunk before it, so a refcount-1
subtree is always fully reclaimable and ``evictable_pages`` can count nodes
without walking structure.

Eviction candidates come off a **lazy-deletion min-heap** keyed on
``last_used``: every LRU bump pushes a fresh ``(last_used, tiebreak, node)``
entry and stale entries (an older timestamp, or an already-evicted node) are
discarded as they surface, so ``evict`` pops candidates in LRU order in
O(log n) per pop instead of the old O(nodes) scan per victim.  Entries that
surface pinned (live readers, protected, or still-interior) are stashed and
re-pushed after the pass; the heap is compacted when stale entries outnumber
live nodes 4:1.

Optional listeners receive ``("insert", path)`` / ``("evict", path)``
events (``path`` = the node's root-to-node tuple of token chunks).  The
disagg router (serving/disagg/router.py) subscribes per-replica views to
these events so request placement can rank replicas by radix hit length
without peeking at -- or LRU-perturbing -- replica-local trees; metrics
subscribe a second listener on the same hook, which is why listeners are a
fan-out list rather than one slot.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .pagepool import KVPagePool


@dataclasses.dataclass
class RadixNode:
    """One cached page: ``chunk`` (page_size token ids) -> physical ``page``."""

    chunk: Tuple[int, ...]
    page: int
    parent: Optional["RadixNode"]
    children: Dict[Tuple[int, ...], "RadixNode"] = dataclasses.field(default_factory=dict)
    last_used: int = 0


@dataclasses.dataclass(frozen=True)
class PrefixMatch:
    """Result of one lookup: what the prompt can reuse.

    ``pages`` are fully shared pages (in logical order, covering tokens
    ``[0, len(pages) * page_size)``); ``cow_page`` is the physical page to
    fork when the match extends ``partial`` tokens into one more cached page;
    ``cached_len`` counts every reused token (``<= len(prompt) - 1``)."""

    pages: Tuple[int, ...] = ()
    cow_page: Optional[int] = None
    partial: int = 0

    @property
    def cached_len(self) -> int:
        return self._full_tokens + self.partial

    # set by PrefixCache.match (page_size is a pool property, not a match one)
    _full_tokens: int = 0


class PrefixCache:
    """Radix-indexed, refcounted, LRU-evicted prefix cache over a page pool."""

    def __init__(self, pool: KVPagePool,
                 listener: Optional[Callable[[str, Tuple[Tuple[int, ...], ...]], None]] = None):
        self.pool = pool
        self.page_size = pool.pool_cfg.page_size
        self.root = RadixNode(chunk=(), page=-1, parent=None)
        self._clock = itertools.count(1)
        # fan-out list: the disagg router's view feed and the metrics wiring
        # can both subscribe (see add_listener); the ctor arg keeps the
        # original single-listener call sites working unchanged
        self._listeners: List[Callable[[str, Tuple[Tuple[int, ...], ...]], None]] = []
        if listener is not None:
            self._listeners.append(listener)
        # lazy-deletion LRU heap: (last_used, tiebreak, node); an entry is
        # live iff its timestamp still equals the node's last_used and the
        # node is still in the tree (parent set)
        self._heap: List[Tuple[int, int, RadixNode]] = []
        self._live_nodes = 0
        # stats (ServeReport surfaces these)
        self.lookups = 0
        self.hits = 0
        self.hit_tokens = 0
        self.evictions = 0

    def add_listener(
            self, fn: Callable[[str, Tuple[Tuple[int, ...], ...]], None]) -> None:
        """Subscribe ``fn(event, path)`` to insert/evict events."""
        self._listeners.append(fn)

    def _notify(self, event: str, path: Tuple[Tuple[int, ...], ...]) -> None:
        for fn in self._listeners:
            fn(event, path)

    # -- LRU heap ------------------------------------------------------------
    def _bump(self, node: RadixNode) -> None:
        """Advance a node's LRU clock and push the fresh heap entry (the old
        entry goes stale; it is skipped when it surfaces)."""
        node.last_used = t = next(self._clock)
        heapq.heappush(self._heap, (t, t, node))
        if len(self._heap) > 64 and len(self._heap) > 4 * max(self._live_nodes, 1):
            self._compact()

    def _compact(self) -> None:
        """Drop stale entries (bumped-since or evicted nodes), keeping one
        live entry per node."""
        seen, out = set(), []
        for t, tb, n in self._heap:
            if n.parent is not None and t == n.last_used and id(n) not in seen:
                seen.add(id(n))
                out.append((t, tb, n))
        self._heap = out
        heapq.heapify(self._heap)

    def _path(self, node: RadixNode) -> Tuple[Tuple[int, ...], ...]:
        """Root-to-node chunk path (the listener-event address of a node)."""
        chunks: List[Tuple[int, ...]] = []
        while node.parent is not None:
            chunks.append(node.chunk)
            node = node.parent
        return tuple(reversed(chunks))

    # -- introspection -------------------------------------------------------
    def _nodes(self) -> List[RadixNode]:
        out, stack = [], [self.root]
        while stack:
            n = stack.pop()
            for c in n.children.values():
                out.append(c)
                stack.append(c)
        return out

    @property
    def cached_pages(self) -> int:
        return len(self._nodes())

    @property
    def nodes(self) -> int:
        """Live radix node count (O(1): maintained by insert/evict)."""
        return self._live_nodes

    def evictable_pages(self, protect: Sequence[int] = ()) -> int:
        """Pages reclaimable by cascading LRU eviction right now: cache-only
        (refcount 1) nodes outside ``protect``.  Valid count without walking
        structure because pinned nodes are prefix-closed (see module doc)."""
        protect = set(protect)
        return sum(
            1 for n in self._nodes()
            if self.pool.refcount(n.page) == 1 and n.page not in protect
        )

    # -- lookup --------------------------------------------------------------
    def match(self, prompt: Sequence[int]) -> PrefixMatch:
        """Longest cached prefix of ``prompt``, clamped to ``len(prompt) - 1``
        tokens.  Bumps matched nodes' LRU clocks; takes no references and
        records no stats -- admission decides whether to use the match
        (``KVPagePool.allocate`` increfs the shared pages, forks the COW
        page) and calls ``record`` exactly once per admitted request with the
        match it actually applied, so hit stats stay per-request even when a
        blocked head request is re-matched every scheduler pass."""
        ps = self.page_size
        limit = len(prompt) - 1  # the last token is always recomputed
        node, pages = self.root, []
        depth = 0
        while (depth + 1) * ps <= limit:
            child = node.children.get(tuple(prompt[depth * ps: (depth + 1) * ps]))
            if child is None:
                break
            self._bump(child)
            pages.append(child.page)
            node = child
            depth += 1
        # partial hit: one more cached page whose leading tokens match the
        # remaining prompt (incl. "cached prefix longer than the prompt")
        cow_page, partial = None, 0
        rest = tuple(prompt[depth * ps: limit])
        if rest:
            for chunk, child in node.children.items():
                m = 0
                while m < len(rest) and chunk[m] == rest[m]:
                    m += 1
                if m > partial:
                    cow_page, partial = child.page, m
                    best = child
            if partial:
                self._bump(best)
        return PrefixMatch(pages=tuple(pages), cow_page=cow_page, partial=partial,
                           _full_tokens=depth * ps)

    def record(self, match: Optional[PrefixMatch]) -> None:
        """Count one lookup (and hit) for an ADMITTED request.  ``match`` is
        the match admission actually applied -- None after the matchless
        fallback, which therefore counts as a miss."""
        self.lookups += 1
        if match is not None and match.cached_len:
            self.hits += 1
            self.hit_tokens += match.cached_len

    # -- publication ---------------------------------------------------------
    def insert(self, prompt: Sequence[int], seq_pages: Sequence[int]) -> int:
        """Publish a sequence's full prompt pages (the scheduler calls this at
        ADMISSION, right after allocation: the engine prefills admitted
        requests in order, so any sharer -- even one admitted in the same
        batch -- only ever reads pages an earlier prefill already wrote).

        ``seq_pages`` is the sequence's page list (shared prefix + private
        pages, logical order); chunk ``i`` of the prompt lives in
        ``seq_pages[i]``.  Only whole pages are cacheable -- a partial page's
        tail will be written by decode.  Chunks already in the tree are
        left as-is (LRU-bumped); new chunks take one cache reference on the
        sequence's page, which is what keeps the page alive after the donor
        finishes.  Returns the number of newly published pages."""
        ps = self.page_size
        node, new = self.root, 0
        for i in range(len(prompt) // ps):
            chunk = tuple(prompt[i * ps: (i + 1) * ps])
            child = node.children.get(chunk)
            if child is None:
                child = RadixNode(chunk=chunk, page=seq_pages[i], parent=node)
                node.children[chunk] = child
                self.pool.incref(seq_pages[i])
                self._live_nodes += 1
                new += 1
            self._bump(child)
            node = child
        if self._listeners and len(prompt) >= ps:
            # full published path, new chunks or not: the router view insert
            # is idempotent, and re-announcing keeps it self-healing
            self._notify("insert", self._path(node))
        return new

    # -- eviction ------------------------------------------------------------
    def evict(self, n_pages: int, protect: Sequence[int] = ()) -> int:
        """Free up to ``n_pages`` pool pages by evicting least-recently-used
        refcount-1 leaves (cascading to exposed parents).  ``protect`` pins
        pages a pending admission is about to share.  Returns pages freed.

        Victims pop off the LRU heap (lazy deletion, see module doc) in
        timestamp order.  A popped node that is currently pinned -- protected,
        still read by a live sequence, or interior -- is stashed and re-pushed
        after the pass (it may be evictable on a later call); an interior node
        whose last child is evicted DURING the pass is re-pushed immediately,
        which is what keeps the leaf-first cascade working within one call
        (parents carry OLDER timestamps than their children, so the exposed
        parent is the next pop)."""
        protect = set(protect)
        freed = 0
        stash: List[Tuple[int, int, RadixNode]] = []
        while freed < n_pages and self._heap:
            entry = heapq.heappop(self._heap)
            t, _, node = entry
            if node.parent is None or t != node.last_used:
                continue  # stale: evicted already, or bumped (fresher entry exists)
            if node.children or node.page in protect or self.pool.refcount(node.page) != 1:
                stash.append(entry)
                continue
            parent = node.parent
            if self._listeners:
                self._notify("evict", self._path(node))
            del parent.children[node.chunk]
            node.parent = None  # marks every remaining heap entry for it stale
            self.pool.decref(node.page)  # last owner -> page freed
            self._live_nodes -= 1
            self.evictions += 1
            freed += 1
            if parent is not self.root and not parent.children:
                # cascade: the newly exposed parent was stashed (or popped
                # long ago); give it a live entry so this pass can reach it
                heapq.heappush(self._heap, (parent.last_used, next(self._clock), parent))
        for entry in stash:
            heapq.heappush(self._heap, entry)
        return freed

