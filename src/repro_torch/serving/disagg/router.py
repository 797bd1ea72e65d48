"""Prefix-aware router for disaggregated serving (PyTorch port of
``repro.serving.disagg.router``; plain Python, no tensors): place each
request on the prefill replica holding the longest cached prefix and the
least-loaded decode replica.

The router never touches replica state directly.  Each prefill replica's
``PrefixCache`` publishes ``("insert", path)`` / ``("evict", path)`` events
(``path`` = root-to-node tuple of page-sized token chunks) to a listener the
router installs, and the router mirrors them into a per-replica ``RadixView``
-- a bare dict-of-dicts trie with no pages, refcounts, or LRU clocks.
Placement then ranks replicas by walking the views, which (a) costs one trie
walk per replica instead of an RPC to each, and (b) never perturbs a
replica's LRU order the way probing its real tree with ``match`` would.

A view is intentionally a conservative MIRROR, not the source of truth: it
can briefly over-promise (the replica evicted a chunk whose "evict" event
names a path the view already dropped) and the placement still works --
a stale predicted hit only costs the prefill replica a recompute, never
correctness, because admission re-matches against the REAL tree.

Policy, in order:

1. **Longest radix hit wins**: the replica whose view shares the most
   leading prompt tokens (page-aligned chunks + a partial-chunk tail,
   clamped to ``len(prompt) - 1`` exactly like ``PrefixCache.match``).
2. **Load tiebreak**: among replicas tied on hit length (including the
   common all-miss case), the one with the fewest queued-but-uncomputed
   prompt tokens.
3. **Lowest worker id**: the deterministic final tiebreak.

Decode placement is pure least-loaded (resident requests: pending shipments
+ running slots), lowest wid on ties -- decode cost is independent of the
prompt's prefix locality once the pages arrive as a shipment.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence, Tuple

Chunk = Tuple[int, ...]
Path = Tuple[Chunk, ...]


class RadixView:
    """A replica's cached-prefix trie as the router sees it: chunk -> subtrie.

    Maintained purely from ``PrefixCache`` listener events.  ``insert`` is
    idempotent (re-announced paths are no-ops past the first), and ``remove``
    only deletes a leaf -- the cache evicts leaves first, and dropping an
    interior node here would orphan deeper entries the replica still holds.
    """

    def __init__(self, page_size: int):
        self.page_size = page_size
        self.root: Dict[Chunk, dict] = {}

    def insert(self, path: Path) -> None:
        node = self.root
        for chunk in path:
            node = node.setdefault(chunk, {})

    def remove(self, path: Path) -> None:
        if not path:
            return
        node, trail = self.root, []
        for chunk in path:
            child = node.get(chunk)
            if child is None:
                return  # view already dropped it (stale event): fine, see module doc
            trail.append((node, chunk))
            node = child
        parent, chunk = trail[-1]
        if not node:  # only drop a childless mirror node
            del parent[chunk]

    def match_len(self, prompt: Sequence[int]) -> int:
        """Predicted cached-prefix length (tokens) for ``prompt`` on this
        replica, clamped to ``len(prompt) - 1`` -- the same clamp
        ``PrefixCache.match`` applies, so the prediction ranks replicas by
        exactly what admission could reuse."""
        ps = self.page_size
        limit = len(prompt) - 1
        node, depth = self.root, 0
        while (depth + 1) * ps <= limit:
            child = node.get(tuple(prompt[depth * ps: (depth + 1) * ps]))
            if child is None:
                break
            node = child
            depth += 1
        best = 0
        rest = tuple(prompt[depth * ps: limit])
        if rest:
            for chunk in node:
                m = 0
                while m < len(rest) and m < len(chunk) and chunk[m] == rest[m]:
                    m += 1
                best = max(best, m)
        return depth * ps + best

    @property
    def n_chunks(self) -> int:
        count, stack = 0, [self.root]
        while stack:
            node = stack.pop()
            count += len(node)
            stack.extend(node.values())
        return count


@dataclasses.dataclass(frozen=True)
class Placement:
    """One routing decision: replica ids + the hit length that won."""

    prefill: int
    decode: int
    predicted_hit: int


class Router:
    def __init__(self, n_prefill: int, n_decode: int, page_size: int):
        if n_prefill < 1 or n_decode < 1:
            raise ValueError("router needs >= 1 prefill and >= 1 decode replica")
        self.views = [RadixView(page_size) for _ in range(n_prefill)]
        # queued-but-uncomputed prompt tokens per prefill replica
        self.prefill_load = [0] * n_prefill
        # resident requests (pending shipments + decode slots) per decode replica
        self.decode_load = [0] * n_decode
        # stats (DisaggReport surfaces these)
        self.placements = 0
        self.predicted_hit_tokens = 0
        self.prompt_tokens = 0

    def listener(self, wid: int) -> Callable[[str, Path], None]:
        """The event sink to install on prefill replica ``wid``'s
        ``PrefixCache(listener=...)``."""
        view = self.views[wid]

        def on_event(event: str, path: Path) -> None:
            (view.insert if event == "insert" else view.remove)(path)

        return on_event

    def place(self, prompt: Sequence[int]) -> Placement:
        """Pick replicas for one request (pure decision -- call ``assign`` to
        commit the load so speculative placement stays possible)."""
        hits = [v.match_len(prompt) for v in self.views]
        best = max(hits)
        tied = [i for i, h in enumerate(hits) if h == best]
        p = min(tied, key=lambda i: (self.prefill_load[i], i))
        d = min(range(len(self.decode_load)), key=lambda i: (self.decode_load[i], i))
        return Placement(prefill=p, decode=d, predicted_hit=best)

    def assign(self, placement: Placement, prompt_len: int) -> None:
        """Commit a placement: charge the predicted-uncached prompt tokens to
        the prefill replica and one resident request to the decode replica."""
        self.prefill_load[placement.prefill] += prompt_len - placement.predicted_hit
        self.decode_load[placement.decode] += 1
        self.placements += 1
        self.predicted_hit_tokens += placement.predicted_hit
        self.prompt_tokens += prompt_len

    def prefill_done(self, placement: Placement, prompt_len: int) -> None:
        """Uncharge the tokens ``assign`` charged (the job left the queue)."""
        self.prefill_load[placement.prefill] -= prompt_len - placement.predicted_hit

    def retire(self, placement: Placement) -> None:
        self.decode_load[placement.decode] -= 1

    @property
    def predicted_hit_rate(self) -> float:
        """Fraction of routed prompt tokens the views predicted cached."""
        return self.predicted_hit_tokens / self.prompt_tokens if self.prompt_tokens else 0.0

    def snapshot(self) -> Dict[str, object]:
        """JSON-able routing state: totals plus per-replica load and view
        size (what ``install_router_metrics`` exports, and what a debugging
        session wants to see in one look)."""
        return {
            "placements": self.placements,
            "predicted_hit_tokens": self.predicted_hit_tokens,
            "prompt_tokens": self.prompt_tokens,
            "predicted_hit_rate": self.predicted_hit_rate,
            "prefill_load": list(self.prefill_load),
            "decode_load": list(self.decode_load),
            "view_chunks": [v.n_chunks for v in self.views],
        }


def install_router_metrics(registry, router: Router) -> None:
    """Export a router's placement stats and per-replica load into a
    ``MetricsRegistry``.  Everything is function-backed (read at collection
    time); the placement path never touches a metric."""
    for name, help_, fn in (
        ("router_placements", "Requests placed", lambda: router.placements),
        ("router_predicted_hit_tokens", "Prompt tokens the replica views predicted cached",
         lambda: router.predicted_hit_tokens),
        ("router_prompt_tokens", "Prompt tokens routed", lambda: router.prompt_tokens),
    ):
        registry.gauge(name, help_).set_function(fn)
    load = registry.gauge("router_replica_load",
                          "Queued prompt tokens (prefill) / resident requests (decode) per replica",
                          labels=("stage", "replica"))
    chunks = registry.gauge("router_view_chunks", "Mirrored radix chunks per prefill replica view",
                            labels=("replica",))
    for i in range(len(router.prefill_load)):
        load.set_function(lambda i=i: router.prefill_load[i], stage="prefill", replica=str(i))
        chunks.set_function(lambda i=i: router.views[i].n_chunks, replica=str(i))
    for i in range(len(router.decode_load)):
        load.set_function(lambda i=i: router.decode_load[i], stage="decode", replica=str(i))
