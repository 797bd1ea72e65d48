"""Deterministic single-process orchestrator for disaggregated serving
(PyTorch port of ``repro.serving.disagg.orchestrator``).

``serve_disagg`` runs N prefill replicas and M decode replicas as a
discrete-event simulation: every worker carries a **virtual clock**, the
orchestrator repeatedly picks the earliest runnable event (a request
arriving at the router, a prefill chunk, a decode insert + step), runs that
worker's real compute on the real device, and advances the worker's clock
by the MEASURED duration.  Hence:

* greedy outputs equal single-engine ``Engine.serve``'s whatever the event
  timing: each sequence's logits depend only on its own wire-format pages
  and tokens, never on batch composition or replica placement; and the
  event order is deterministic on ties (route < prefill < decode, then wid);
* replica clocks overlap the way real disaggregated workers would (a decode
  replica's clock moves only with ITS OWN work), so
  ``DisaggReport.decode_tokens_per_s`` is the decode stage's own rate, and
  ``wall_time`` is the simulated makespan.

On the card each worker's step ends with its device work done before the
orchestrator reads the clock (``device.sync``), so a duration covers the
kernels, not their launch.

A completed prefill's ``PageShipment`` becomes insertable on its decode
replica at ``completion + nbytes * 8 / (transfer_gbps * 1e9)``
(instantaneous by default).  Shipping RaZeR wire pages costs 4.5/16 of bf16
KV: the report's ``transfer_ratio``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.obs import NULL_TRACER, Clock, percentile
from repro_torch.parallel.sharding import sharding_ctx

from ..engine import ServeReport
from ..pagepool import PagePoolConfig, install_pool_metrics
from ..prefixcache import install_cache_metrics
from .router import Placement, Router, install_router_metrics
from .workers import DecodeWorker, PrefillWorker

__all__ = ["DisaggConfig", "DisaggReport", "serve_disagg"]


@dataclasses.dataclass(frozen=True)
class DisaggConfig:
    """Disaggregated-serving knobs.

    ``prefill_pages`` / ``decode_pages`` size each replica's pool (pages per
    replica; default: ``max_slots`` worst-case sequences, as single-engine
    ``serve``).  ``transfer_gbps`` models the prefill -> decode wire (0:
    the hand-off is instantaneous)."""

    n_prefill: int = 1
    n_decode: int = 1
    chunk_tokens: int = 64
    max_slots: int = 8
    page_size: int = 16
    prefill_pages: Optional[int] = None
    decode_pages: Optional[int] = None
    prefix_cache: bool = True
    transfer_gbps: float = 0.0


@dataclasses.dataclass
class DisaggReport(ServeReport):
    """``ServeReport`` (the same fields and meanings; ``wall_time`` is the
    simulated makespan) plus the disaggregation's own.

    ``peak_pages`` / ``peak_slots`` sum per-replica peaks; ``prefill_busy``
    / ``decode_busy`` sum measured compute seconds per stage across
    replicas, so the per-stage rates divide work by the time the stage
    worked, not by the makespan."""

    n_prefill: int = 1
    n_decode: int = 1
    shipments: int = 0
    transfer_bytes: int = 0
    transfer_bf16_bytes: int = 0
    router_placements: int = 0
    router_predicted_hit_tokens: int = 0
    router_prompt_tokens: int = 0
    prefill_busy: float = 0.0
    decode_busy: float = 0.0

    @property
    def router_hit_rate(self) -> float:
        """Fraction of prompt tokens the router's replica views predicted
        cached (``cache_hit_rate`` is what admission realized)."""
        if not self.router_prompt_tokens:
            return 0.0
        return self.router_predicted_hit_tokens / self.router_prompt_tokens

    @property
    def transfer_ratio(self) -> float:
        """Shipped bytes / bf16 bytes of the same pages: 4.5/16 = 0.28125."""
        if not self.transfer_bf16_bytes:
            return 0.0
        return self.transfer_bytes / self.transfer_bf16_bytes

    @property
    def prefill_tokens_per_s(self) -> float:
        """Computed prompt tokens per prefill-stage busy second."""
        return self.prefill_tokens / max(self.prefill_busy, 1e-9)

    @property
    def decode_tokens_per_s(self) -> float:
        """Generated tokens per decode-stage busy second: the stage's own
        rate, independent of the prefill load."""
        return self.new_tokens / max(self.decode_busy, 1e-9)

    def decode_stage_values(self) -> List[float]:
        """Per-request decode-stage residency (s): first token to finish."""
        return [r.finish_time - r.first_token_time for r in self.requests
                if r.finish_time is not None and r.first_token_time is not None]

    def decode_stage_percentile(self, q: float) -> float:
        return percentile(self.decode_stage_values(), q)


def serve_disagg(engine, requests, *, cfg: Optional[DisaggConfig] = None, max_new_tokens: Optional[int] = None,
                 clock=None, trace=None, metrics=None, **knobs) -> DisaggReport:
    """Serve a request stream on a disaggregated prefill/decode fleet.

    ``engine`` is a ``serving.Engine``: every replica shares its params and
    forwards and owns only its pool.  ``requests`` is anything
    ``Engine.serve`` takes: raw token-id prompts or ``scheduler.Request``s
    with arrivals.  Knobs come from ``cfg`` or keyword overrides
    (``n_prefill=2, chunk_tokens=32, ...``, see ``DisaggConfig``).  Greedy
    outputs equal single-engine ``Engine.serve``'s on the same stream.

    A request: the router places it (longest prefix-view hit, then least
    load); its prefill replica prefills it in chunks of at most
    ``chunk_tokens`` tokens, reusing its radix cache, and samples the first
    token; its pages ship in the wire format; its decode replica's insert
    stage scatters them into free pages and seats a slot; decode steps run
    to eos or ``max_new_tokens``.

    ``clock`` (an ``obs.Clock``; under ``obs.FakeClock(tick=...)`` every
    measured duration is an exact constant) times every event.  ``trace``
    (an ``obs.Tracer``) records the fleet with VIRTUAL times through
    ``Tracer.complete``: pid 0 the router (``route`` instants), pid 1 the
    prefill replicas (``prefill_chunk`` / ``ship``, one tid per wid), pid 2
    the decode replicas (``insert`` / ``decode_step`` / ``retire``).
    ``metrics`` (an ``obs.MetricsRegistry``) exports per-replica pool and
    cache occupancy labelled by stage and replica, the router's load, the
    latency histograms and token counters under stage ``disagg``, the
    shipment and transfer-byte counters and each stage's busy seconds."""
    cfg = dataclasses.replace(cfg or DisaggConfig(), **knobs)
    n_new = max_new_tokens or engine.scfg.max_new_tokens
    reqs = engine._as_requests(requests, n_new)

    pps = -(-engine.scfg.max_len // cfg.page_size)
    mk_pool = lambda pages: PagePoolConfig(num_pages=pages, page_size=cfg.page_size,  # noqa: E731
                                           max_len=engine.scfg.max_len)
    p_pool = mk_pool(cfg.prefill_pages or cfg.max_slots * pps)
    d_pool = mk_pool(cfg.decode_pages or cfg.max_slots * pps)

    router = Router(cfg.n_prefill, cfg.n_decode, cfg.page_size)
    pws = [PrefillWorker(i, engine, p_pool, chunk_tokens=cfg.chunk_tokens, prefix_cache=cfg.prefix_cache,
                         listener=router.listener(i) if cfg.prefix_cache else None)
           for i in range(cfg.n_prefill)]
    dws = [DecodeWorker(i, engine, d_pool, max_slots=cfg.max_slots) for i in range(cfg.n_decode)]

    clock = clock if clock is not None else Clock()
    tracer = trace if trace is not None else NULL_TRACER
    if tracer.enabled:
        tracer.set_track(0, 0, process="router", thread="route")
        for w in pws:
            tracer.set_track(1, w.wid, process="prefill", thread=f"prefill/{w.wid}")
        for d in dws:
            tracer.set_track(2, d.wid, process="decode", thread=f"decode/{d.wid}")
    if metrics is not None:
        for w in pws:
            install_pool_metrics(metrics, w.pool, stage="prefill", replica=str(w.wid))
            if w.cache is not None:
                install_cache_metrics(metrics, w.cache, stage="prefill", replica=str(w.wid))
        for d in dws:
            install_pool_metrics(metrics, d.pool, stage="decode", replica=str(d.wid))
        install_router_metrics(metrics, router)

    # arrival order (FIFO on ties, as the single-engine scheduler)
    waiting = sorted(reqs, key=lambda r: (r.arrival, r.rid))
    dest: Dict[int, Placement] = {}
    transfer_s = (lambda ship: ship.nbytes * 8 / (cfg.transfer_gbps * 1e9)) \
        if cfg.transfer_gbps > 0 else (lambda ship: 0.0)

    with sharding_ctx(engine.mesh):
        while waiting or any(w.has_work for w in pws) or any(d.has_work for d in dws):
            # earliest runnable event; priority breaks ties (route, then
            # prefill by wid, then decode by wid)
            events = []
            if waiting:
                events.append((waiting[0].arrival, 0, "route", None))
            for w in pws:
                if w.has_work:
                    events.append((max(w.t, w.next_ready()), 1 + w.wid, "prefill", w))
            for d in dws:
                if d.running:
                    events.append((d.t, 1 + cfg.n_prefill + d.wid, "decode", d))
                elif d.pending:
                    events.append((max(d.t, d.next_ready()), 1 + cfg.n_prefill + d.wid, "decode", d))
            t, _, kind, worker = min(events, key=lambda e: e[:2])

            if kind == "route":
                req = waiting.pop(0)
                placement = router.place(req.prompt)
                router.assign(placement, len(req.prompt))
                dest[req.rid] = placement
                pws[placement.prefill].submit(req, ready_at=req.arrival)
                tracer.instant("route", ts=t, pid=0, tid=0, rid=req.rid, prefill=placement.prefill,
                               decode=placement.decode, predicted_hit=placement.predicted_hit)
                continue

            worker.t = t
            t0 = clock.now()
            if kind == "prefill":
                job = worker.queue[0]
                chunk_start = job.done
                done = worker.step(worker.t)
                dur = clock.now() - t0
                tracer.complete("prefill_chunk", worker.t, dur, pid=1, tid=worker.wid, rid=job.req.rid,
                                start_tok=chunk_start, end_tok=job.done)
                worker.t += dur
                worker.busy += dur
                if done is not None:
                    req, shipment, first = done
                    req.first_token_time = worker.t  # sampled as the chunk lands
                    placement = dest[req.rid]
                    router.prefill_done(placement, len(req.prompt))
                    dws[placement.decode].enqueue(req, shipment, first, ready_at=worker.t + transfer_s(shipment))
                    tracer.instant("ship", ts=worker.t, pid=1, tid=worker.wid, rid=req.rid,
                                   nbytes=shipment.nbytes, decode=placement.decode)
            else:
                ships0, steps0 = worker.shipments, worker.decode_steps
                retired = worker.insert(worker.t)
                t_ins = clock.now() - t0
                batch = len(worker.running)
                retired += worker.step(worker.t)
                dur = clock.now() - t0
                if tracer.enabled:
                    # virtual-time spans: the insert stage, then the decode
                    # step, end to end on this replica's track
                    if worker.shipments > ships0:
                        tracer.complete("insert", worker.t, t_ins, pid=2, tid=worker.wid,
                                        shipments=worker.shipments - ships0)
                    if worker.decode_steps > steps0:
                        tracer.complete("decode_step", worker.t + t_ins, dur - t_ins, pid=2, tid=worker.wid,
                                        batch=batch)
                worker.t += dur
                worker.busy += dur
                for req in retired:
                    req.finish_time = worker.t  # tokens land as the step completes
                    router.retire(dest[req.rid])
                    tracer.instant("retire", ts=worker.t, pid=2, tid=worker.wid, rid=req.rid,
                                   new_tokens=len(req.out_tokens))

    wall = max([w.t for w in pws] + [d.t for d in dws], default=0.0)
    report = DisaggReport(
        requests=reqs, wall_time=wall, new_tokens=sum(len(r.out_tokens) for r in reqs),
        decode_steps=sum(d.decode_steps for d in dws), prefill_tokens=sum(w.prefill_tokens for w in pws),
        peak_pages=sum(w.peak_pages for w in pws) + sum(d.peak_pages for d in dws),
        peak_slots=sum(d.peak_slots for d in dws), page_bytes=dws[0].pool.bytes_per_page(),
        pool_bytes=sum(w.pool.total_bytes() for w in pws) + sum(d.pool.total_bytes() for d in dws),
        cached_tokens=sum(w.cached_tokens for w in pws),
        cache_lookups=sum(w.cache.lookups for w in pws if w.cache),
        cache_hits=sum(w.cache.hits for w in pws if w.cache),
        cache_evictions=sum(w.cache.evictions for w in pws if w.cache),
        n_prefill=cfg.n_prefill, n_decode=cfg.n_decode, shipments=sum(d.shipments for d in dws),
        transfer_bytes=sum(d.imported_bytes for d in dws),
        transfer_bf16_bytes=sum(d.imported_bf16_bytes for d in dws),
        router_placements=router.placements, router_predicted_hit_tokens=router.predicted_hit_tokens,
        router_prompt_tokens=router.prompt_tokens, prefill_busy=sum(w.busy for w in pws),
        decode_busy=sum(d.busy for d in dws),
    )
    if metrics is not None:
        report.observe_into(metrics, stage="disagg")
        metrics.counter("disagg_shipments_total", "KV page shipments prefill -> decode").inc(report.shipments)
        metrics.counter("disagg_transfer_bytes_total", "Wire-format bytes shipped").inc(report.transfer_bytes)
        busy = metrics.gauge("stage_busy_seconds", "Measured compute seconds per stage", labels=("stage",))
        busy.set(report.prefill_busy, stage="prefill")
        busy.set(report.decode_busy, stage="decode")
    return report
