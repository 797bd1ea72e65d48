"""The port's ``serve_disagg`` against the port's single-engine ``serve`` and
the JAX package's ``serve_disagg``, float32, packed W4 + RaZeR KV, reduced
llama3_2_3b (KVH 2) and reduced packed dbrx_132b (``_torch_serve_cases``'
engines, shared with the serve tests).

A mixed stream (a shared 8-token head on every other prompt, a duplicate,
Poisson arrivals) on 2 prefill + 2 decode replicas at chunk sizes 16 and
64, on a FakeClock with a Tracer: greedy tokens equal single-engine serve's
and the JAX fleet's; the report's counters, the shipped bytes (0.28125 of
bf16 exactly), every TTFT, decode-stage residency and latency, the busy
times, the makespan and the trace's events equal the JAX fleet's.
"""
import dataclasses

import numpy as np
import pytest

from _torch_serve_cases import COUNTERS, engines, requests
from repro.obs import FakeClock as JaxFakeClock
from repro.obs import Tracer as JaxTracer
from repro.serving.disagg import serve_disagg as jax_serve_disagg
from repro_torch.obs import FakeClock, Tracer
from repro_torch.serving.disagg import DisaggConfig, DisaggReport, serve_disagg
from repro_torch.serving.engine import ServeReport

FLEET = dict(n_prefill=2, n_decode=2, page_size=8)
DISAGG_COUNTERS = ("shipments", "transfer_bytes", "transfer_bf16_bytes", "router_placements",
                   "router_predicted_hit_tokens", "router_prompt_tokens", "page_bytes", "pool_bytes")


def _mixed_specs(n=6, seed=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(1, 256, size=8).tolist()
    prompts = []
    for i in range(n):
        tail = rng.integers(1, 256, size=int(rng.integers(2, 7))).tolist()
        prompts.append(head + tail if i % 2 else tail)
    prompts.append(list(prompts[0]))  # a duplicate rides the stream
    arrivals = np.cumsum(rng.exponential(0.002, size=len(prompts)))
    return [(p, 4, float(a), -1) for p, a in zip(prompts, arrivals)]


@pytest.fixture(scope="module", params=[16, 64], ids=["chunk16", "chunk64"])
def runs(request):
    """(JAX report, port report, port single-engine report, JAX trace, port trace)."""
    specs = _mixed_specs()
    je, te = engines("w4_kv", "llama3_2_3b")
    jtr, ttr = JaxTracer(), Tracer()
    jrep = jax_serve_disagg(je, requests(specs, port=False), chunk_tokens=request.param, clock=JaxFakeClock(tick=0.001),
                            trace=jtr, **FLEET)
    trep = serve_disagg(te, requests(specs, port=True), chunk_tokens=request.param, clock=FakeClock(tick=0.001),
                        trace=ttr, **FLEET)
    single = te.serve(requests(specs, port=True))
    return jrep, trep, single, jtr, ttr


def test_tokens_equal_single_engine_serve(runs):
    _, trep, single, _, _ = runs
    assert trep.outputs == single.outputs
    assert trep.new_tokens == single.new_tokens


def test_tokens_and_counters_equal_jax(runs):
    jrep, trep, _, _, _ = runs
    assert trep.outputs == jrep.outputs
    for name in COUNTERS + DISAGG_COUNTERS:
        assert getattr(trep, name) == getattr(jrep, name), name
    assert trep.shipments == len(trep.requests)
    assert trep.cached_tokens > 0  # the shared head and the duplicate hit a replica's cache


def test_transfer_ratio_is_the_wire_format(runs):
    _, trep, _, _, _ = runs
    assert trep.transfer_ratio == 0.28125
    assert trep.transfer_bytes * 16 == trep.transfer_bf16_bytes * 4.5


def test_fake_clock_report_equals_jax(runs):
    """Every TTFT, decode-stage residency and latency, the per-stage busy
    seconds and rates, and the makespan: the same virtual timeline."""
    jrep, trep, _, _, _ = runs
    assert trep.ttft_values() == jrep.ttft_values()
    assert trep.decode_stage_values() == jrep.decode_stage_values()
    assert trep.latency_values() == jrep.latency_values()
    assert trep.decode_stage_percentile(95) == jrep.decode_stage_percentile(95)
    assert (trep.wall_time, trep.prefill_busy, trep.decode_busy) == (jrep.wall_time, jrep.prefill_busy,
                                                                     jrep.decode_busy)
    assert (trep.prefill_tokens_per_s, trep.decode_tokens_per_s) == (jrep.prefill_tokens_per_s,
                                                                     jrep.decode_tokens_per_s)
    assert trep.router_hit_rate == jrep.router_hit_rate


def test_trace_events_equal_jax(runs):
    """pid 0 router, 1 prefill replicas, 2 decode replicas, virtual times."""
    _, _, _, jtr, ttr = runs
    got, want = ttr.to_json(), jtr.to_json()
    assert got == want
    assert {e["pid"] for e in got["traceEvents"]} == {0, 1, 2}
    names = {e["name"] for e in got["traceEvents"]}
    assert {"route", "prefill_chunk", "ship", "insert", "decode_step", "retire"} <= names


def test_packed_moe_disagg_equals_serve_and_jax():
    rng = np.random.default_rng(2)
    specs = [(rng.integers(1, 256, size=int(n)).tolist(), 3, 0.0, -1) for n in (9, 5, 12)]
    je, te = engines("w4_kv", "dbrx")
    single = te.serve(requests(specs, port=True))
    kw = dict(n_prefill=2, n_decode=1, chunk_tokens=4, page_size=4)
    trep = serve_disagg(te, requests(specs, port=True), **kw)
    jrep = jax_serve_disagg(je, requests(specs, port=False), **kw)
    assert trep.outputs == single.outputs == jrep.outputs
    assert trep.transfer_ratio == 0.28125


def test_cache_off_and_report_shape():
    specs = _mixed_specs(n=4, seed=4)
    _, te = engines("w4_kv", "llama3_2_3b")
    single = te.serve(requests(specs, port=True), prefix_cache=False)
    rep = serve_disagg(te, requests(specs, port=True), cfg=DisaggConfig(prefix_cache=False, page_size=8))
    assert rep.outputs == single.outputs
    # a DisaggReport IS a ServeReport: the shared fields, not copies of them
    assert isinstance(rep, ServeReport) and isinstance(rep, DisaggReport)
    assert {f.name for f in dataclasses.fields(ServeReport)} <= {f.name for f in dataclasses.fields(DisaggReport)}
    assert (rep.cache_lookups, rep.cache_hits, rep.cache_evictions) == (0, 0, 0)
    assert rep.router_hit_rate == 0.0 and (rep.n_prefill, rep.n_decode) == (1, 1)


def test_prefill_replica_reuses_its_cache():
    """Two shared-head prompts on ONE prefill replica: the second prefills
    only its suffix."""
    rng = np.random.default_rng(5)
    head = rng.integers(1, 256, size=16).tolist()
    a = head + rng.integers(1, 256, size=4).tolist()
    b = head + rng.integers(1, 256, size=6).tolist()
    _, te = engines("w4_kv", "llama3_2_3b")
    rep = serve_disagg(te, [a, b], max_new_tokens=2, chunk_tokens=32, page_size=8)
    assert rep.cached_tokens == 16 and rep.cache_hits == 1
    assert rep.prefill_tokens == len(a) + len(b) - 16
    assert rep.outputs == te.generate([list(a), list(b)], max_new_tokens=2)


def test_metrics_is_not_taken_yet():
    """``metrics=`` takes a ``MetricsRegistry`` since the observability
    slice (``test_torch_obs_disagg.py`` holds its snapshot to the JAX
    package's); anything else is an error, not a silent no-op."""
    from repro_torch.obs import MetricsRegistry

    _, te = engines("w4_kv", "llama3_2_3b")
    with pytest.raises(AttributeError):
        serve_disagg(te, [[1, 2, 3]], max_new_tokens=1, metrics=object())
    reg = MetricsRegistry()
    rep = serve_disagg(te, [[1, 2, 3]], max_new_tokens=1, metrics=reg)
    assert reg.get("disagg_shipments_total").value() == rep.shipments == 1
