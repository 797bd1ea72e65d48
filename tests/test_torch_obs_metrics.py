"""The port's metrics registry against the JAX package's, and the port's
``Tracer`` export against the committed trace golden.

Each case applies the same operations to a ``MetricsRegistry`` of each
package (the cases of ``tests/test_obs.py``): the Prometheus text
(``expose``), the JSON ``snapshot`` and every error raised on the way must
be identical.
"""
import json
import math
from pathlib import Path

import pytest

import repro.obs as jax_obs
import repro.obs.metrics as jax_metrics
import repro_torch.obs as torch_obs
import repro_torch.obs.metrics as torch_metrics

GOLDEN = Path(__file__).parent / "data" / "trace_golden.json"
PACKAGES = [(jax_obs, jax_metrics), (torch_obs, torch_metrics)]


def _counter(obs, metrics, log):
    reg = obs.MetricsRegistry()
    c = reg.counter("reqs_total", "requests", labels=("stage",))
    c.inc(stage="prefill")
    c.inc(2.5, stage="prefill")
    log.append((c.value(stage="prefill"), c.value(stage="decode")))
    _raises(log, lambda: c.inc(-1, stage="prefill"))
    return reg


def _labels(obs, metrics, log):
    reg = obs.MetricsRegistry()
    c = reg.counter("x_total", labels=("stage",))
    _raises(log, lambda: c.inc())
    _raises(log, lambda: c.inc(stage="a", extra="b"))
    _raises(log, lambda: reg.counter("bad-name"))
    _raises(log, lambda: reg.counter("ok_total", labels=("bad-label",)))
    c.inc(stage="a")
    return reg


def _cardinality(obs, metrics, log):
    reg = obs.MetricsRegistry()
    c = reg.counter("x_total", labels=("rid",), max_series=3)
    for i in range(3):
        c.inc(rid=i)
    _raises(log, lambda: c.inc(rid=99))
    c.inc(rid=1)  # an existing series is still fine
    g = reg.gauge("depth", labels=("q",), max_series=1)
    g.set(1, q="a")
    _raises(log, lambda: g.set(2, q="b"))
    h = metrics.Histogram("h_seconds", labels=("rid",), max_series=2)
    h.observe(0.1, rid=0)
    h.observe(0.2, rid=1)
    _raises(log, lambda: h.observe(0.3, rid=2))
    log.append((h.count(rid=0), h.cumulative(rid=1)))
    return reg


def _idempotent(obs, metrics, log):
    reg = obs.MetricsRegistry()
    a = reg.counter("x_total", "help", labels=("s",))
    log.append(reg.counter("x_total", labels=("s",)) is a)
    _raises(log, lambda: reg.gauge("x_total", labels=("s",)))
    _raises(log, lambda: reg.counter("x_total", labels=("other",)))
    log.append((reg.get("x_total") is a, reg.get("missing")))
    return reg


def _gauges(obs, metrics, log):
    reg = obs.MetricsRegistry()
    g = reg.gauge("depth", "queue depth", labels=("q",))
    g.set(4, q="a")
    g.inc(q="a")
    g.dec(0.5, q="a")
    box = {"v": 7}
    g.set_function(lambda: box["v"], q="b")
    log.append((g.value(q="a"), g.value(q="b")))
    box["v"] = 9  # read at collection time, not at registration
    log.append(g.value(q="b"))
    _raises(log, lambda: g.inc(q="b"))
    return reg


def _histogram_edges(obs, metrics, log):
    reg = obs.MetricsRegistry()
    h = reg.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
    for v in (0.01, 0.05, 1.0, 50.0):  # le semantics: a value on an edge lands in that bucket
        h.observe(v)
    log.append((h.cumulative(), h.count(), h.sum()))
    _raises(log, lambda: reg.histogram("bad_seconds", buckets=(0.1, 0.1)))
    _raises(log, lambda: reg.histogram("bad2_seconds", buckets=()))
    return reg


def _percentiles(obs, metrics, log):
    reg = obs.MetricsRegistry()
    h = reg.histogram("ttft_seconds", labels=("stage",))
    log.append(h.buckets == obs.DEFAULT_BUCKETS)
    for v in (0.010, 0.020, 0.030, 0.040, 0.0005, 12.0):
        h.observe(v, stage="e")
    log.append([h.percentile(q, stage="e") for q in (0, 50, 95, 99, 100)])
    log.append(h.percentile(50, stage="missing"))
    vals = [0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0]
    log.append([obs.percentile(vals, q) for q in (0, 50, 95, 99, 100)] + [obs.percentile([], 50)])
    _raises(log, lambda: obs.percentile(vals, 101))
    return reg


def _expose_exact(obs, metrics, log):
    reg = obs.MetricsRegistry()
    reg.counter("reqs_total", "served requests", labels=("stage",)).inc(3, stage="prefill")
    reg.gauge("depth", "queue depth").set(2)
    reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0)).observe(0.5)
    reg.gauge("big", "a large value").set(1e16)
    reg.gauge("frac", "a fraction").set(0.125)
    return reg


def _escaping(obs, metrics, log):
    reg = obs.MetricsRegistry()
    reg.counter("x_total", labels=("p",)).inc(p='a"b\\c\nd')
    reg.gauge("y", labels=("p", "q")).set(-3.5, p="z", q="")
    return reg


def _snapshot(obs, metrics, log):
    reg = obs.MetricsRegistry()
    h = reg.histogram("lat_seconds", "latency", labels=("stage",), buckets=(0.1, 1.0))
    for v in (0.05, 0.2, 0.9):
        h.observe(v, stage="e")
    h.observe(3.0, stage="d")
    reg.gauge("depth").set_function(lambda: 5)
    reg.counter("c_total", labels=("a", "b")).inc(2, a="x", b="y")
    snap = reg.snapshot()
    json.dumps(snap)  # JSON-able: the function gauges resolved
    log.append(math.isfinite(snap["lat_seconds"]["series"][0]["sum"]))
    return reg


def _null(obs, metrics, log):
    for m in (obs.NULL_COUNTER, obs.NULL_GAUGE, obs.NULL_HISTOGRAM):
        m.inc(5, anything="goes")
        m.dec(1)
        m.observe(1.0)
        m.set(2)
        m.set_function(lambda: 1)
        log.append((m.value(), m.count(), m.percentile(99)))
    return obs.MetricsRegistry()


def _raises(log, fn):
    try:
        fn()
    except ValueError as e:
        log.append(("ValueError", str(e)))
    else:
        log.append("no error")


CASES = [_counter, _labels, _cardinality, _idempotent, _gauges, _histogram_edges, _percentiles, _expose_exact,
         _escaping, _snapshot, _null]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__.strip("_") for c in CASES])
def test_registry_equals_jax(case):
    (jlog, jreg), (tlog, treg) = [((log := []), case(obs, metrics, log)) for obs, metrics in PACKAGES]
    assert tlog == jlog
    assert treg.expose() == jreg.expose()
    assert treg.snapshot() == jreg.snapshot()
    assert json.dumps(treg.snapshot(), sort_keys=True) == json.dumps(jreg.snapshot(), sort_keys=True)


def test_expose_text_is_prometheus():
    """The exposition's exact text (the JAX package's own expectation)."""
    reg = torch_obs.MetricsRegistry()
    reg.counter("reqs_total", "served requests", labels=("stage",)).inc(3, stage="prefill")
    reg.gauge("depth", "queue depth").set(2)
    reg.histogram("lat_seconds", "latency", buckets=(0.1, 1.0)).observe(0.5)
    assert reg.expose() == (
        "# HELP reqs_total served requests\n"
        "# TYPE reqs_total counter\n"
        'reqs_total{stage="prefill"} 3\n'
        "# HELP depth queue depth\n"
        "# TYPE depth gauge\n"
        "depth 2\n"
        "# HELP lat_seconds latency\n"
        "# TYPE lat_seconds histogram\n"
        'lat_seconds_bucket{le="0.1"} 0\n'
        'lat_seconds_bucket{le="1"} 1\n'
        'lat_seconds_bucket{le="+Inf"} 1\n'
        "lat_seconds_sum 0.5\n"
        "lat_seconds_count 1\n"
    )


def test_port_exports_the_jax_obs_names():
    assert set(jax_obs.__all__) <= set(torch_obs.__all__)


def _sample_tracer(obs):
    """``tests/test_obs.py::_sample_tracer``: every event shape."""
    tr = obs.Tracer(clock=obs.FakeClock(tick=0.001))
    tr.set_track(0, 0, process="engine", thread="serve")
    tr.set_track(1, 3, process="prefill", thread="prefill/3")
    tr.instant("admit", rid=7, prompt=12)
    with tr.span("prefill", rid=7, tokens=12):
        with tr.span("chunk", idx=0):
            pass
    tr.complete("prefill_chunk", 0.25, 0.125, pid=1, tid=3, rid=7)
    tr.instant("ship", ts=0.375, pid=1, tid=3, nbytes=4096)
    tr.instant("retire", rid=7, new_tokens=4)
    return tr


def test_tracer_export_equals_trace_golden(tmp_path):
    """The port's ``Tracer`` export is byte-identical to the committed
    golden of the JAX package's tracer."""
    out = tmp_path / "trace.json"
    _sample_tracer(torch_obs).export(str(out))
    assert out.read_text() == GOLDEN.read_text()
    assert _sample_tracer(torch_obs).to_json() == _sample_tracer(jax_obs).to_json()
