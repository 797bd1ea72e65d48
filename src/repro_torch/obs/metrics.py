"""Label-aware metrics registry: counters, gauges, histograms (a copy of the
JAX package's ``obs/metrics.py``, which imports no JAX).

The serving layer surfaces per-stage load, pool occupancy and latency
percentiles two ways: a Prometheus-style text exposition
(``MetricsRegistry.expose``) and a JSON snapshot (``snapshot``).
Conventions:

* metric names are ``snake_case`` with a subsystem prefix
  (``pool_pages``, ``serve_ttft_seconds``); counters end ``_total``;
* labels are declared at registration and enforced per sample -- a sample
  naming an undeclared label (or omitting a declared one) raises, so label
  sets cannot drift silently, and ``max_series`` bounds accidental
  cardinality explosions (a label carrying request ids would otherwise grow
  without limit);
* histograms keep BOTH fixed cumulative buckets (the exposition format)
  and the raw observations, so ``percentile`` is exact nearest-rank
  p50/p95/p99, not a bucket-boundary estimate.

Gauges accept ``set_function``: the value is read at collection time, which
is how pool/cache occupancy export without the hot loop touching the
registry at all.
"""
from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "percentile",
    "NULL_COUNTER", "NULL_GAUGE", "NULL_HISTOGRAM", "DEFAULT_BUCKETS",
]

# latency-shaped default edges (seconds), 0.5 ms .. 10 s
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def percentile(values: Sequence[float], q: float) -> float:
    """Exact nearest-rank percentile (q in [0, 100]); 0.0 on no data."""
    if not values:
        return 0.0
    if not 0 <= q <= 100:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    s = sorted(values)
    rank = max(1, math.ceil(q / 100 * len(s)))
    return s[rank - 1]


class Metric:
    """Shared series bookkeeping: one value-state per label-value tuple."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = (),
                 max_series: int = 1000):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r} (want snake_case)")
        for l in labels:
            if not _NAME_RE.match(l):
                raise ValueError(f"metric {name}: invalid label name {l!r}")
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self.max_series = max_series
        self._series: Dict[Tuple[str, ...], Any] = {}

    def _key(self, labelvals: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labelvals) != set(self.labels):
            raise ValueError(
                f"metric {self.name} declares labels {list(self.labels)}, "
                f"sample has {sorted(labelvals)}"
            )
        key = tuple(str(labelvals[l]) for l in self.labels)
        if key not in self._series and len(self._series) >= self.max_series:
            raise ValueError(
                f"metric {self.name}: label cardinality exceeded "
                f"({self.max_series} series); a label is carrying unbounded "
                f"values (request ids, timestamps?)"
            )
        return key

    def _labels_of(self, key: Tuple[str, ...]) -> Dict[str, str]:
        return dict(zip(self.labels, key))

    def series_keys(self) -> List[Tuple[str, ...]]:
        return sorted(self._series)


class Counter(Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {value})")
        key = self._key(labels)
        self._series[key] = self._series.get(key, 0.0) + value

    def value(self, **labels) -> float:
        return self._series.get(self._key(labels), 0.0)


class Gauge(Metric):
    """Point-in-time value; ``set_function`` defers the read to collection
    time (pool occupancy, queue depth -- the hot loop never touches it)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[self._key(labels)] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = self._key(labels)
        cur = self._series.get(key, 0.0)
        if callable(cur):
            raise ValueError(f"gauge {self.name} series is function-backed")
        self._series[key] = cur + value

    def dec(self, value: float = 1.0, **labels) -> None:
        self.inc(-value, **labels)

    def set_function(self, fn: Callable[[], float], **labels) -> None:
        self._series[self._key(labels)] = fn

    def value(self, **labels) -> float:
        v = self._series.get(self._key(labels), 0.0)
        return float(v()) if callable(v) else v


class _HistState:
    __slots__ = ("counts", "sum", "raw")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # + the +Inf bucket
        self.sum = 0.0
        self.raw: List[float] = []


class Histogram(Metric):
    """Fixed cumulative buckets for exposition + raw values for exact
    percentiles.  ``buckets`` are upper edges (``le`` semantics: a value
    equal to an edge lands in that bucket), strictly increasing; the +Inf
    bucket is implicit."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labels: Sequence[str] = (),
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 max_series: int = 1000):
        super().__init__(name, help, labels, max_series)
        edges = tuple(float(b) for b in buckets)
        if not edges or any(nxt <= prev for nxt, prev in zip(edges[1:], edges)):
            raise ValueError(
                f"histogram {name}: bucket edges must be non-empty and "
                f"strictly increasing, got {edges}"
            )
        self.buckets = edges

    def _state(self, labels: Dict[str, Any]) -> _HistState:
        key = self._key(labels)
        st = self._series.get(key)
        if st is None:
            st = self._series[key] = _HistState(len(self.buckets))
        return st

    def observe(self, value: float, **labels) -> None:
        st = self._state(labels)
        i = 0
        while i < len(self.buckets) and value > self.buckets[i]:
            i += 1
        st.counts[i] += 1
        st.sum += value
        st.raw.append(value)

    def count(self, **labels) -> int:
        key = self._key(labels)
        return len(self._series[key].raw) if key in self._series else 0

    def sum(self, **labels) -> float:
        key = self._key(labels)
        return self._series[key].sum if key in self._series else 0.0

    def cumulative(self, **labels) -> List[int]:
        """Cumulative counts per edge (+Inf last) -- the exposition shape."""
        key = self._key(labels)
        counts = self._series[key].counts if key in self._series \
            else [0] * (len(self.buckets) + 1)
        out, acc = [], 0
        for c in counts:
            acc += c
            out.append(acc)
        return out

    def percentile(self, q: float, **labels) -> float:
        """Exact nearest-rank percentile over the raw observations."""
        key = self._key(labels)
        return percentile(self._series[key].raw if key in self._series else (), q)


class _NullMetric:
    """No-op stand-in when metrics are disabled: every mutator accepts and
    drops; readers return zero."""

    __slots__ = ()

    def inc(self, *a, **k):
        pass

    def dec(self, *a, **k):
        pass

    def set(self, *a, **k):
        pass

    def set_function(self, *a, **k):
        pass

    def observe(self, *a, **k):
        pass

    def value(self, **k) -> float:
        return 0.0

    def count(self, **k) -> int:
        return 0

    def percentile(self, q, **k) -> float:
        return 0.0


NULL_COUNTER = NULL_GAUGE = NULL_HISTOGRAM = _NullMetric()


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def _label_str(labels: Dict[str, str], extra: Optional[Tuple[str, str]] = None) -> str:
    items = list(labels.items()) + ([extra] if extra else [])
    if not items:
        return ""
    esc = lambda v: v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")
    return "{" + ",".join(f'{k}="{esc(str(v))}"' for k, v in items) + "}"


class MetricsRegistry:
    """Ordered collection of metrics with idempotent registration: asking
    for an existing name returns the existing metric if the kind and label
    set agree, and raises otherwise (two subsystems silently sharing a name
    with different schemas is the bug this catches)."""

    def __init__(self):
        self._metrics: Dict[str, Metric] = {}

    def _register(self, cls, name: str, help: str, labels: Sequence[str],
                  **kw) -> Metric:
        existing = self._metrics.get(name)
        if existing is not None:
            if type(existing) is not cls or existing.labels != tuple(labels):
                raise ValueError(
                    f"metric {name} already registered as {existing.kind} with "
                    f"labels {list(existing.labels)}; cannot re-register as "
                    f"{cls.kind} with labels {list(labels)}"
                )
            return existing
        m = cls(name, help, labels, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "", labels: Sequence[str] = (),
                max_series: int = 1000) -> Counter:
        return self._register(Counter, name, help, labels, max_series=max_series)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = (),
              max_series: int = 1000) -> Gauge:
        return self._register(Gauge, name, help, labels, max_series=max_series)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  max_series: int = 1000) -> Histogram:
        return self._register(Histogram, name, help, labels, buckets=buckets,
                              max_series=max_series)

    def get(self, name: str) -> Optional[Metric]:
        return self._metrics.get(name)

    def __iter__(self) -> Iterable[Metric]:
        return iter(self._metrics.values())

    # -- output --------------------------------------------------------------
    def expose(self) -> str:
        """Prometheus text exposition (stable ordering: registration order,
        label-sorted series)."""
        lines: List[str] = []
        for m in self._metrics.values():
            lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            for key in m.series_keys():
                labels = m._labels_of(key)
                if isinstance(m, Histogram):
                    cum = m.cumulative(**labels)
                    for edge, c in zip(m.buckets, cum):
                        lines.append(
                            f"{m.name}_bucket"
                            f"{_label_str(labels, ('le', _fmt(edge)))} {c}")
                    lines.append(
                        f"{m.name}_bucket{_label_str(labels, ('le', '+Inf'))} "
                        f"{cum[-1]}")
                    lines.append(f"{m.name}_sum{_label_str(labels)} "
                                 f"{_fmt(m.sum(**labels))}")
                    lines.append(f"{m.name}_count{_label_str(labels)} "
                                 f"{cum[-1]}")
                elif isinstance(m, Gauge):
                    lines.append(f"{m.name}{_label_str(labels)} "
                                 f"{_fmt(m.value(**labels))}")
                else:
                    lines.append(f"{m.name}{_label_str(labels)} "
                                 f"{_fmt(m.value(**labels))}")
        return "\n".join(lines) + ("\n" if lines else "")

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able dict: every metric, every series, with exact p50/p95/p99
        for histograms (function gauges resolved now)."""
        out: Dict[str, Any] = {}
        for m in self._metrics.values():
            series = []
            for key in m.series_keys():
                labels = m._labels_of(key)
                if isinstance(m, Histogram):
                    series.append({
                        "labels": labels,
                        "count": m.count(**labels),
                        "sum": m.sum(**labels),
                        "p50": m.percentile(50, **labels),
                        "p95": m.percentile(95, **labels),
                        "p99": m.percentile(99, **labels),
                        "buckets": {_fmt(e): c for e, c in
                                    zip(self._edges(m), m.cumulative(**labels))},
                    })
                else:
                    series.append({"labels": labels, "value": m.value(**labels)})
            out[m.name] = {"kind": m.kind, "help": m.help, "series": series}
        return out

    @staticmethod
    def _edges(m: Histogram) -> Tuple:
        return tuple(m.buckets) + (float("inf"),)
