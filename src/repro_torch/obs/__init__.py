"""Observability: the injectable clock, structured spans, the metrics
registry and the numerics audit (the JAX package's ``obs``; the clock, the
tracer and the registry are copies of its JAX-free modules, the audit a
port of ``obs/numerics.py`` over the port's tensors).

Zero-overhead when disabled (the default): serving code records against
``NULL_TRACER`` and no registry, which allocate nothing per step.  Enabled,
``Tracer`` exports Chrome trace-event JSON (validated by
``tools/check_trace.py``) and ``MetricsRegistry`` exposes Prometheus text
and JSON snapshots; see ``Engine.serve(trace=, metrics=, clock=,
kv_audit=, profile_dir=)`` and ``serve_disagg`` for the wiring.
"""
from .clock import Clock, FakeClock
from .metrics import (DEFAULT_BUCKETS, NULL_COUNTER, NULL_GAUGE, NULL_HISTOGRAM, Counter, Gauge, Histogram,
                      MetricsRegistry, percentile)
from .numerics import (REPORT_SCHEMA, REPORT_SCHEMA_VERSION, KVAuditor, audit_model, generic_audit,
                       install_numerics_metrics, razer_audit, validate_report)
from .trace import NULL_TRACER, NullTracer, Tracer

__all__ = [
    "Clock", "FakeClock",
    "Tracer", "NullTracer", "NULL_TRACER",
    "MetricsRegistry", "Counter", "Gauge", "Histogram", "percentile",
    "DEFAULT_BUCKETS", "NULL_COUNTER", "NULL_GAUGE", "NULL_HISTOGRAM",
    "audit_model", "razer_audit", "generic_audit", "KVAuditor",
    "install_numerics_metrics", "validate_report",
    "REPORT_SCHEMA", "REPORT_SCHEMA_VERSION",
]
