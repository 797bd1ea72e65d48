"""Observability seams of the port's serving loop: the injectable clock, the
span recorder and the exact nearest-rank percentile, copied from the JAX
package's JAX-free ``obs`` modules.  No-op and zero-cost unless a caller
passes a tracer or a fake clock."""
from .clock import Clock, FakeClock
from .metrics import percentile
from .trace import NULL_TRACER, NullTracer, Tracer

__all__ = ["Clock", "FakeClock", "Tracer", "NullTracer", "NULL_TRACER", "percentile"]
