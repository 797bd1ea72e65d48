"""Latency statistics of the serving stack (the JAX package's
``obs/metrics.py``, of which the port has so far only ``percentile``: the
metrics registry comes with the observability slice)."""
from __future__ import annotations

import math
from typing import Sequence

__all__ = ["percentile"]


def percentile(values: Sequence[float], q: float) -> float:
    """Exact nearest-rank percentile (q in [0, 100]); 0.0 on no data."""
    if not values:
        return 0.0
    if not 0 <= q <= 100:
        raise ValueError(f"percentile q must be in [0, 100], got {q}")
    s = sorted(values)
    rank = max(1, math.ceil(q / 100 * len(s)))
    return s[rank - 1]
