"""Injectable time sources for the serving stack (a copy of the JAX
package's ``obs/clock.py``, which imports no JAX; the port keeps its own).

Every serving loop used to hard-code ``time.perf_counter()`` lambdas, which
made latency stats untestable without real sleeps and made traces
non-reproducible.  ``Clock`` is the one seam: the engine, the speculative
decoder, and the disagg orchestrator all take a clock and never call
``time`` directly, so

* production runs use ``Clock()`` (monotonic wall time, real sleeps);
* tests use ``FakeClock`` -- ``now()`` is deterministic, ``sleep``
  advances instantly, and an optional per-call ``tick`` turns every
  measured duration into an exact constant (deterministic traces);
* the disagg orchestrator's *virtual* per-worker clocks stay what they
  are (plain floats it advances by measured durations) -- the injectable
  clock is what does the measuring.
"""
from __future__ import annotations

import time

__all__ = ["Clock", "FakeClock"]


class Clock:
    """Monotonic wall clock: ``now()`` seconds via ``time.perf_counter``,
    ``sleep()`` via ``time.sleep``."""

    def now(self) -> float:
        return time.perf_counter()

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            time.sleep(seconds)


class FakeClock(Clock):
    """Deterministic clock for tests.

    ``now()`` returns the current virtual time, then advances it by
    ``tick`` (default 0: time stands still unless advanced explicitly).
    ``sleep`` advances virtual time instantly -- a serve loop waiting for
    the next arrival "waits" without wall time passing, so arrival-relative
    stats (TTFT, latency) come out EXACT instead of sleep-jittered.
    With ``tick > 0`` every ``t1 - t0`` measurement spanning no other
    ``now()`` call equals exactly ``tick``, which makes measured-duration
    traces byte-for-byte reproducible."""

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self._t = float(start)
        self.tick = float(tick)

    def now(self) -> float:
        t = self._t
        self._t += self.tick
        return t

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            self._t += seconds

    def advance(self, seconds: float) -> None:
        """Move virtual time forward explicitly."""
        if seconds < 0:
            raise ValueError(f"cannot advance a clock backwards ({seconds})")
        self._t += seconds
