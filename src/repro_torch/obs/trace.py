"""Structured span recorder with Chrome trace-event / Perfetto JSON export
(a copy of the JAX package's ``obs/trace.py``, which imports no JAX).

``Tracer`` records three event shapes onto named (pid, tid) tracks:

* ``span(name, **attrs)`` -- a context manager emitting a balanced B/E
  duration pair, timestamped by the tracer's injectable clock (the serving
  engine's wall/fake clock);
* ``instant(name, ts=..., **attrs)`` -- a point event (request admitted,
  shipment queued);
* ``complete(name, ts, dur, **attrs)`` -- an explicitly-timed X event for
  recorders that own time themselves: the disagg orchestrator stamps spans
  with its **virtual** per-worker clocks, so two runs of the same trace on a
  ``FakeClock`` export byte-identical JSON (deterministic, diffable).

``export()`` writes the Chrome trace-event format (`chrome://tracing`,
https://ui.perfetto.dev): a ``traceEvents`` list of
``{name, ph, ts(us), pid, tid, args}`` dicts, sorted per track, with
process/thread metadata events naming the tracks.  ``tools/check_trace.py``
validates the structural invariants (per-track ts monotonicity, balanced
B/E nesting, non-negative X durations).

The default recorder is ``NULL_TRACER``, a no-op singleton: ``span()``
returns one cached null context manager, so the disabled path allocates no
event records and no per-step objects -- serving with tracing off is the
untraced hot path, not a cheaper trace.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

__all__ = ["Tracer", "NullTracer", "NULL_TRACER"]


class _Span:
    """One live B/E pair; created per ``span()`` call on an enabled tracer."""

    __slots__ = ("_tracer", "name", "pid", "tid", "attrs")

    def __init__(self, tracer: "Tracer", name: str, pid: int, tid: int,
                 attrs: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.pid = pid
        self.tid = tid
        self.attrs = attrs

    def __enter__(self) -> "_Span":
        self._tracer._record("B", self.name, self._tracer._now(),
                             self.pid, self.tid, self.attrs)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._tracer._record("E", self.name, self._tracer._now(),
                             self.pid, self.tid, None)


class _NullSpan:
    """The reusable no-op context manager ``NULL_TRACER.span`` returns."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


_NULL_SPAN = _NullSpan()


class Tracer:
    """Span/event recorder onto (pid, tid) tracks with one injectable clock.

    ``clock`` is a zero-arg callable returning seconds (or an
    ``obs.Clock``-like object with ``.now()``); default
    ``time.perf_counter``.  Timestamps are recorded in seconds and exported
    in microseconds (the Chrome trace unit).  ``pid``/``tid`` default the
    track for events that do not name one; ``set_track`` registers
    human-readable process/thread names Perfetto shows instead of bare ids.
    """

    enabled = True

    def __init__(self, clock: Union[None, Callable[[], float], Any] = None,
                 pid: int = 0, tid: int = 0):
        if clock is None:
            self.clock: Callable[[], float] = time.perf_counter
        elif hasattr(clock, "now"):
            self.clock = clock.now
        else:
            self.clock = clock
        self.pid = pid
        self.tid = tid
        # (ph, name, ts_seconds, pid, tid, attrs-or-None), insertion order --
        # per-track order is chronological because each track's recorder is
        # single-threaded (the serve loop / the orchestrator's event loop)
        self.events: List[Tuple[str, str, float, int, int, Optional[Dict]]] = []
        self._tracks: Dict[Tuple[int, int], Tuple[Optional[str], Optional[str]]] = {}

    # -- recording -----------------------------------------------------------
    def _now(self) -> float:
        return self.clock()

    def _record(self, ph: str, name: str, ts: float, pid: Optional[int],
                tid: Optional[int], attrs: Optional[Dict]) -> None:
        self.events.append((ph, name, ts,
                            self.pid if pid is None else pid,
                            self.tid if tid is None else tid, attrs))

    def set_track(self, pid: int, tid: int, process: Optional[str] = None,
                  thread: Optional[str] = None) -> None:
        """Name a (pid, tid) track (emitted as M metadata events)."""
        old = self._tracks.get((pid, tid), (None, None))
        self._tracks[(pid, tid)] = (process or old[0], thread or old[1])

    def span(self, name: str, *, pid: Optional[int] = None,
             tid: Optional[int] = None, **attrs) -> _Span:
        """Context manager recording a B/E pair around its body."""
        return _Span(self, name,
                     self.pid if pid is None else pid,
                     self.tid if tid is None else tid, attrs)

    def instant(self, name: str, *, ts: Optional[float] = None,
                pid: Optional[int] = None, tid: Optional[int] = None,
                **attrs) -> None:
        """Point event at ``ts`` (default: the clock's now)."""
        self._record("i", name, self._now() if ts is None else ts,
                     pid, tid, attrs)

    def complete(self, name: str, ts: float, dur: float, *,
                 pid: Optional[int] = None, tid: Optional[int] = None,
                 **attrs) -> None:
        """Explicitly-timed X event: ``[ts, ts + dur]`` on a virtual or
        measured timeline the caller owns."""
        if dur < 0:
            raise ValueError(f"span {name!r}: negative duration {dur}")
        attrs = dict(attrs)
        attrs["_dur"] = dur
        self._record("X", name, ts, pid, tid, attrs)

    # -- export --------------------------------------------------------------
    @staticmethod
    def _us(seconds: float) -> float:
        # integer microseconds when exact keeps golden files stable
        us = seconds * 1e6
        rounded = round(us, 3)
        return int(rounded) if rounded == int(rounded) else rounded

    def to_json(self) -> Dict[str, Any]:
        """The Chrome trace-event dict (``traceEvents`` + display unit)."""
        out: List[Dict[str, Any]] = []
        for (pid, tid), (process, thread) in sorted(self._tracks.items()):
            if process is not None:
                out.append({"name": "process_name", "ph": "M", "ts": 0,
                            "pid": pid, "tid": tid, "args": {"name": process}})
            if thread is not None:
                out.append({"name": "thread_name", "ph": "M", "ts": 0,
                            "pid": pid, "tid": tid, "args": {"name": thread}})
        # stable sort by track only: insertion order within a track is
        # chronological (single-threaded recorders), and preserving it keeps
        # B/E nesting valid when timestamps tie
        for ph, name, ts, pid, tid, attrs in sorted(
                self.events, key=lambda e: (e[3], e[4])):
            ev: Dict[str, Any] = {"name": name, "ph": ph, "ts": self._us(ts),
                                  "pid": pid, "tid": tid}
            if ph == "X":
                attrs = dict(attrs)
                ev["dur"] = self._us(attrs.pop("_dur"))
            if ph == "i":
                ev["s"] = "t"  # thread-scoped instant
            if attrs:
                ev["args"] = attrs
            out.append(ev)
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path: str) -> None:
        """Write the trace JSON (open in https://ui.perfetto.dev)."""
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)
            f.write("\n")


class NullTracer(Tracer):
    """The zero-overhead disabled recorder: every call is a no-op and
    ``span()`` hands back one cached context manager, so a serve loop running
    against it performs no per-step allocation and accumulates nothing."""

    enabled = False

    def __init__(self):
        super().__init__(clock=lambda: 0.0)

    def span(self, name: str, **kw) -> _NullSpan:  # type: ignore[override]
        return _NULL_SPAN

    def instant(self, name: str, **kw) -> None:
        pass

    def complete(self, name: str, ts: float, dur: float, **kw) -> None:
        pass

    def set_track(self, pid: int, tid: int, process: Optional[str] = None,
                  thread: Optional[str] = None) -> None:
        pass


NULL_TRACER = NullTracer()
