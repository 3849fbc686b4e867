"""Step metrics registry: counters, gauges, wall-time spans and structured
events, fanned out to pluggable sinks.

Port of the subset of ``pcg_mpi_solver_tpu/obs/metrics.py``
(``MetricsRecorder``, :114-312) that the chunked solve path and its
recovery ladder call: ``inc``, ``gauge``, ``event``, ``note``, ``span``,
``dispatch`` and ``dispatch_stats``.  An event is a dict with
``"schema"``, ``"t"`` and ``"kind"`` plus its fields, handed to every
sink's ``emit``; a recorder without sinks is a cheap null object whose
counters and spans still accumulate.  The JSONL and stderr sinks, the
profiler annotations and the flight recorder are ROADMAP queue 1 item 14.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List

# the JAX package's telemetry schema tag (obs/schema.py), so one consumer
# reads both packages' events
TELEMETRY_SCHEMA = "pcg-tpu-telemetry/1"


class MetricsRecorder:
    """Counters + gauges + monotonic wall-time spans + structured events.

    ``dispatch`` spans time a host-driven piece of the chunked solve
    (one capped ``pcg`` call, a refinement refresh, a restart): the
    pieces end in a host read, so the span times the device work, and
    the first call of each name is booked apart (``cold_s``: on the card
    it carries the kernels' first launches)."""

    def __init__(self, sinks=(), clock=time.monotonic):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Any] = {}
        self.sinks: List[Any] = list(sinks)
        self._clock = clock
        self._spans: Dict[str, List[float]] = {}    # name -> [count, total_s]
        # name -> [calls, cold_s, warm_s]
        self._dispatch: Dict[str, List[float]] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, delta: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self.gauges[name] = value

    def event(self, kind: str, **fields) -> Dict[str, Any]:
        ev = {"schema": TELEMETRY_SCHEMA, "t": time.time(), "kind": kind}
        ev.update(fields)
        with self._lock:
            for s in self.sinks:
                s.emit(ev)
        return ev

    def note(self, msg: str) -> None:
        self.event("note", msg=msg)

    @contextmanager
    def span(self, name: str, emit: bool = False):
        """Accumulate monotonic wall time under ``name``; ``emit=True``
        also emits a ``bench_phase`` event on exit."""
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            with self._lock:
                st = self._spans.setdefault(name, [0, 0.0])
                st[0] += 1
                st[1] += dt
            if emit:
                self.event("bench_phase", name=name, wall_s=round(dt, 6))

    @contextmanager
    def dispatch(self, name: str, emit: bool = True):
        """Wrap one host-driven dispatch: cold/warm attribution, the
        ``dispatch.<name>.calls`` counter and a ``dispatch`` event."""
        with self._lock:
            st = self._dispatch.setdefault(name, [0, 0.0, 0.0])
            cold = st[0] == 0
            st[0] += 1
        t0 = self._clock()
        try:
            yield
        finally:
            dt = self._clock() - t0
            with self._lock:
                self._dispatch[name][1 if cold else 2] += dt
            self.inc(f"dispatch.{name}.calls")
            if emit:
                self.event("dispatch", name=name, wall_s=round(dt, 6),
                           cold=cold)

    def dispatch_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-dispatch-name calls and seconds: ``cold_s`` the first
        call, ``warm_s`` the rest."""
        with self._lock:
            return {k: {"calls": int(v[0]), "cold_s": v[1], "warm_s": v[2]}
                    for k, v in self._dispatch.items()}
