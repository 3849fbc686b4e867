"""Step metrics registry: counters, gauges, wall-time spans and structured
events, fanned out to pluggable sinks (stderr, JSONL and, on request, a
``torch.profiler.record_function`` range around each dispatch).

Port of ``pcg_mpi_solver_tpu/obs/metrics.py``.  An event is a dict with
``"schema"``, ``"t"`` and ``"kind"`` plus its fields (``obs/schema.py``),
handed to every sink's ``emit``; a recorder without sinks is a cheap null
object whose counters and spans still accumulate for the summary table.
``PCG_TPU_VERBOSE=1`` turns on the stderr breadcrumbs of the default
recorder, read at every event.

Host-side only: nothing here touches a tensor, so telemetry adds no
device-to-host read to a solve (the residual ring of ``obs/trace.py``
crosses to the host once a solve).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from pcg_mpi_solver_tpu_torch.obs.schema import TELEMETRY_SCHEMA


def _jsonable(v):
    """numpy scalars and arrays (anything with .tolist()/.item()) as
    builtins; anything else as its string."""
    if hasattr(v, "tolist"):
        return v.tolist()
    if hasattr(v, "item"):
        return v.item()
    return str(v)


class StderrSink:
    """Human breadcrumbs on stderr, each behind a ``[pcg-tpu HH:MM:SS]``
    prefix; a note prints its message as it is."""

    def __init__(self, stream=None):
        self._stream = stream

    def emit(self, ev: Dict[str, Any]) -> None:
        stream = self._stream if self._stream is not None else sys.stderr
        kind = ev.get("kind", "?")
        if kind == "note":
            body = str(ev.get("msg", ""))
        else:
            parts = []
            for k, v in ev.items():
                if k in ("schema", "t", "kind"):
                    continue
                if isinstance(v, (list, dict)):
                    v = f"<{len(v)} entries>"
                elif isinstance(v, float):
                    v = f"{v:.6g}"
                parts.append(f"{k}={v}")
            body = f"{kind}: " + " ".join(parts)
        print(f"[pcg-tpu {time.strftime('%H:%M:%S')}] {body}",
              file=stream, flush=True)

    def close(self) -> None:
        pass


class EnvGatedStderrSink(StderrSink):
    """A :class:`StderrSink` active only while ``PCG_TPU_VERBOSE=1``, read
    at every event, so a long-lived process can turn the breadcrumbs on
    after the solver was built."""

    def emit(self, ev: Dict[str, Any]) -> None:
        if os.environ.get("PCG_TPU_VERBOSE") == "1":
            super().emit(ev)


class JsonlSink:
    """Schema-versioned JSONL event stream: one JSON object a line,
    flushed at every event so a killed run still leaves a parseable
    file."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def emit(self, ev: Dict[str, Any]) -> None:
        self._f.write(json.dumps(ev, default=_jsonable) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class MetricsRecorder:
    """Counters + gauges + monotonic wall-time spans + structured events.

    ``dispatch`` spans time a host-driven piece of a solve (a step, one
    capped ``pcg`` call, a refinement refresh, a restart, a chunk of
    explicit steps): each piece ends in a host read, so the span times
    the device work, and the first call of each name is booked apart
    (``cold_s``: on the card it carries the kernels' first launches).
    With ``flight`` set (``obs/flight.attach_flight``) every dispatch is
    bracketed by durable begin/end records; with ``profile_spans`` each
    one is a ``torch.profiler.record_function`` range named
    ``pcg-tpu/<name>``.  All mutation takes a lock: a solve may run in a
    thread while another reads the registry."""

    def __init__(self, sinks=(), profile_spans: bool = False,
                 clock=time.monotonic):
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, Any] = {}
        self.sinks: List[Any] = list(sinks)
        self.flight = None
        self.profile_spans = bool(profile_spans)
        self._clock = clock
        self._spans: Dict[str, List[float]] = {}    # name -> [count, total_s]
        # name -> [calls, cold_s, warm_s]
        self._dispatch: Dict[str, List[float]] = {}
        self.step_events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    @classmethod
    def default(cls, jsonl_path: Optional[str] = None,
                profile: Optional[bool] = None) -> "MetricsRecorder":
        """The solvers' recorder: stderr breadcrumbs behind
        ``PCG_TPU_VERBOSE=1``, a JSONL sink when a path is given, profiler
        ranges when asked for (or under ``PCG_TPU_PROFILE_SPANS=1``)."""
        sinks: List[Any] = [EnvGatedStderrSink()]
        if jsonl_path:
            sinks.append(JsonlSink(jsonl_path))
        if profile is None:
            profile = os.environ.get("PCG_TPU_PROFILE_SPANS") == "1"
        return cls(sinks=sinks, profile_spans=bool(profile))

    def add_sink(self, sink) -> None:
        with self._lock:
            self.sinks.append(sink)

    def remove_sink(self, sink) -> None:
        """Detach a sink added with :meth:`add_sink`; idempotent."""
        with self._lock:
            if sink in self.sinks:
                self.sinks.remove(sink)

    def close(self) -> None:
        """Close the flight recorder and every sink."""
        if self.flight is not None:
            self.flight.close()
        for s in self.sinks:
            s.close()

    # -- registry -------------------------------------------------------
    def inc(self, name: str, delta: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + delta

    def gauge(self, name: str, value) -> None:
        with self._lock:
            self.gauges[name] = value

    # -- events ---------------------------------------------------------
    def event(self, kind: str, **fields) -> Dict[str, Any]:
        ev = {"schema": TELEMETRY_SCHEMA, "t": time.time(), "kind": kind}
        ev.update(fields)
        # the sinks emit under the lock: two emitting threads must not
        # interleave within a line of a shared stream
        with self._lock:
            if kind == "step":
                self.step_events.append(ev)
            for s in self.sinks:
                s.emit(ev)
        return ev

    def note(self, msg: str) -> None:
        self.event("note", msg=msg)

    # -- timing ---------------------------------------------------------
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
        ``dispatch.<name>.calls`` counter, a ``dispatch`` event, the
        flight bracket (its begin record is durable before the dispatch
        runs) and, with ``profile_spans``, a profiler range.  The caller
        keeps the dispatch's host read inside the span."""
        with self._lock:
            st = self._dispatch.setdefault(name, [0, 0.0, 0.0])
            cold = st[0] == 0
            st[0] += 1
        if self.profile_spans:
            from torch.profiler import record_function

            rng = record_function(f"pcg-tpu/{name}")
        else:
            rng = contextlib.nullcontext()
        flight = self.flight
        seq = (flight.begin(f"dispatch:{name}", cold=cold)
               if flight is not None else None)
        t0 = self._clock()
        err = None
        try:
            with rng:
                yield
        except BaseException as e:
            err = f"{type(e).__name__}: {e}"
            raise
        finally:
            dt = self._clock() - t0
            with self._lock:
                self._dispatch[name][1 if cold else 2] += dt
            self.inc(f"dispatch.{name}.calls")
            if flight is not None:
                flight.end(seq, f"dispatch:{name}", ok=err is None,
                           wall_s=round(dt, 6),
                           **({"error": err} if err else {}))
            if emit:
                self.event("dispatch", name=name, wall_s=round(dt, 6),
                           cold=cold)

    # -- snapshots ------------------------------------------------------
    def dispatch_stats(self) -> Dict[str, Dict[str, float]]:
        """Per-dispatch-name calls and seconds: ``cold_s`` the first
        call, ``warm_s`` the rest."""
        with self._lock:
            return {k: {"calls": int(v[0]), "cold_s": v[1], "warm_s": v[2]}
                    for k, v in self._dispatch.items()}

    def span_stats(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {k: {"calls": int(v[0]), "total_s": v[1]}
                    for k, v in self._spans.items()}

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            counters = dict(self.counters)
            gauges = dict(self.gauges)
        return {"counters": counters, "gauges": gauges,
                "spans": self.span_stats(),
                "dispatches": self.dispatch_stats()}

    def emit_run_summary(self) -> Dict[str, Any]:
        """The end-of-run ``run_summary`` event: counters, gauges, spans
        and dispatch attribution."""
        return self.event("run_summary", **self.snapshot())

    def summary(self) -> str:
        """Human-readable end-of-run table (the CLI's ``--summary``)."""
        lines = []
        if self.step_events:
            lines.append(_step_header())
            lines.extend(_step_row(ev) for ev in self.step_events)
        ds = self.dispatch_stats()
        if ds:
            lines.append("")
            lines.extend(_dispatch_table(
                {k: (d["calls"], d["cold_s"], d["warm_s"])
                 for k, d in ds.items()}))
        with self._lock:
            gauges = dict(self.gauges)
            counters = dict(self.counters)
        extra = {k: v for k, v in counters.items()
                 if not k.startswith("dispatch.")}
        if gauges:
            lines.append("")
            lines.extend(f"gauge {k} = {gauges[k]}" for k in sorted(gauges))
        if extra:
            lines.extend(f"counter {k} = {extra[k]}" for k in sorted(extra))
        return "\n".join(lines) if lines else "(no telemetry recorded)"


def _step_header() -> str:
    return (f"{'step':>5} {'flag':>4} {'iters':>7} {'relres':>10} "
            f"{'wall_s':>9}")


def _step_row(ev: Dict[str, Any]) -> str:
    try:
        relres = float(ev.get("relres", float("nan")))
        wall = float(ev.get("wall_s", float("nan")))
    except (TypeError, ValueError):
        relres = wall = float("nan")
    return (f"{ev.get('step', '?'):>5} {ev.get('flag', '?'):>4} "
            f"{ev.get('iters', '?'):>7} {relres:>10.3e} {wall:>9.3f}")


def _dispatch_table(rows: Dict[str, tuple]) -> List[str]:
    out = [f"{'dispatch':<24} {'calls':>6} {'cold_s':>9} {'warm_s':>9}"]
    for name in sorted(rows):
        calls, cold, warm = rows[name]
        out.append(f"{name:<24} {int(calls):>6} {cold:>9.3f} {warm:>9.3f}")
    return out


def summarize_jsonl(path: str) -> str:
    """Offline summary of an on-disk telemetry or flight JSONL file,
    tolerant of a truncated last line (skipped and counted,
    ``obs/flight.read_jsonl_tolerant``): event counts by kind, the step
    table, dispatch cold/warm seconds, profile artifacts, the last
    ``run_summary``'s gauges and, when flight records are present, the
    verdict (clean / failed / died, with the open brackets and the last
    heartbeat)."""
    from pcg_mpi_solver_tpu_torch.obs.flight import (
        flight_verdict_path, read_jsonl_tolerant)

    events, truncated = read_jsonl_tolerant(path)
    lines = [f"{path}: {len(events)} event(s), "
             f"truncated_lines = {truncated}"]
    kinds: Dict[str, int] = {}
    for ev in events:
        k = str(ev.get("kind", "?"))
        kinds[k] = kinds.get(k, 0) + 1
    if kinds:
        lines.append("  " + "  ".join(f"{k}={kinds[k]}"
                                      for k in sorted(kinds)))
    steps = [ev for ev in events if ev.get("kind") == "step"]
    if steps:
        lines.append("")
        lines.append(_step_header())
        lines.extend(_step_row(ev) for ev in steps)
    disp: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("kind") != "dispatch":
            continue
        st = disp.setdefault(str(ev.get("name", "?")), [0, 0.0, 0.0])
        st[0] += 1
        try:
            w = float(ev.get("wall_s", 0.0) or 0.0)
        except (TypeError, ValueError):
            w = 0.0
        st[1 if ev.get("cold") else 2] += w
    if disp:
        lines.append("")
        lines.extend(_dispatch_table({k: tuple(v) for k, v in disp.items()}))
    caps = [ev for ev in events if ev.get("kind") == "profile_capture"]
    if caps:
        lines.append("")
        lines.extend(f"profile artifact: {ev.get('path')} (read it back "
                     f"with `pcg-tpu prof-report`)" for ev in caps)
    summaries = [ev for ev in events if ev.get("kind") == "run_summary"]
    if summaries:
        gauges = summaries[-1].get("gauges") or {}
        if isinstance(gauges, dict) and gauges:
            lines.append("")
            lines.extend(f"gauge {k} = {gauges[k]}" for k in sorted(gauges))
    if any(ev.get("kind") == "flight" for ev in events):
        v = flight_verdict_path(path)
        lines.append("")
        lines.append(f"flight verdict: {v['verdict']} "
                     f"({v['records']} record(s))")
        if v["in_flight"]:
            lines.append("  in flight at death: " + ", ".join(v["in_flight"]))
        lines.extend(f"  fail: {msg}" for msg in v["fails"])
        lines.extend(f"  expected descent: {msg}"
                     for msg in v.get("expected_fails", []))
        if v["last_wall"] is not None:
            lines.append(f"  last record at t={v['last_wall']:.3f} "
                         f"(mono {v['last_mono']})"
                         + (" [salvaged from the truncated final line]"
                            if v.get("salvaged_tail") else ""))
    if truncated:
        lines.append(f"({truncated} truncated line(s) skipped — the "
                     "partial write of a killed process)")
    return "\n".join(lines)
