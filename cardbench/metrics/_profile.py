"""A torch.profiler Chrome trace read as device work by phase.

The arithmetic of the port's ``obs/profview.py``, copied so that a later
change to the program cannot move it: a device op belongs to the
``pcg/<phase>`` ``record_function`` range that encloses its launch on the
host (the kernel's ``correlation`` id names the ``cuda_runtime`` launch
event); an op whose launch the trace lacks falls back to the range on its
own device lane.  The solver enters those ranges (``solver/pcg.py``) only
while a capture is on.  Busy time is the union of the device ops'
intervals; an idle gap is a stretch of the profiled window that no device
op covers, named by the innermost host range open when it began.
"""

from __future__ import annotations

import bisect
import json
import re
from typing import Dict, List, Optional, Tuple

#: range label -> phase
PHASE_SCOPES = {
    "pcg/matvec": "matvec",
    "pcg/precond": "precond",
    "pcg/reduce": "reduction",
    "pcg/axpy": "axpy",
}

#: Chrome-trace categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

_SCOPE_RE = re.compile(r"(pcg|cardbench)/([A-Za-z0-9_]+)")


def merge_intervals(spans):
    """Sorted union of half-open [s, e) intervals (empty ones dropped)."""
    out: List[Tuple[float, float]] = []
    for s, e in sorted((s, e) for s, e in spans if e > s):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _span(e: dict) -> Optional[Tuple[float, float]]:
    try:
        ts = float(e.get("ts", 0.0))
        return ts, ts + float(e.get("dur", 0.0))
    except (TypeError, ValueError):
        return None


class Ranges:
    """The ranges of one lane and one prefix, which never nest among
    themselves: the one open at a time, by bisection."""

    def __init__(self):
        self.spans: List[Tuple[float, float, str]] = []

    def add(self, s: float, e: float, label: str) -> None:
        self.spans.append((s, e, label))

    def freeze(self) -> "Ranges":
        self.spans.sort()
        self.starts = [s for s, _e, _l in self.spans]
        return self

    def at(self, t: float) -> Optional[str]:
        k = bisect.bisect_right(self.starts, t) - 1
        if k >= 0 and t <= self.spans[k][1]:
            return self.spans[k][2]
        return None


def lanes(events: List[dict], cat: str,
          prefix: str = "pcg") -> Dict[tuple, Ranges]:
    """The ``<prefix>/*`` ranges of category ``cat`` by (pid, tid)."""
    out: Dict[tuple, Ranges] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != cat:
            continue
        m = _SCOPE_RE.search(str(e.get("name", "")))
        sp = _span(e)
        if m is None or m.group(1) != prefix or sp is None:
            continue
        out.setdefault((e.get("pid"), e.get("tid")), Ranges()).add(
            sp[0], sp[1], m.group(0))
    for r in out.values():
        r.freeze()
    return out


def device_ops(events: List[dict]) -> List[dict]:
    """Device ops ``{"name", "cat", "ts", "dur", "label"}`` of a trace:
    kernels, copies and sets on the card, each with the range around its
    launch (or around it on its device lane), else label None."""
    host = lanes(events, "user_annotation")
    gpu = lanes(events, "gpu_user_annotation")
    launches = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = e
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        sp = _span(e)
        if sp is None:
            continue
        label = None
        launch = launches.get((e.get("args") or {}).get("correlation"))
        if launch is not None:
            lane = host.get((launch.get("pid"), launch.get("tid")))
            ls = _span(launch)
            label = lane.at(ls[0]) if lane and ls else None
        if label is None:
            lane = gpu.get((e.get("pid"), e.get("tid")))
            label = lane.at(sp[0]) if lane else None
        out.append({"name": str(e.get("name", "")), "cat": e.get("cat"),
                    "ts": sp[0], "dur": sp[1] - sp[0], "label": label})
    return out


def range_counts(events: List[dict]) -> Dict[str, int]:
    """How many host ranges of each ``pcg/*`` or ``cardbench/*`` name."""
    out: Dict[str, int] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            m = _SCOPE_RE.search(str(e.get("name", "")))
            if m:
                out[m.group(0)] = out.get(m.group(0), 0) + 1
    return out


def host_window(events: List[dict], name: str):
    """(start, end) in trace microseconds of the first host range
    ``name``, or None."""
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") == name):
            return _span(e)
    return None


def phase_us(ops: List[dict]) -> Dict[str, float]:
    """Device microseconds by phase; ops outside every phase under
    ``other``."""
    out = {ph: 0.0 for ph in PHASE_SCOPES.values()}
    out["other"] = 0.0
    for op in ops:
        out[PHASE_SCOPES.get(op["label"], "other")] += op["dur"]
    return out


def busy_us(ops: List[dict], window=None) -> float:
    """The union of the device ops' intervals, clipped to ``window``."""
    spans = [(op["ts"], op["ts"] + op["dur"]) for op in ops]
    if window is not None:
        spans = [(max(s, window[0]), min(e, window[1])) for s, e in spans]
    return sum(e - s for s, e in merge_intervals(spans))


def idle_gaps(ops: List[dict], window, inner: Optional[Ranges],
              outer: Optional[Ranges]) -> Dict[str, float]:
    """Microseconds of the window that no device op covers, summed by the
    host range open when each gap began: a ``pcg/*`` range of ``inner``,
    else a harness range of ``outer``, else ``host``."""
    merged = merge_intervals(
        [(max(op["ts"], window[0]), min(op["ts"] + op["dur"], window[1]))
         for op in ops])
    out: Dict[str, float] = {}
    t = window[0]
    for s, e in merged + [(window[1], window[1])]:
        if s > t:
            name = ((inner.at(t) if inner else None)
                    or (outer.at(t) if outer else None) or "host")
            out[name] = out.get(name, 0.0) + (s - t)
        t = max(t, e)
    return out


def top(pairs: Dict[str, float], n: int = 10) -> List[list]:
    """The n largest entries as [name, value] lists, largest first."""
    return [[k, v] for k, v in sorted(pairs.items(),
                                      key=lambda kv: -kv[1])[:n]]


def read_trace(path: str) -> List[dict]:
    """The traceEvents of an exported Chrome trace."""
    with open(path, encoding="utf-8", errors="replace") as f:
        doc = json.load(f)
    evs = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(evs, list):
        raise ValueError(f"no traceEvents array in {path}")
    return evs


def summarize(events: List[dict], window_range: str) -> Optional[dict]:
    """What the readers take from one profiled call: the device ops inside
    the host range ``window_range`` (the harness's span around the call),
    their time by phase and by name, kernel count, busy time, idle gaps by
    host range, and the host range counts.  None when the trace holds no
    such range or no device op."""
    win = host_window(events, window_range)
    if win is None:
        return None
    ops = [op for op in device_ops(events)
           if op["ts"] < win[1] and op["ts"] + op["dur"] > win[0]]
    if not ops:
        return None
    outer = lanes(events, "user_annotation", "cardbench")
    lane = next((k for k, r in outer.items()
                 if any(label == window_range for _s, _e, label in r.spans)),
                None)
    inner = lanes(events, "user_annotation").get(lane)
    by_name: Dict[str, float] = {}
    for op in ops:
        by_name[op["name"]] = by_name.get(op["name"], 0.0) + op["dur"]
    return {
        "window_us": win[1] - win[0],
        "busy_us": busy_us(ops, win),
        "phase_us": phase_us(ops),
        "kernels": sum(1 for op in ops if op["cat"] == "kernel"),
        "by_name_us": by_name,
        "gaps_us": idle_gaps(ops, win, inner, outer.get(lane)),
        "ranges": range_counts(events),
    }
