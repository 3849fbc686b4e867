"""Profiler-trace consumer: a ``torch.profiler`` Chrome trace read back as
per-phase device time.

Port of ``pcg_mpi_solver_tpu/obs/profview.py``.  The JAX package finds a
device op's phase through the HLO metadata of its ``jax.named_scope``;
here a phase is the ``pcg/<phase>`` ``record_function`` range that
``solver/pcg.py`` enters around a trip's pieces while a capture is on
(``PHASE_SCOPES``), and a device op belongs to the range that encloses
its LAUNCH: the kernel's ``correlation`` id names the ``cuda_runtime``
launch event on the host thread, and the innermost ``user_annotation``
range around that event's start is the phase.  A kernel whose launch
event the trace lacks falls back to the ``gpu_user_annotation`` range
that encloses it on its own device lane.  The port's kernels launched
through ``ctypes`` are ordinary ``cudaLaunchKernel`` calls to CUPTI, so
they are attributed the same way.  A capture without device events (on
the CPU) attributes the outermost ``cpu_op`` events instead: on the CPU
they are the device work.

* :func:`capture_solve_profile` — one unprofiled warm dispatch, then one
  profiled, exported as a gzipped Chrome trace with a
  ``profview_meta.json`` sidecar (shape, iterations, the wall anchor),
  so the artifact reads back offline.
* a tolerant reader: a missing, truncated or unreadable file, or a trace
  with no device events, gives a NAMED ``degraded: <reason>`` verdict,
  never a crash.
* :func:`bucket_phases` — device time per phase; time no phase encloses
  is counted under ``other`` and a ``pcg/<x>`` range outside the four is
  counted under ``unknown_scopes``: nothing is dropped.  The report adds
  the busy time (the union of the device intervals) and its share of the
  capture's wall.
"""

from __future__ import annotations

import bisect
import gzip
import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

#: range label -> attribution phase (the obs/perf.PHASES rows)
PHASE_SCOPES: Dict[str, str] = {
    "pcg/matvec": "matvec",
    "pcg/precond": "precond",
    "pcg/reduce": "reduction",
    "pcg/axpy": "axpy",
}

#: substrings naming a collective device op (NCCL's kernels; the JAX
#: package's XLA names)
COLLECTIVE_MARKERS = ("nccl", "all-reduce", "all-gather", "reduce-scatter",
                      "collective-permute", "all-to-all")

#: Chrome-trace categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: sidecar filename written next to the trace by capture_solve_profile.
PROFVIEW_META = "profview_meta.json"
PROFVIEW_META_SCHEMA = "pcg-tpu-profview-meta/1"
TRACE_FILE = "pcg.trace.json.gz"

_SCOPE_RE = re.compile(r"pcg/([A-Za-z0-9_]+)")


# ----------------------------------------------------------------------
# interval math
# ----------------------------------------------------------------------

def merge_intervals(spans: List[Tuple[float, float]]
                    ) -> List[Tuple[float, float]]:
    """Sorted union of half-open [s, e) intervals (degenerate/negative
    spans dropped)."""
    spans = sorted((s, e) for s, e in spans if e > s)
    out: List[Tuple[float, float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def intersect_len(span: Tuple[float, float],
                  merged: List[Tuple[float, float]]) -> float:
    """Length of ``span``'s intersection with a merged interval union."""
    s, e = span
    total = 0.0
    for ms, me in merged:
        if me <= s:
            continue
        if ms >= e:
            break
        total += min(e, me) - max(s, ms)
    return total


# ----------------------------------------------------------------------
# tolerant trace reading
# ----------------------------------------------------------------------

def find_trace_files(path: str) -> List[str]:
    """Every ``*.trace.json(.gz)`` under ``path`` (a file, a capture's
    run dir, or a capture root holding run dirs), newest first."""
    if os.path.isfile(path):
        return [path]
    if not os.path.isdir(path):
        return []
    hits: List[str] = []
    for root, _dirs, files in os.walk(path):
        for fn in files:
            if fn.endswith((".trace.json", ".trace.json.gz")):
                hits.append(os.path.join(root, fn))
    hits.sort(key=lambda p: os.path.getmtime(p), reverse=True)
    return hits


def read_trace_events(path: str) -> Tuple[List[dict], List[str]]:
    """(traceEvents, problems) of one Chrome-trace JSON(.gz) file.  A
    truncated or unreadable file returns ([], [named reason])."""
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8",
                           errors="replace") as f:
                text = f.read()
        else:
            with open(path, encoding="utf-8", errors="replace") as f:
                text = f.read()
    except (OSError, EOFError) as e:
        return [], [f"unreadable trace file ({type(e).__name__}: {e})"]
    try:
        doc = json.loads(text)
    except ValueError as e:
        return [], [f"truncated/invalid trace JSON ({e})"]
    evs = doc.get("traceEvents") if isinstance(doc, dict) else None
    if not isinstance(evs, list):
        return [], ["no traceEvents array in trace JSON"]
    return evs, []


def _span(e: dict) -> Optional[Tuple[float, float]]:
    try:
        ts = float(e.get("ts", 0.0))
        return ts, ts + float(e.get("dur", 0.0))
    except (TypeError, ValueError):
        return None


class _Ranges:
    """The ``pcg/*`` ranges of one lane (a (pid, tid) pair), which never
    nest among themselves: the one enclosing a time, by bisection."""

    def __init__(self):
        self.spans: List[Tuple[float, float, str]] = []

    def add(self, s: float, e: float, label: str) -> None:
        self.spans.append((s, e, label))

    def freeze(self) -> None:
        self.spans.sort()
        self.starts = [s for s, _e, _l in self.spans]

    def at(self, t: float) -> Optional[str]:
        k = bisect.bisect_right(self.starts, t) - 1
        if k >= 0 and t <= self.spans[k][1]:
            return self.spans[k][2]
        return None


def _lanes(events: List[dict], cat: str) -> Dict[tuple, _Ranges]:
    lanes: Dict[tuple, _Ranges] = {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") != cat:
            continue
        m = _SCOPE_RE.search(str(e.get("name", "")))
        sp = _span(e)
        if m is None or sp is None:
            continue
        lanes.setdefault((e.get("pid"), e.get("tid")), _Ranges()).add(
            sp[0], sp[1], m.group(0))
    for r in lanes.values():
        r.freeze()
    return lanes


def device_ops(events: List[dict]) -> List[dict]:
    """Normalized device-op records ``{"name", "ts", "dur", "pid", "tid",
    "label", "via"}`` of a torch.profiler Chrome trace: its kernels,
    copies and sets on the card, each with the ``pcg/*`` range that
    encloses its launch (``via`` "launch") or, lacking the launch event,
    the device-lane range around it (``via`` "device"), else none; on a
    trace with no device events, its outermost host ops (``via``
    "host")."""
    host = _lanes(events, "user_annotation")
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    out = []
    if dev:
        launches = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in ("cuda_runtime",
                                                       "cuda_driver"):
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launches[corr] = e
        gpu = _lanes(events, "gpu_user_annotation")
        for e in dev:
            sp = _span(e)
            if sp is None:
                continue
            label, via = None, None
            launch = launches.get((e.get("args") or {}).get("correlation"))
            if launch is not None:
                lane = host.get((launch.get("pid"), launch.get("tid")))
                ls = _span(launch)
                label = lane.at(ls[0]) if lane and ls else None
                via = "launch"
            if label is None:
                lane = gpu.get((e.get("pid"), e.get("tid")))
                label = lane.at(sp[0]) if lane else None
                via = "device" if label is not None else via
            out.append({"name": str(e.get("name", "")), "ts": sp[0],
                        "dur": sp[1] - sp[0], "pid": e.get("pid", 0),
                        "tid": e.get("tid", 0), "label": label,
                        "via": via})
        return out
    # no device lane: the outermost cpu ops of each thread
    ops = sorted((sp[0], -sp[1], e) for e in events
                 if e.get("ph") == "X" and e.get("cat") == "cpu_op"
                 for sp in [_span(e)] if sp is not None)
    end: Dict[tuple, float] = {}
    for ts, neg_end, e in ops:
        key = (e.get("pid"), e.get("tid"))
        if ts < end.get(key, float("-inf")):
            continue                    # nested in an op already counted
        end[key] = -neg_end
        lane = host.get(key)
        out.append({"name": str(e.get("name", "")), "ts": ts,
                    "dur": -neg_end - ts, "pid": e.get("pid", 0),
                    "tid": e.get("tid", 0),
                    "label": lane.at(ts) if lane else None, "via": "host"})
    return out


def is_collective(name: str) -> bool:
    low = name.lower()
    return any(m in low for m in COLLECTIVE_MARKERS)


def phase_of(op: dict, unknown_scopes: Optional[Dict[str, int]] = None
             ) -> Optional[str]:
    """Phase of one device op from its enclosing ``pcg/<label>`` range;
    a label outside the four is COUNTED into ``unknown_scopes``.  None =
    no phase (the ``other`` bucket)."""
    label = op.get("label")
    if not label:
        return None
    phase = PHASE_SCOPES.get(label)
    if phase is None and unknown_scopes is not None:
        key = label.split("/", 1)[1]
        unknown_scopes[key] = unknown_scopes.get(key, 0) + 1
    return phase


def bucket_phases(ops: List[dict]) -> Dict[str, Any]:
    """Device time per phase.  Nothing is dropped: time no phase
    encloses lands in ``other_us``/``other_events``, ``pcg/<x>`` labels
    outside the known four are counted in ``unknown_scopes``, and
    ``busy_us`` is the union of every op's interval."""
    from pcg_mpi_solver_tpu_torch.obs.perf import PHASES

    phases = {ph: {"us": 0.0, "events": 0} for ph in PHASES}
    other_us = 0.0
    other_events = 0
    unknown_scopes: Dict[str, int] = {}
    for op in ops:
        ph = phase_of(op, unknown_scopes)
        if ph in phases:
            phases[ph]["us"] += op["dur"]
            phases[ph]["events"] += 1
        else:
            other_us += op["dur"]
            other_events += 1
    busy = sum(e - s for s, e in merge_intervals(
        [(op["ts"], op["ts"] + op["dur"]) for op in ops]))
    return {"phases": phases, "other_us": other_us,
            "other_events": other_events, "busy_us": busy,
            "unknown_scopes": unknown_scopes}


def collective_overlap(ops: List[dict]) -> Dict[str, Any]:
    """Measured collective-overlap: per device lane (trace pid), the
    wall-clock intersection of each collective op's span with the union
    of compute-op spans on OTHER threads (streams) of the same lane, as
    a fraction of total collective time.  ``overlap_frac`` is None when
    the trace carries no collectives (a one-card capture)."""
    colls = [o for o in ops if is_collective(o["name"])]
    if not colls:
        return {"n_collectives": 0, "coll_us": 0.0, "overlap_us": 0.0,
                "overlap_frac": None}
    computes = [o for o in ops if not is_collective(o["name"])]
    by_pid: Dict[Any, List[dict]] = {}
    for o in computes:
        by_pid.setdefault(o["pid"], []).append(o)
    coll_us = 0.0
    overlap_us = 0.0
    merged_cache: Dict[Tuple[Any, Any], List[Tuple[float, float]]] = {}
    for c in colls:
        span = (c["ts"], c["ts"] + c["dur"])
        coll_us += c["dur"]
        key = (c["pid"], c["tid"])
        if key not in merged_cache:
            merged_cache[key] = merge_intervals(
                [(o["ts"], o["ts"] + o["dur"])
                 for o in by_pid.get(c["pid"], ())
                 if o["tid"] != c["tid"]])
        overlap_us += intersect_len(span, merged_cache[key])
    return {"n_collectives": len(colls), "coll_us": coll_us,
            "overlap_us": overlap_us,
            "overlap_frac": (overlap_us / coll_us) if coll_us else None}


# ----------------------------------------------------------------------
# meta sidecar + capture
# ----------------------------------------------------------------------

def load_meta(trace_file: str) -> Optional[dict]:
    """The ``profview_meta.json`` sidecar next to (or up to two levels
    above) a trace file; None when absent/unreadable."""
    d = os.path.dirname(os.path.abspath(trace_file))
    for _ in range(3):
        p = os.path.join(d, PROFVIEW_META)
        if os.path.exists(p):
            try:
                with open(p, encoding="utf-8") as f:
                    return json.load(f)
            except (OSError, ValueError):
                return None
        nd = os.path.dirname(d)
        if nd == d:
            break
        d = nd
    return None


def newest_profile_artifact(root: str) -> Optional[str]:
    """The run dir of the newest trace under a capture root (or the root
    itself when it directly holds trace files)."""
    files = find_trace_files(root)
    return os.path.dirname(files[0]) if files else None


def start_capture(device):
    """Enter a ``torch.profiler`` capture of the host and, on a card,
    the device; returns the profiler for :func:`stop_capture`."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if getattr(device, "type", str(device)) == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def stop_capture(prof, out_dir: str) -> str:
    """Leave the capture (after the card's queued work: its events end
    the window) and export it as a gzipped Chrome trace into a fresh run
    dir under ``out_dir``; returns the run dir."""
    import torch

    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    run_dir = os.path.join(out_dir, time.strftime("%Y_%m_%d_%H_%M_%S")
                           + f"_{time.time_ns() % 10**9:09d}")
    os.makedirs(run_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(run_dir, TRACE_FILE))
    return run_dir


def capture_solve_profile(solver, out_dir: str, nrhs: int = 1,
                          recorder=None, fn=None) -> Dict[str, Any]:
    """Bounded one-shot profile capture around a warm solver dispatch.

    Runs one UNPROFILED dispatch first (the kernels' first launches and
    any lazy build), then a second one inside a ``torch.profiler``
    capture, exported as a gzipped Chrome trace with the
    ``profview_meta.json`` sidecar (shape, iterations, the wall anchor)
    so the artifact parses offline.

    ``fn``: optional override dispatch, returning ``(iters, wall_s)``
    (default: ``solver.step(1.0)``, or ``solver.solve_many`` of F
    repeated at ``nrhs`` > 1, the state reset after it).  Emits a
    ``profile_capture`` telemetry event with the artifact path; the
    result carries the profiler too (``"prof"``, for its
    ``key_averages``)."""
    if fn is None:
        if nrhs > 1:
            import numpy as np

            F = np.repeat(np.asarray(solver._model.F)[:, None],
                          int(nrhs), axis=1)

            def fn():
                res = solver.solve_many(F)
                return int(res.iters.max(initial=1)), \
                    float(res.solve_wall_s)
        else:
            def fn():
                r = solver.step(1.0)
                solver.reset_state()
                return int(r.iters), float(r.wall_s)

    fn()                                    # warm, outside the capture
    prof = start_capture(solver.device)
    try:
        iters, wall_s = fn()
    finally:
        run_dir = stop_capture(prof, out_dir)
    iters = max(1, int(iters))
    scfg = solver.config.solver
    dev = solver.device
    meta = {
        "schema": PROFVIEW_META_SCHEMA,
        "pcg_variant": scfg.pcg_variant,
        "precond": scfg.precond,
        "nrhs": int(nrhs),
        "backend": str(solver.backend),
        "n_dof": int(solver.pm.glob_n_dof),
        "n_parts": int(solver.pm.n_parts),
        "n_devices": 1,
        "n_devices_global": 1,
        "dtype": str(scfg.dtype),
        "mode": str(scfg.precision_mode),
        "platform": dev.type,
        "device_name": _device_name(dev),
        "iters": iters,
        "anchor_ms_per_iter": round(wall_s / iters * 1e3, 6),
        "wall_s": round(wall_s, 6),
        "captured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    meta_path = os.path.join(run_dir, PROFVIEW_META)
    try:
        with open(meta_path, "w", encoding="utf-8") as f:
            json.dump(meta, f, indent=1)
    except OSError:
        meta_path = None                    # artifact still parses degraded
    rec = recorder if recorder is not None else getattr(
        solver, "recorder", None)
    if rec is not None:
        rec.event("profile_capture", path=run_dir, source="capture",
                  iters=iters, wall_s=round(wall_s, 6))
    return {"artifact": run_dir, "meta": meta, "meta_path": meta_path,
            "iters": iters, "wall_s": wall_s, "prof": prof}


def _device_name(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    import torch

    return torch.cuda.get_device_name(dev)


# ----------------------------------------------------------------------
# the report
# ----------------------------------------------------------------------

def profile_report(path: str, meta: Optional[dict] = None,
                   iters: Optional[int] = None) -> Dict[str, Any]:
    """Parse a captured trace artifact into the ``prof_report`` payload:
    per-phase device time (ms, and ms/iter when the iteration count is
    known), the unbucketed remainder, unknown-scope counts, the busy time
    and its share of the capture's wall, and the collective-overlap
    verdict.  Degrades to a NAMED verdict on every tolerated failure
    (missing file, truncated JSON, no device events, no sidecar)."""
    problems: List[str] = []
    files = find_trace_files(path)
    events: List[dict] = []
    src = str(path)
    if not files:
        problems.append(f"no trace artifact under {path}")
    else:
        src = files[0]
        events, probs = read_trace_events(src)
        problems.extend(probs)
    if meta is None and files:
        meta = load_meta(src)
    meta = meta or {}
    if iters is None:
        iters = meta.get("iters")
    n_devices = int(meta.get("n_devices", 1) or 1)

    ops = device_ops(events)
    if events and not ops:
        problems.append("no device-op events in trace (device lanes "
                        "missing — host-only capture?)")
    buckets = bucket_phases(ops)
    overlap = collective_overlap(ops)

    phases: Dict[str, Any] = {}
    sum_ms = 0.0
    sum_ms_per_iter = 0.0
    denom = (int(iters) * n_devices) if iters else None
    for ph, b in buckets["phases"].items():
        ms = b["us"] / 1e3
        sum_ms += ms
        per = round(ms / denom, 6) if denom else None
        if per is not None:
            sum_ms_per_iter += per
        phases[ph] = {"ms": round(ms, 6), "ms_per_iter": per,
                      "events": b["events"]}
    anchor = meta.get("anchor_ms_per_iter")
    attribution = (round(sum_ms_per_iter / anchor, 4)
                   if denom and anchor else None)
    # the device-op anchor: all device time an iteration, what the trace
    # can attribute; the wall anchor minus it is the host's share
    other_per_iter = (round(buckets["other_us"] / 1e3 / denom, 6)
                      if denom else None)
    device_ms_per_iter = (round(sum_ms_per_iter + other_per_iter, 6)
                          if denom else None)
    device_attribution = (round(sum_ms_per_iter / device_ms_per_iter, 4)
                          if device_ms_per_iter else None)
    busy_ms = buckets["busy_us"] / 1e3
    wall_s = meta.get("wall_s")
    if not meta:
        problems.append("no profview_meta.json sidecar (per-iteration "
                        "normalization and the predicted column are "
                        "unavailable)")
    elif ops and buckets["other_events"] == len(ops):
        problems.append("no pcg/* range encloses any device op — "
                        "attribution is all 'other'")
    verdict = "ok" if not problems else "degraded: " + "; ".join(problems)
    vias: Dict[str, int] = {}
    for op in ops:
        vias[str(op["via"])] = vias.get(str(op["via"]), 0) + 1
    return {
        "source": src,
        "verdict": verdict,
        "n_events": len(events),
        "n_device_ops": len(ops),
        "attributed_via": vias,
        "phases": phases,
        "sum_ms": round(sum_ms, 6),
        "sum_ms_per_iter": (round(sum_ms_per_iter, 6) if denom else None),
        "other_ms": round(buckets["other_us"] / 1e3, 6),
        "other_events": buckets["other_events"],
        "other_ms_per_iter": other_per_iter,
        "unknown_scopes": buckets["unknown_scopes"],
        "busy_ms": round(busy_ms, 6),
        "busy_share": (round(busy_ms / (wall_s * 1e3), 4)
                       if wall_s else None),
        "iters": iters,
        "n_devices": n_devices,
        "anchor_ms_per_iter": anchor,
        "attribution": attribution,
        "device_ms_per_iter": device_ms_per_iter,
        "device_attribution": device_attribution,
        "overlap_frac": overlap["overlap_frac"],
        "overlap": {k: (round(v, 6) if isinstance(v, float) else v)
                    for k, v in overlap.items()},
        "pcg_variant": meta.get("pcg_variant"),
        "precond": meta.get("precond"),
        "nrhs": meta.get("nrhs"),
        "backend": meta.get("backend"),
        "n_dof": meta.get("n_dof"),
        "platform": meta.get("platform"),
    }


def emit_prof_report(recorder, report: Dict[str, Any]) -> None:
    """Emit one parsed report as the schema-versioned ``prof_report``
    event plus the ``prof.*`` gauges."""
    recorder.event("prof_report", **report)
    for ph, d in report["phases"].items():
        if d.get("ms_per_iter") is not None:
            recorder.gauge(f"prof.{ph}_ms_per_iter", d["ms_per_iter"])
    if report.get("overlap_frac") is not None:
        recorder.gauge("prof.overlap_frac",
                       round(report["overlap_frac"], 6))
    if report.get("attribution") is not None:
        recorder.gauge("prof.attribution", report["attribution"])
    recorder.gauge("prof.other_ms", report["other_ms"])


def predicted_from_meta(meta: dict) -> Optional[dict]:
    """The obs/perf.py cost model rebuilt from a capture sidecar (the
    predicted column of the offline report); None when the meta carries
    no usable shape.  Unknown variant/precond names stay loud
    (KeyError)."""
    from pcg_mpi_solver_tpu_torch.obs import perf as _perf

    if not meta:
        return None
    shape = _perf.shape_from_detail(meta)
    if shape is None:
        return None
    return _perf.cost_model(
        shape, str(meta.get("pcg_variant", "classic")),
        str(meta.get("precond", "jacobi")),
        int(meta.get("nrhs", 1) or 1),
        _perf.resolve_profile(str(meta.get("platform", "cpu"))))


def format_report(report: Dict[str, Any],
                  predicted: Optional[dict] = None,
                  recorded: Optional[dict] = None) -> str:
    """Human table of one parsed report: per-phase rows with the
    predicted (cost model) and recorded (phase probes) columns when
    available next to the trace-measured ms/iter, then the busy share,
    the overlap verdict and the degraded-mode notes."""
    from pcg_mpi_solver_tpu_torch.obs.perf import PHASES

    per_iter = report.get("sum_ms_per_iter") is not None
    lines = []
    lines.append(f"{'phase':<10} {'predicted':>10} {'recorded':>10} "
                 + (f"{'measured':>10} {'share':>7}" if per_iter
                    else f"{'measured_ms':>12} {'share':>7}"))
    total = report["sum_ms"] or 0.0
    pred_sum = 0.0
    for ph in PHASES:
        d = report["phases"].get(ph, {})
        meas = d.get("ms_per_iter") if per_iter else d.get("ms", 0.0)
        share = (d.get("ms", 0.0) / total) if total else 0.0
        pm = (predicted["phases"][ph]["model_ms"]
              if predicted is not None else None)
        pred_sum += pm or 0.0
        rm = (recorded or {}).get(ph)
        pm_s = f"{pm:>10.4f}" if pm is not None else f"{'-':>10}"
        rm_s = f"{rm:>10.4f}" if rm is not None else f"{'-':>10}"
        ms_s = (f"{meas:>10.4f}" if per_iter
                else f"{meas:>12.3f}")
        lines.append(f"{ph:<10} {pm_s} {rm_s} {ms_s} {share:>6.0%}")
    sum_meas = (report["sum_ms_per_iter"] if per_iter
                else report["sum_ms"])
    ps = f"{pred_sum:>10.4f}" if predicted is not None else f"{'-':>10}"
    lines.append(f"{'sum':<10} {ps} {'':>10} "
                 + (f"{sum_meas:>10.4f}" if per_iter
                    else f"{sum_meas:>12.3f}"))
    lines.append(f"other (unbucketed): {report['other_ms']:.3f} ms over "
                 f"{report['other_events']} event(s)")
    if report.get("unknown_scopes"):
        lines.append("UNKNOWN pcg/* scope labels (counted, not "
                     f"dropped): {report['unknown_scopes']}")
    if report.get("device_ms_per_iter") is not None:
        lines.append(
            f"device-op anchor: {report['device_ms_per_iter']:.4f} "
            f"ms/iter ({report.get('iters')} iters, "
            f"{report.get('n_devices')} device(s)); phase share of "
            f"device-op time: {report.get('device_attribution')}")
    lines.append(f"busy: {report['busy_ms']:.3f} ms (union of the device "
                 f"intervals)"
                 + (f", {report['busy_share']:.1%} of the capture's wall"
                    if report.get("busy_share") is not None else "")
                 + f"; attributed via {report.get('attributed_via')}")
    if report.get("anchor_ms_per_iter"):
        gap = None
        if report.get("device_ms_per_iter") is not None:
            gap = (report["anchor_ms_per_iter"]
                   - report["device_ms_per_iter"])
        lines.append(
            f"wall anchor: {report['anchor_ms_per_iter']:.4f} ms/iter; "
            f"attribution (phase sum / wall): "
            f"{report.get('attribution')}"
            + (f"; gap outside every device op (host, launches, reads): "
               f"{gap:.4f} ms/iter" if gap is not None else ""))
    ov = report["overlap"]
    if report.get("overlap_frac") is not None:
        lines.append(
            f"collective overlap: {report['overlap_frac']:.3f} "
            f"({ov['overlap_us'] / 1e3:.3f} of {ov['coll_us'] / 1e3:.3f}"
            f" ms across {ov['n_collectives']} collective op(s) hidden "
            "behind concurrent compute)")
    elif ov["n_collectives"]:
        lines.append(f"collective overlap: n/a ({ov['n_collectives']} "
                     "collective op(s) carry zero duration)")
    else:
        lines.append("collective overlap: n/a (no collective ops in "
                     "trace — single-device capture?)")
    lines.append(f"verdict: {report['verdict']}")
    return "\n".join(lines)
