"""Live run monitor over flight/telemetry JSONL shards: ``watch PATH``
tails the stream a running solve writes and answers an operator's three
questions: is it alive, how far along is it, when will it finish.

Port of ``pcg_mpi_solver_tpu/obs/watch.py``.

* **alive**: every shard's newest record time (heartbeats included, and a
  last heartbeat cut mid-write still counts through
  :func:`~pcg_mpi_solver_tpu_torch.obs.flight.salvage_truncated_tail`).  A
  single silent shard is a warning; a **stall** is flagged only when ALL
  shards are silent past the threshold (one slow process of a
  multi-process run is skew; all of them silent is a wedged run).
* **progress**: dispatch counts and the completed steps' residuals from
  ``step`` / ``dispatch`` / ``resid_trace`` events, and the newest note.
* **ETA**: the cost model's ``predicted_ms_per_iter`` (the ``cost_model``
  event every stream carries) times the iterations the observed
  convergence rate says remain (a log-linear fit of the newest residual
  series).  Every input is optional; a missing one gives the ETA a named
  reason, never a crash.

Pointed at a solve-service journal (``watch spool/journal.jsonl``) the
snapshot also folds the job lifecycle: counts by op, the jobs in flight
and the drain record (a drained journal reads DONE; a SIGKILLed daemon's
journal keeps its ``serve`` bracket open and trips the stall alarm once
its heartbeats stop).

Imports neither torch nor numpy: watching works on a machine without the
accelerator environment.  It only reads the watched stream; its own
events go to a separate ``--telemetry-out`` sink.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict, List, Optional

from pcg_mpi_solver_tpu_torch.obs.flight import (
    DEFAULT_HEARTBEAT_S, find_shards, flight_verdict,
    read_jsonl_tolerant, salvage_truncated_tail)

#: Default stall threshold = this many heartbeat intervals of
#: fleet-wide silence (the heartbeat cadence is the stream's liveness
#: contract; 3x tolerates one lost-to-truncation beat plus scheduler
#: jitter without crying wolf).
STALL_HEARTBEATS = 3.0


def stall_threshold_s(stall_after_s: Optional[float] = None) -> float:
    """Resolve the stall threshold: an explicit ``--stall-after`` wins,
    else ``STALL_HEARTBEATS`` x the configured heartbeat cadence (same
    env override the writer honors)."""
    if stall_after_s is not None and stall_after_s > 0:
        return float(stall_after_s)
    try:
        hb = float(os.environ.get("PCG_TPU_FLIGHT_HEARTBEAT_S",
                                  DEFAULT_HEARTBEAT_S))
    except ValueError:
        hb = DEFAULT_HEARTBEAT_S
    return STALL_HEARTBEATS * max(hb, 0.05)


def _shard_status(path: str, now: float) -> Dict[str, Any]:
    """One shard's liveness + flight state (tolerant, never raises)."""
    events, truncated = read_jsonl_tolerant(path)
    last_t = None
    done = False
    for ev in events:
        t = ev.get("t")
        if isinstance(t, (int, float)):
            last_t = t if last_t is None else max(last_t, t)
        if ev.get("kind") == "run_summary":
            done = True
    tail = salvage_truncated_tail(path)
    if tail and isinstance(tail.get("t"), (int, float)):
        if last_t is None or tail["t"] > last_t:
            last_t = tail["t"]
    fv = flight_verdict(events)
    return {"path": path, "events": events, "truncated": truncated,
            "last_t": last_t,
            "silent_s": (now - last_t) if last_t is not None else None,
            "in_flight": fv["in_flight"], "done": done,
            "salvaged_tail": bool(tail)}


def _residual_series(events: List[Dict[str, Any]]
                     ) -> List[float]:
    """Newest residual decay series (relative, monotone index = one CG
    iteration): the last ``resid_trace`` event's ``normr`` ring when
    present, else the completed steps' ``relres`` (one entry per step —
    coarser, but the same decades-per-iteration fit applies with the
    per-step iteration counts)."""
    for ev in reversed(events):
        if ev.get("kind") == "resid_trace":
            normr = ev.get("normr")
            if isinstance(normr, list):
                vals = [float(v) for v in normr
                        if isinstance(v, (int, float)) and v > 0]
                if len(vals) >= 2:
                    return vals
    return []


def _rate_decades_per_iter(events: List[Dict[str, Any]]
                           ) -> Optional[float]:
    """Observed convergence rate in residual decades per iteration
    (negative = converging); None when the stream carries no usable
    series."""
    vals = _residual_series(events)
    if len(vals) >= 2 and vals[0] > 0 and vals[-1] > 0:
        return (math.log10(vals[-1]) - math.log10(vals[0])) \
            / (len(vals) - 1)
    # fall back to completed steps: relres over cumulative iters
    pts = []
    iters_cum = 0
    for ev in events:
        if ev.get("kind") != "step":
            continue
        it = ev.get("iters")
        rr = ev.get("relres")
        if isinstance(it, (int, float)) and isinstance(rr, (int, float)) \
                and rr > 0 and it > 0:
            iters_cum += int(it)
            pts.append((iters_cum, math.log10(rr)))
    if len(pts) >= 2 and pts[-1][0] > pts[0][0]:
        return (pts[-1][1] - pts[0][1]) / (pts[-1][0] - pts[0][0])
    return None


def _serve_section(events: List[Dict[str, Any]]
                   ) -> Optional[Dict[str, Any]]:
    """Fold serve-journal records (job-lifecycle ops tagged with the
    ``journal`` schema field) into per-op counts + the in-flight job
    set; None when the stream is not a serve journal.  The
    daemon's liveness rides the same heartbeats the stall detector
    already watches — this section adds the per-job progress."""
    from pcg_mpi_solver_tpu_torch.serve.journal import (
        DRAIN_OP, JOB_OPS, TERMINAL_OPS)

    counts: Dict[str, int] = {}
    in_flight: Dict[str, str] = {}
    drained = False
    drain_reason = None
    for ev in events:
        if ev.get("kind") != "flight" or not ev.get("journal"):
            continue
        op = ev.get("op")
        if op == DRAIN_OP:
            drained = True
            drain_reason = ev.get("reason")
            continue
        if op not in JOB_OPS:
            continue
        counts[op] = counts.get(op, 0) + 1
        jobs = ev.get("jobs") if isinstance(ev.get("jobs"), list) \
            else [ev.get("job")]
        for job in jobs:
            if not isinstance(job, str):
                continue
            if op in TERMINAL_OPS:
                in_flight.pop(job, None)
            else:
                in_flight[job] = op
    if not counts and not drained:
        return None
    return {"jobs": counts, "in_flight": sorted(in_flight),
            "drained": drained, "drain_reason": drain_reason}


def watch_snapshot(path: str, now: Optional[float] = None,
                   stall_after_s: Optional[float] = None,
                   tol: float = 1e-8) -> Dict[str, Any]:
    """One monitor snapshot of a (possibly running) run's JSONL stream.

    ``path`` is the base telemetry/flight path; all on-disk ``.pN``
    shards are tailed (multi-shard, truncation-tolerant — the `summary`
    contract).  Status: ``empty`` (no shards / no events), ``done`` (a
    ``run_summary`` landed and nothing is in flight), ``stalled`` (ALL
    shards silent past the threshold), else ``running``.  ``tol`` is the
    convergence target the ETA aims the observed rate at (the stream
    does not carry the run's tol; the default matches SolverConfig's and
    the rendering names the assumption)."""
    now = time.time() if now is None else now
    threshold = stall_threshold_s(stall_after_s)
    paths = find_shards(path)
    shards = [_shard_status(p, now) for p in paths]
    all_events: List[Dict[str, Any]] = []
    for sh in shards:
        all_events.extend(sh["events"])
    all_events.sort(key=lambda ev: ev["t"]
                    if isinstance(ev.get("t"), (int, float)) else -math.inf)

    dispatches: Dict[str, int] = {}
    steps: List[Dict[str, Any]] = []
    last_note = None
    predicted_ms = None
    last_relres = None
    for ev in all_events:
        kind = ev.get("kind")
        if kind == "dispatch":
            name = str(ev.get("name"))
            dispatches[name] = dispatches.get(name, 0) + 1
        elif kind == "step":
            steps.append({k: ev.get(k) for k in
                          ("step", "flag", "relres", "iters", "wall_s")})
            if isinstance(ev.get("relres"), (int, float)):
                last_relres = float(ev["relres"])
        elif kind == "note":
            last_note = str(ev.get("msg"))
        elif kind == "cost_model":
            pm = ev.get("predicted_ms_per_iter")
            if isinstance(pm, (int, float)):
                predicted_ms = float(pm)

    vals = _residual_series(all_events)
    if vals:
        last_relres = vals[-1] / vals[0]
    rate = _rate_decades_per_iter(all_events)
    eta_s = None
    eta_reason = None
    if predicted_ms is None:
        eta_reason = "no cost_model event in stream"
    elif rate is None:
        eta_reason = "no residual series yet (rate unknown)"
    elif rate >= 0:
        eta_reason = "residual not converging (rate >= 0)"
    elif last_relres is None or last_relres <= tol:
        eta_reason = "already at tol" if last_relres is not None \
            else "no residual observed"
    else:
        iters_left = math.log10(last_relres / tol) / (-rate)
        eta_s = round(iters_left * predicted_ms / 1e3, 3)

    serve = _serve_section(all_events)
    live = [sh for sh in shards if sh["last_t"] is not None]
    silent = [sh for sh in shards
              if sh["silent_s"] is None or sh["silent_s"] > threshold]
    done = bool(live) and all(sh["done"] for sh in live) \
        and not any(sh["in_flight"] for sh in live)
    # a gracefully-drained serve journal is DONE, not stalled: the
    # daemon stamped its drain record and closed the bracket — silence
    # after that is the expected end state, not a wedged run
    if serve is not None and serve["drained"] \
            and not any(sh["in_flight"] for sh in live):
        done = bool(live)
    if not live:
        status = "empty"
    elif done:
        status = "done"
    elif len(silent) == len(shards):
        status = "stalled"
    else:
        status = "running"
    min_silent = min((sh["silent_s"] for sh in live
                      if sh["silent_s"] is not None), default=None)
    return {
        "path": path, "status": status, "now": now,
        "stall_after_s": threshold, "tol": tol,
        "n_shards": len(shards),
        "silent_s": round(min_silent, 3) if min_silent is not None
        else None,
        "shards": [{k: sh[k] for k in
                    ("path", "truncated", "last_t", "silent_s",
                     "in_flight", "done", "salvaged_tail")}
                   for sh in shards],
        "serve": serve,
        "dispatches": dispatches, "steps": steps,
        "last_note": last_note, "last_relres": last_relres,
        "rate_decades_per_iter": round(rate, 5) if rate is not None
        else None,
        "predicted_ms_per_iter": predicted_ms,
        "eta_s": eta_s, "eta_reason": eta_reason,
    }


def format_watch(snap: Dict[str, Any]) -> str:
    """Human rendering of one :func:`watch_snapshot`."""
    lines = [f"watch: {snap['path']}   status: {snap['status'].upper()}"
             f"   shards: {snap['n_shards']}"
             f"   stall threshold: {snap['stall_after_s']:.1f}s"]
    for sh in snap["shards"]:
        age = f"{sh['silent_s']:.1f}s ago" if sh["silent_s"] is not None \
            else "never"
        extra = ""
        if sh["in_flight"]:
            extra += "  in flight: " + ", ".join(sh["in_flight"])
        if sh["salvaged_tail"]:
            extra += "  (tail salvaged from truncated line)"
        elif sh["truncated"]:
            extra += f"  ({sh['truncated']} truncated line(s))"
        if sh["done"]:
            extra += "  done"
        lines.append(f"  shard {os.path.basename(sh['path'])}: "
                     f"last record {age}{extra}")
    srv = snap.get("serve")
    if srv is not None:
        ops = "  ".join(f"{k}={v}" for k, v in sorted(srv["jobs"].items()))
        lines.append(f"  serve jobs: {ops}" if ops else "  serve jobs: -")
        if srv["in_flight"]:
            lines.append("  in-flight jobs: "
                         + ", ".join(srv["in_flight"]))
        if srv["drained"]:
            lines.append(f"  serve drained ({srv['drain_reason']})")
    if snap["dispatches"]:
        disp = "  ".join(f"{k}x{v}"
                         for k, v in sorted(snap["dispatches"].items()))
        lines.append(f"  dispatches: {disp}")
    for st in snap["steps"][-5:]:
        rr = st.get("relres")
        rr = f"{rr:.3e}" if isinstance(rr, (int, float)) else "?"
        lines.append(f"  step {st.get('step')}: flag={st.get('flag')} "
                     f"relres={rr} iters={st.get('iters')} "
                     f"wall={st.get('wall_s')}s")
    if snap["last_note"]:
        lines.append(f"  last note: {snap['last_note']}")
    rr = snap["last_relres"]
    if rr is not None:
        rate = snap["rate_decades_per_iter"]
        lines.append(f"  residual: {rr:.3e}"
                     + (f"   rate: {rate:+.4f} decades/iter"
                        if rate is not None else ""))
    if snap["eta_s"] is not None:
        lines.append(f"  ETA to tol={snap['tol']:.0e} (assumed): "
                     f"~{snap['eta_s']:.1f}s "
                     f"(cost model {snap['predicted_ms_per_iter']:.3f} "
                     f"ms/iter x observed rate)")
    else:
        lines.append(f"  ETA: n/a ({snap['eta_reason']})")
    if snap["status"] == "stalled":
        lines.append(f"  STALL: all {snap['n_shards']} shard(s) silent "
                     f"> {snap['stall_after_s']:.1f}s "
                     f"(newest record {snap['silent_s']:.1f}s ago)")
    return "\n".join(lines)


def emit_watch_events(recorder, snap: Dict[str, Any]) -> None:
    """Monitor telemetry: one ``watch`` event per snapshot, plus a
    ``stall`` event when the fleet has gone silent."""
    recorder.event("watch", path=snap["path"], status=snap["status"],
                   n_shards=snap["n_shards"], silent_s=snap["silent_s"],
                   eta_s=snap["eta_s"])
    if snap["status"] == "stalled":
        recorder.event("stall", path=snap["path"],
                       silent_s=snap["silent_s"],
                       threshold_s=snap["stall_after_s"],
                       in_flight=sorted({n for sh in snap["shards"]
                                         for n in sh["in_flight"]}))
