"""Cross-process collective-skew attribution over per-process profile
captures.

Port of ``pcg_mpi_solver_tpu/obs/fleet.py``, the multi-process twin of
:mod:`~pcg_mpi_solver_tpu_torch.obs.profview`'s single-capture report.
A multi-process solve with ``RunConfig.profile_dir`` writes one
torch.profiler capture a rank, under ``p<rank>/``.  Each process's trace
clock has its own origin, so the timelines cannot be compared directly.
But a collective is a synchronization point: every participant leaves it
at (physically) the same instant, so matched collective END events are
cross-process clock anchors.  The per-process clock offset is the median
end-time difference against process 0 over every matched collective
(median: robust to the rounds a profiler clips at a trace boundary).  The
port's collectives are gloo's rounds (``gloo:all_gather`` for every sum
over ranks, ``gloo:send`` / ``gloo:recv`` for the structured halo's plane
exchange), recorded on the host.

With the timelines aligned, each matched collective's duration splits
into

* **transport** — the minimum duration across processes.  The process
  that arrived LAST did not wait for anyone; its duration is the pure
  wire/reduction cost.
* **wait** — each process's excess over transport: the time it sat
  blocked at the rendezvous because a straggler arrived late.

The straggler of a collective is therefore the process with the
*minimum* duration (it arrived last and waited least); the wait it
caused is the sum of every other process's excess.  Summed per phase
(the ``pcg/matvec`` vs ``pcg/reduce`` ranges, profview's phases) this
names which rank the latency comes from.

Import-light on purpose (no torch, no numpy): ``fleet-report`` runs on
a laptop against a copied capture directory.  The clock alignment is
``obs/flight.align_offsets``, shared with ``telemetry-merge --align
collectives``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

from pcg_mpi_solver_tpu_torch.obs.flight import align_offsets
from pcg_mpi_solver_tpu_torch.obs.profview import (
    _SCOPE_RE, _span, find_trace_files, load_meta, phase_of,
    read_trace_events)

FLEET_SCHEMA = "pcg-tpu-fleet/1"

#: the name prefix of gloo's collective spans in a torch.profiler trace
GLOO_PREFIX = "gloo:"

_PDIR_RE = re.compile(r"^p(\d+)$")


# ----------------------------------------------------------------------
# Capture discovery + per-process collective sequences
# ----------------------------------------------------------------------

def discover_process_dirs(root: str) -> List[Tuple[int, str]]:
    """``(process index, dir)`` pairs under a capture root: the
    ``p<idx>/`` subdirs a multi-process solve's ``profile_dir`` holds, or ``[(0, root)]`` when the root itself holds a single
    process's trace (degraded single-process mode)."""
    out: List[Tuple[int, str]] = []
    if os.path.isdir(root):
        for name in sorted(os.listdir(root)):
            m = _PDIR_RE.match(name)
            d = os.path.join(root, name)
            if m and os.path.isdir(d) and find_trace_files(d):
                out.append((int(m.group(1)), d))
    if out:
        return sorted(out)
    if find_trace_files(root):
        return [(0, root)]
    return []


def collective_events(events: List[dict]) -> List[dict]:
    """The gloo collectives of one process's torch.profiler trace
    (``gloo:all_gather``, ``gloo:send``, ``gloo:recv``: the spans gloo
    records around each round, on its own thread), each with the
    ``pcg/*`` range of the process that encloses its start (``label``,
    any lane), as ``{"base", "name", "ts", "dur", "label"}``."""
    ranges = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            m = _SCOPE_RE.search(str(e.get("name", "")))
            sp = _span(e)
            if m is not None and sp is not None:
                ranges.append((sp[0], sp[1], m.group(0)))
    out = []
    for e in events:
        name = str(e.get("name", ""))
        if e.get("ph") != "X" or not name.startswith(GLOO_PREFIX):
            continue
        sp = _span(e)
        if sp is None:
            continue
        # the innermost enclosing range (the latest-starting one)
        inside = [r for r in ranges if r[0] <= sp[0] <= r[1]]
        label = max(inside)[2] if inside else None
        out.append({"base": name, "name": name, "ts": sp[0],
                    "dur": sp[1] - sp[0], "label": label})
    return out


def collective_occurrences(ops: List[dict]) -> Dict[Tuple[str, int], dict]:
    """One record per (collective name, occurrence index) of one
    process's collectives, in start order: every process runs the same
    sequence of rounds, so the k-th occurrence of a name is the same
    round on every rank (``end`` = start + duration)."""
    by_base: Dict[str, List[dict]] = {}
    for op in ops:
        by_base.setdefault(op["base"], []).append(op)
    reps: Dict[Tuple[str, int], dict] = {}
    for base, evs in by_base.items():
        evs.sort(key=lambda o: o["ts"])
        for k, op in enumerate(evs):
            reps[(base, k)] = dict(op, end=op["ts"] + op["dur"])
    return reps


def _load_process(pdir: str) -> Tuple[Optional[dict], List[str]]:
    """Parse one process's newest trace: ``{"colls", "meta", "n_ops"}``
    plus the tolerant reader's problem list (never raises)."""
    files = find_trace_files(pdir)
    if not files:
        return None, [f"{pdir}: no trace files"]
    events, problems = read_trace_events(files[0])
    ops = collective_events(events)
    colls = collective_occurrences(ops)
    return ({"dir": pdir, "trace": files[0], "colls": colls,
             "meta": load_meta(files[0]), "n_ops": len(ops)},
            [f"{os.path.basename(pdir)}: {p}" for p in problems])


# ----------------------------------------------------------------------
# The fleet report
# ----------------------------------------------------------------------

def fleet_report(root: str) -> Dict[str, Any]:
    """Cross-process skew attribution over a capture root (see module
    docstring for the alignment + transport/wait model).  Tolerant: a
    missing process dir, an unreadable trace, or a collective-free
    capture degrades the verdict by name — it never raises."""
    problems: List[str] = []
    pdirs = discover_process_dirs(root)
    procs: Dict[int, dict] = {}
    for idx, pdir in pdirs:
        info, probs = _load_process(pdir)
        problems.extend(probs)
        if info is not None:
            procs[idx] = info
    report: Dict[str, Any] = {
        "schema": FLEET_SCHEMA, "source": root,
        "n_processes": len(procs),
        "processes": {}, "phases": {},
        "matched_collectives": 0, "skew_frac": None,
        "transport_ms": 0.0, "wait_ms": 0.0,
        "straggler": None, "clock_offsets_ms": {},
        "iters": None, "verdict": "ok",
    }
    if not procs:
        problems.append("no per-process captures found")
        report["verdict"] = "degraded: " + "; ".join(problems)
        return report
    meta0 = next((procs[i]["meta"] for i in sorted(procs)
                  if procs[i]["meta"]), None)
    iters = None
    if meta0:
        try:
            iters = int(meta0.get("iters") or 0) or None
        except (TypeError, ValueError):
            iters = None
    report["iters"] = iters
    if len(procs) == 1:
        idx = next(iter(procs))
        report["processes"][str(idx)] = {
            "dir": procs[idx]["dir"], "coll_ms": round(sum(
                c["dur"] for c in procs[idx]["colls"].values()) / 1e3, 3),
            "wait_ms": None, "transport_ms": None, "skew_frac": None,
            "wait_ms_per_iter": None, "caused_wait_ms": None,
            "straggler_rank": None}
        problems.append("single-process capture (no cross-process skew)")
        report["verdict"] = "degraded: " + "; ".join(problems)
        return report

    # -- clock alignment over matched collective END anchors -----------
    ids = sorted(procs)
    anchors = {i: {k: c["end"] for k, c in procs[i]["colls"].items()}
               for i in ids}
    offsets_us, n_matched = align_offsets(anchors)
    report["clock_offsets_ms"] = {
        str(i): round(offsets_us[i] / 1e3, 3) for i in ids}
    report["matched_collectives"] = n_matched
    if n_matched == 0:
        problems.append("no matched collectives across processes")
        report["verdict"] = "degraded: " + "; ".join(problems)
        return report

    shared = set(anchors[ids[0]])
    for i in ids[1:]:
        shared &= set(anchors[i])

    per_proc = {i: {"coll_us": 0.0, "wait_us": 0.0,
                    "caused_wait_us": 0.0, "straggler_hits": 0}
                for i in ids}
    phases: Dict[str, dict] = {}
    transport_us_total = 0.0
    for key in sorted(shared):
        durs = {i: procs[i]["colls"][key]["dur"] for i in ids}
        transport = min(durs.values())
        transport_us_total += transport
        waits = {i: durs[i] - transport for i in ids}
        slow = min(ids, key=lambda i: durs[i])   # arrived last, waited least
        caused = sum(waits.values())
        phase = None
        for i in ids:
            phase = phase_of(procs[i]["colls"][key])
            if phase is not None:
                break
        ph = phases.setdefault(phase or "other", {
            "matched": 0, "wait_ms": 0.0,
            "caused_wait_us": {i: 0.0 for i in ids}})
        ph["matched"] += 1
        ph["wait_ms"] += caused / 1e3
        ph["caused_wait_us"][slow] += caused
        for i in ids:
            per_proc[i]["coll_us"] += durs[i]
            per_proc[i]["wait_us"] += waits[i]
        per_proc[slow]["caused_wait_us"] += caused
        per_proc[slow]["straggler_hits"] += 1

    coll_us_total = sum(p["coll_us"] for p in per_proc.values())
    wait_us_total = sum(p["wait_us"] for p in per_proc.values())
    ranking = sorted(ids, key=lambda i: (-per_proc[i]["caused_wait_us"],
                                         i))
    report["transport_ms"] = round(transport_us_total / 1e3, 3)
    report["wait_ms"] = round(wait_us_total / 1e3, 3)
    report["skew_frac"] = round(wait_us_total / coll_us_total, 4) \
        if coll_us_total > 0 else None
    if per_proc[ranking[0]]["caused_wait_us"] > 0:
        report["straggler"] = str(ranking[0])
    for rank, i in enumerate(ranking):
        pp = per_proc[i]
        report["processes"][str(i)] = {
            "dir": procs[i]["dir"],
            "coll_ms": round(pp["coll_us"] / 1e3, 3),
            "wait_ms": round(pp["wait_us"] / 1e3, 3),
            "transport_ms": round(transport_us_total / 1e3, 3),
            "skew_frac": round(pp["wait_us"] / pp["coll_us"], 4)
            if pp["coll_us"] > 0 else None,
            "wait_ms_per_iter": round(pp["wait_us"] / 1e3 / iters, 4)
            if iters else None,
            "caused_wait_ms": round(pp["caused_wait_us"] / 1e3, 3),
            "straggler_hits": pp["straggler_hits"],
            "straggler_rank": rank,
        }
    for name, ph in phases.items():
        prank = sorted(ids, key=lambda i: (-ph["caused_wait_us"][i], i))
        report["phases"][name] = {
            "matched": ph["matched"],
            "wait_ms": round(ph["wait_ms"], 3),
            "straggler": str(prank[0])
            if ph["caused_wait_us"][prank[0]] > 0 else None,
            "ranking": [str(i) for i in prank],
        }
    if problems:
        report["verdict"] = "degraded: " + "; ".join(problems)
    return report


# ----------------------------------------------------------------------
# Rendering + telemetry emission
# ----------------------------------------------------------------------

def format_fleet_report(report: Dict[str, Any]) -> str:
    """Human-readable fleet report (the CLI's ``fleet-report``)."""
    lines = [f"fleet report: {report['source']}",
             f"  processes: {report['n_processes']}   "
             f"matched collectives: {report['matched_collectives']}   "
             f"iters: {report['iters'] if report['iters'] else '?'}"]
    offs = report.get("clock_offsets_ms") or {}
    if offs:
        lines.append("  clock offsets vs p0 (ms): "
                     + "  ".join(f"p{i}={offs[i]:+.3f}"
                                 for i in sorted(offs, key=int)))
    if report.get("skew_frac") is not None:
        lines.append(f"  transport {report['transport_ms']:.3f} ms   "
                     f"wait {report['wait_ms']:.3f} ms   "
                     f"skew_frac {report['skew_frac']:.4f}")
    procs = report.get("processes") or {}
    if procs:
        lines.append("  proc   coll_ms    wait_ms  skew_frac  "
                     "wait_ms/iter  caused_ms  rank")
        for i in sorted(procs, key=int):
            p = procs[i]

            def _f(v, fmt):
                return format(v, fmt) if v is not None else "-"

            lines.append(
                f"  p{i:<4} {_f(p['coll_ms'], '9.3f')}  "
                f"{_f(p['wait_ms'], '9.3f')}  {_f(p['skew_frac'], '9.4f')}  "
                f"{_f(p.get('wait_ms_per_iter'), '12.4f')}  "
                f"{_f(p.get('caused_wait_ms'), '9.3f')}  "
                f"{_f(p.get('straggler_rank'), 'd')}")
    for name in sorted(report.get("phases") or {}):
        ph = report["phases"][name]
        who = f"p{ph['straggler']}" if ph["straggler"] is not None \
            else "none (balanced)"
        lines.append(f"  phase {name:<10} matched {ph['matched']:>4}  "
                     f"wait {ph['wait_ms']:9.3f} ms  straggler {who}")
    if report.get("straggler") is not None:
        lines.append(f"  straggler: p{report['straggler']}")
    lines.append(f"  verdict: {report['verdict']}")
    return "\n".join(lines)


def emit_fleet_report(recorder, report: Dict[str, Any]) -> None:
    """One schema-versioned ``fleet_report`` telemetry event + gauges."""
    recorder.event(
        "fleet_report", source=report["source"],
        n_processes=report["n_processes"],
        matched_collectives=report["matched_collectives"],
        skew_frac=report["skew_frac"], straggler=report["straggler"],
        processes=report["processes"], phases=report["phases"],
        clock_offsets_ms=report["clock_offsets_ms"],
        verdict=report["verdict"])
    if report["skew_frac"] is not None:
        recorder.gauge("fleet.skew_frac", report["skew_frac"])
    for i, p in (report.get("processes") or {}).items():
        if p.get("wait_ms_per_iter") is not None:
            recorder.gauge(f"fleet.wait_ms_per_iter.p{i}",
                           p["wait_ms_per_iter"])


def bench_detail_fields(report: Dict[str, Any],
                        process_index: int = 0) -> Dict[str, Any]:
    """The ``skew_frac`` / ``straggler_rank`` fields of THIS process, or
    ``{}`` when the capture carried no cross-process skew (single
    process, no matched collectives): a report never carries a
    measurement that was not taken."""
    if report.get("skew_frac") is None:
        return {}
    p = (report.get("processes") or {}).get(str(process_index))
    if p is None or p.get("straggler_rank") is None:
        return {}
    return {"skew_frac": report["skew_frac"],
            "straggler_rank": p["straggler_rank"]}


def load_fleet_report(path: str) -> Optional[Dict[str, Any]]:
    """Read a previously saved fleet report JSON; None when absent or
    not a fleet report."""
    try:
        with open(path, encoding="utf-8") as f:
            rep = json.load(f)
    except (OSError, ValueError):
        return None
    return rep if isinstance(rep, dict) \
        and rep.get("schema") == FLEET_SCHEMA else None
