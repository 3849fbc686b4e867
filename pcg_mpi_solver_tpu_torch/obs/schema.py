"""Telemetry schemas: the versioned contracts of the telemetry events a
``MetricsRecorder`` emits and of the bench's result line.

Port of ``pcg_mpi_solver_tpu/obs/schema.py``, with the same schema tags,
so one consumer reads both packages' streams and lines.

* **Telemetry events** (``TELEMETRY_SCHEMA``, ``EVENT_KINDS``,
  ``validate_event``, ``validate_jsonl_text``): every event carries
  ``schema`` / ``t`` (unix seconds) / ``kind``; the per-kind required
  fields are in :data:`EVENT_KINDS`.
* **Bench result lines** (``BENCH_SCHEMA``, ``validate_bench_line``,
  ``validate_bench_text``): the one-line JSON of ``bench.py`` and
  ``serve/bench.py`` (``{"metric", "value", "unit", "vs_baseline",
  "detail"}``); committed pre-schema artifacts (``BENCH_r0*.json``) stay
  valid as legacy lines.

Unknown kinds and extra fields are allowed (forward compatibility):
validators reject only missing required fields, mistyped typed fields or
a schema version they do not speak.  Imports neither torch nor numpy.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List

from pcg_mpi_solver_tpu_torch.config import PCG_VARIANTS

# Bump the integer suffix on any BREAKING change (key removal/retyping);
# additive fields do not bump.
TELEMETRY_SCHEMA = "pcg-tpu-telemetry/1"
BENCH_SCHEMA = "pcg-tpu-bench/1"
KNOWN_TELEMETRY_SCHEMAS = (TELEMETRY_SCHEMA,)
KNOWN_BENCH_SCHEMAS = (BENCH_SCHEMA,)

# kind -> required field names (beyond the base schema/t/kind triplet).
EVENT_KINDS: Dict[str, tuple] = {
    # one line per completed solve step (quasi-static or Newmark)
    "step": ("step", "flag", "relres", "iters", "wall_s"),
    # one host-driven dispatch of the solve (cold = the first call of
    # that name, which carries the kernels' first launches)
    "dispatch": ("name", "wall_s", "cold"),
    # per-iteration residual ring buffer, one host transfer per solve
    "resid_trace": ("step", "n_recorded", "truncated", "normr"),
    # free-form breadcrumb (the PCG_TPU_VERBOSE lineage)
    "note": ("msg",),
    # explicit-dynamics scan chunk
    "dynamics_chunk": ("steps", "wall_s"),
    # bench harness phase timing
    "bench_phase": ("name", "wall_s"),
    # one warm-path cache probe (cache/: partition load-or-build, AOT
    # step load-or-export); `hit` is the cold/warm attribution bit
    "cache": ("name", "hit", "key", "wall_s"),
    # one recovery-ladder attempt or guarded re-dispatch (resilience/):
    # action = restart_minres | fallback_prec | escalate_f64 |
    # redispatch; trigger = flag2 | flag4 | nan_carry | device_loss
    "recovery": ("action", "attempt", "trigger"),
    # one injected fault (resilience/faultinject.py — deterministic
    # chaos): mode = kill|exc|nan|inf|rho0, point = dispatch|boundary
    "fault": ("mode", "point", "at"),
    # one mid-Krylov snapshot operation (op = save | restore)
    "snapshot": ("op", "step"),
    # one timestep-granular snapshot operation of a dynamics/Newmark
    # time history (op = save | restore; resilience/engine.py)
    "step_snapshot": ("op", "step"),
    # one preflight gate run (validate/): the policy applied, the
    # fail/warn counts, and the full per-check results list
    "preflight": ("policy", "failed", "checks"),
    # end-of-step ladder summary (emitted only when recoveries happened)
    "recovery_done": ("flag", "attempts", "actions"),
    # one batched multi-RHS solve (Solver.solve_many): block width,
    # wall, per-column flags
    "solve_many": ("nrhs", "wall_s", "flags"),
    # per-RHS outcome of a batched solve — one event per column/tenant,
    # carrying the rhs (column) index
    "rhs_solve": ("rhs", "flag", "relres", "iters"),
    # one QUARANTINED column of a batched solve (resilience/): the
    # column's recovery budget was spent (or absent) on `trigger`; the
    # block completed anyway and the column reports flag 5 with its
    # min-residual iterate — the billing/ops signal for a pathological
    # tenant load case
    "rhs_quarantine": ("rhs", "trigger", "flag", "attempts"),
    # fused-variant residual drift (arXiv:2501.03743): deferred
    # true-residual checks that disagreed with the recurrence norm this
    # solve (`drift` = count; blocked solves add per-column `cols`) —
    # sustained drift also routes into the ladder as flag 6
    "resid_drift": ("drift",),
    # one MG-preconditioner setup (ops/mg.py, precond="mg"): hierarchy
    # shape (levels/degree/dims), the estimated per-level Chebyshev
    # bounds, whether the fine bound came from the partition cache, and
    # the setup wall — the cost side of the iteration-count win
    "mg_setup": ("levels", "degree", "wall_s"),
    # analytic per-iteration cost model (obs/perf.py): per-phase
    # FLOPs/HBM-bytes/collective resources + roofline-predicted ms/iter
    # for the engaged (pcg_variant, precond, nrhs, backend) — emitted at
    # solver construction so every telemetry stream carries the number
    # its measured ms/iter should be judged against
    "cost_model": ("pcg_variant", "precond", "nrhs", "backend", "phases",
                   "predicted_ms_per_iter"),
    # one measured phase-attribution probe run (obs/phases.py /
    # `pcg-tpu perf-report`): per-phase measured ms/iter (matvec /
    # precond / reduction / axpy), their sum, and the whole-iteration
    # anchor from the real solve program
    "phase_probe": ("pcg_variant", "precond", "phases",
                    "sum_ms_per_iter", "whole_ms_per_iter"),
    # one bounded profiler-trace capture (obs/profview.py
    # capture_solve_profile, or the driver's profile_dir bracket): the
    # on-disk artifact path — the pointer `summary` and post-mortems
    # follow to the trace a run left behind
    "profile_capture": ("path",),
    # one parsed device-trace report (obs/profview.py profile_report /
    # `pcg-tpu prof-report`): per-phase bucketed device-op wall time,
    # the measured collective-overlap fraction (null when the trace
    # carries no collectives), and the tolerant reader's verdict
    # ("ok" or "degraded: <named reason>" — a truncated artifact still
    # emits, it never crashes)
    "prof_report": ("source", "phases", "overlap_frac", "verdict"),
    # one crash-durable flight record (obs/flight.py — fsync-per-event):
    # op = meta | begin | heartbeat | end | fail; begin/end/fail carry
    # name+seq, every record carries the monotonic clock next to the
    # base wall `t` so a dead run's artifact says what was in flight and
    # when it last breathed, across host clock jumps
    "flight": ("op", "mono"),
    # sharded setup attribution: which contiguous part range
    # THIS process built/loaded (`parts` = [lo, hi)), whether the
    # partition came cold (built) or warm (shard cache), and the
    # partition-build wall — the per-process record the setup ladder
    # aggregates and the sharded-warm-start tests assert on
    "setup_shard": ("parts", "n_parts", "cold", "partition_build_s"),
    # one cross-process collective-skew attribution report (obs/fleet.py
    # fleet_report / `pcg-tpu fleet-report`): per-process
    # transport-vs-wait split over clock-aligned matched collectives,
    # the fleet-wide skew fraction (null when the capture carried no
    # cross-process skew — single process, no matched collectives), the
    # named straggler, and the tolerant verdict
    "fleet_report": ("source", "n_processes", "matched_collectives",
                     "skew_frac", "verdict"),
    # one live-monitor snapshot (obs/watch.py / `pcg-tpu watch`): the
    # run's liveness status (running | stalled | done | empty), shard
    # count, fleet-wide newest-record age, and the cost-model x
    # observed-rate ETA (null with a named reason in the rendering)
    "watch": ("path", "status", "n_shards", "silent_s", "eta_s"),
    # the monitor's stall alarm: ALL shards' heartbeats silent past the
    # threshold — `silent_s` is the newest record's age at detection,
    # `in_flight` the union of unclosed flight brackets (what the run
    # was doing when it wedged)
    "stall": ("path", "silent_s", "threshold_s", "in_flight"),
    # a deadline-guarded host collective expired
    # (resilience/distributed.GuardedComm): which labelled
    # round stalled, the configured deadline, and the most
    # flight-silent peer rank (-1 when no peer shard was readable) —
    # the record a DeadPeerError post-mortem starts from
    "collective_timeout": ("label", "deadline_s", "suspect"),
    # one group-consistent snapshot epoch
    # (resilience/distributed.GroupSnapshotStore two-phase commit):
    # epoch number, in-flight step, shard count, and whether the commit
    # marker was (or will be) published; op="restore" on the read side
    "snapshot_epoch": ("epoch", "step", "shards", "committed"),
    # an armed elastic resume accepted an ``n_procs`` fingerprint
    # mismatch (Solver.resume_elastic): the writing fleet's process
    # count, this fleet's, and which store took it (snap | many | ckpt)
    "elastic_resume": ("from_procs", "to_procs", "prefix"),
    # one ADMITTED solve-service job (serve/admission.py): its absolute
    # admission ordinal, the cost-model price the admission was
    # judged against (predicted block seconds; null when the model is
    # unavailable — the pricing degrades to admit, never to a crash)
    # and the job's relative deadline
    "job_admit": ("job", "ordinal", "predicted_s", "deadline_s"),
    # one REJECTED admission with its NAMED reason
    # (deadline_infeasible | queue_full | draining | bad_spec) — the
    # no-silent-drops contract: a job the service will not run always
    # says why, in the stream and in its result file
    "job_reject": ("job", "reason"),
    # one load-SHED job (bounded-queue backpressure, serve/): the queue
    # was full and this already-admitted job was past its deadline, so
    # it was dropped — oldest first — with a named reason, never
    # silently
    "job_shed": ("job", "reason"),
    # one FINISHED solve-service job: ok = converged (flag 0); failed
    # jobs carry the named verdict ("injected: ..." for a chaos-
    # injected failure, "flagN" for a solver flag, "quarantined" for a
    # column quarantine)
    "job_done": ("job", "ok", "verdict"),
    # a tenant's request quarantined without failing its co-batched
    # block: either the per-column quarantine fired in-solve (the
    # event adds `rhs`, the column index) or the service boundary
    # caught a poisoned/non-finite RHS before dispatch
    "job_quarantine": ("job", "verdict"),
    # solve-service daemon drain/exit record (reason = sigterm | idle |
    # max_blocks): in-flight blocks finished, new admissions rejected,
    # journal closed clean — the graceful twin of the SIGKILL the job
    # journal replays through
    "serve_drain": ("reason",),
    # end-of-run counter/gauge/span snapshot
    "run_summary": ("counters", "gauges"),
}

BENCH_REQUIRED = ("metric", "value", "unit", "vs_baseline")

# Optional ``detail`` fields that are numeric or null WHEN present (absent
# from pre-schema lines): the warm-path setup attribution (``setup_s``,
# ``time_to_first_iter_s``: null when no dispatch ran), the measured
# block width and batched throughput (``nrhs``, ``nrhs_planned``,
# ``dof_iter_rhs_per_s``, ``nrhs_quarantined``, ``nrhs_recoveries``),
# time to solution (``time_to_tol_s``: null when the solve did not reach
# tol, ``iters``), the cost model's verdict (``predicted_ms_per_iter``,
# ``model_ratio``), the setup ladder's fields (``procs``,
# ``partition_build_s``, ``partition_serial_s``, ``cold_setup_s``,
# ``warm_setup_s``, ``ingest_peak_bytes``), the profiled leg's
# (``measured_ms_per_iter_matvec``, ``overlap_frac``, ``skew_frac``,
# ``straggler_rank``: absent, not null, when no capture measured them)
# and the serve leg's (``jobs_per_s``, ``jobs_per_s_serial``,
# ``queue_depth_max``, ``jobs_shed``: absent on every other leg).
BENCH_DETAIL_NUMERIC = ("setup_s", "time_to_first_iter_s", "nrhs",
                        "nrhs_planned", "dof_iter_rhs_per_s",
                        "nrhs_quarantined", "nrhs_recoveries",
                        "time_to_tol_s", "iters",
                        "predicted_ms_per_iter", "model_ratio",
                        "procs", "partition_build_s",
                        "partition_serial_s", "cold_setup_s",
                        "warm_setup_s", "ingest_peak_bytes",
                        "measured_ms_per_iter_matvec", "overlap_frac",
                        "skew_frac", "straggler_rank",
                        "jobs_per_s", "jobs_per_s_serial",
                        "queue_depth_max", "jobs_shed")
# ``setup_cache``: the partition cache's attribution (cache/)
BENCH_SETUP_CACHE_VALUES = ("off", "cold", "warm")
# ``pcg_variant``: the engaged PCG loop formulation, from the canonical
# name table (a line claiming a variant no loop knows is a schema error)
BENCH_PCG_VARIANT_VALUES = PCG_VARIANTS


def validate_event(ev: Any) -> List[str]:
    """Validate one telemetry event dict; returns a list of error strings
    (empty = valid)."""
    errs: List[str] = []
    if not isinstance(ev, dict):
        return [f"event is not an object: {type(ev).__name__}"]
    schema = ev.get("schema")
    if schema is None:
        errs.append("missing 'schema'")
    elif schema not in KNOWN_TELEMETRY_SCHEMAS:
        errs.append(f"unknown telemetry schema {schema!r}")
    if not isinstance(ev.get("t"), (int, float)):
        errs.append("missing/non-numeric 't'")
    kind = ev.get("kind")
    if not isinstance(kind, str) or not kind:
        errs.append("missing 'kind'")
        return errs
    for field in EVENT_KINDS.get(kind, ()):
        if field not in ev:
            errs.append(f"kind={kind}: missing required field {field!r}")
    return errs


def validate_bench_line(d: Any) -> List[str]:
    """Validate one bench result object (the parsed one-line JSON);
    returns a list of error strings (empty = valid)."""
    errs: List[str] = []
    if not isinstance(d, dict):
        return [f"bench line is not an object: {type(d).__name__}"]
    for field in BENCH_REQUIRED:
        if field not in d:
            errs.append(f"missing required key {field!r}")
    if "value" in d and not isinstance(d["value"], (int, float)):
        errs.append(f"'value' is not numeric: {d['value']!r}")
    schema = d.get("schema")
    if schema is not None and schema not in KNOWN_BENCH_SCHEMAS:
        errs.append(f"unknown bench schema {schema!r}")
    detail = d.get("detail")
    if isinstance(detail, dict):
        for field in BENCH_DETAIL_NUMERIC:
            if field in detail and detail[field] is not None \
                    and not isinstance(detail[field], (int, float)):
                errs.append(f"detail.{field} is not numeric/null: "
                            f"{detail[field]!r}")
        sc = detail.get("setup_cache")
        if sc is not None and sc not in BENCH_SETUP_CACHE_VALUES:
            errs.append(f"detail.setup_cache not in "
                        f"{BENCH_SETUP_CACHE_VALUES}: {sc!r}")
        pv = detail.get("pcg_variant")
        if pv is not None and pv not in BENCH_PCG_VARIANT_VALUES:
            errs.append(f"detail.pcg_variant not in "
                        f"{BENCH_PCG_VARIANT_VALUES}: {pv!r}")
    # a schema-less line is a legacy (pre-schema) artifact: still valid
    return errs


def _find_bench_payload(doc: Any) -> Any:
    """The metric object of a ``BENCH_*.json`` artifact: the raw
    one-line dict, or the round wrapper's ``parsed``."""
    if isinstance(doc, dict) and "metric" in doc:
        return doc
    if isinstance(doc, dict) and isinstance(doc.get("parsed"), dict):
        return doc["parsed"]
    return None


def validate_bench_text(text: str) -> List[str]:
    """Validate a ``BENCH_*.json`` artifact (a raw line or a round wrapper
    ``{"n", "cmd", "rc", "tail", "parsed"}``).  A wrapper of a failed run
    (``rc`` != 0, ``parsed`` null) is a legitimate artifact; only one that
    claims success must carry a valid payload."""
    try:
        doc = json.loads(text)
    except ValueError as e:
        return [f"not JSON ({e})"]
    payload = _find_bench_payload(doc)
    if payload is None:
        if (isinstance(doc, dict) and "rc" in doc and "parsed" in doc
                and doc.get("parsed") is None and doc.get("rc") != 0):
            return []
        return ["no bench metric object found (neither top-level nor "
                "under 'parsed')"]
    return validate_bench_line(payload)


def validate_jsonl_text(text: str) -> List[str]:
    """Validate a telemetry JSONL payload line by line."""
    errs: List[str] = []
    for ln, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        try:
            ev = json.loads(line)
        except ValueError as e:
            errs.append(f"line {ln}: not JSON ({e})")
            continue
        errs.extend(f"line {ln}: {e}" for e in validate_event(ev))
    return errs
