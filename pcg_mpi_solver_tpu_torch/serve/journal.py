"""Crash-durable job journal: the exactly-once backbone of the solve
service.

Port of ``pcg_mpi_solver_tpu/serve/journal.py``, with its schema tag and
op names: a journal written by either package replays under the other.
Every record is an fsync'd ``kind="flight"`` telemetry event of the
port's flight recorder (``obs/flight.py``), so a SIGKILL loses at most
the record being written, every JSONL reader (``summary``, ``watch``)
reads the journal, and the daemon's heartbeats come from the recorder's
open ``serve`` bracket.  A job record adds ``op`` (the lifecycle step),
``job`` (the id) and ``journal`` (this module's schema tag).

Lifecycle ops (:data:`JOB_OPS`)::

    admitted --> packed --> dispatched --> done
        \\                               \\-> failed
         \\-> shed          (queue backpressure, named reason)
    rejected                (never admitted, named reason)

The ``admitted`` record carries the whole spec and the absolute
admission ordinal, so replay needs nothing but the journal: a job whose
newest op is not terminal is queued again with its original ordinal and
deadline; a job whose result file exists but whose terminal record was
lost to the kill is completed from the result (``replayed=true``), never
solved again.

Imports neither torch nor numpy.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from pcg_mpi_solver_tpu_torch.obs.flight import (
    FlightRecorder, read_jsonl_tolerant)

#: The journal's schema tag on every job record (the suffix changes only
#: on a breaking change; added fields keep it).
SERVE_JOURNAL_SCHEMA = "pcg-tpu-serve-journal/1"

#: Job lifecycle ops, in bracket order.
JOB_OPS = ("admitted", "packed", "dispatched", "done", "failed",
           "rejected", "shed")

#: Ops after which a job never runs (again).
TERMINAL_OPS = ("done", "failed", "rejected", "shed")

#: The daemon's graceful-drain record (SIGTERM, idle exit).
DRAIN_OP = "drain"


class JobJournal:
    """Append-only job journal, one fsync a record, over one
    :class:`~pcg_mpi_solver_tpu_torch.obs.flight.FlightRecorder`.

    Opening the journal opens a ``serve`` flight bracket, so heartbeats
    flow while the daemon lives and ``watch`` sees a dead daemon as a
    stall.  A SIGKILL leaves the bracket open (the ``died`` verdict);
    :meth:`close` after a drain closes it, the :data:`DRAIN_OP` record
    written first.
    """

    def __init__(self, path: str, fsync: Optional[bool] = None):
        self.path = path
        self._fl = FlightRecorder(
            path, meta={"component": "serve",
                        "journal": SERVE_JOURNAL_SCHEMA},
            fsync=fsync)
        self._seq = self._fl.begin("serve")

    def record(self, op: str, job: Optional[str] = None,
               **fields) -> Dict[str, Any]:
        """Write ONE durable journal record (flushed and fsync'd before
        the call returns: the crash ordering replay depends on)."""
        if job is not None:
            fields["job"] = job
        return self._fl.emit(op, journal=SERVE_JOURNAL_SCHEMA, **fields)

    def drain(self, reason: str, **fields) -> None:
        """The graceful-drain record, inside the ``serve`` bracket (so
        fsync'd before the bracket closes)."""
        self.record(DRAIN_OP, reason=reason, **fields)

    def close(self) -> None:
        self._fl.end(self._seq, "serve")
        self._fl.close()


def read_journal(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """``(events, truncated_count)`` of a journal file.  A SIGKILLed
    daemon's journal may end in a line cut mid-object: skipped and
    counted, never raised on."""
    return read_jsonl_tolerant(path)


def replay_jobs(events: List[Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
    """Fold journal events into each job's final state.

    ``{job_id: state}``, where ``state`` holds ``op`` (the newest op),
    ``ops`` (every op, in order), ``spec`` / ``ordinal`` / ``deadline_t``
    (from the ``admitted`` record), ``terminal`` and ``verdict``.
    Records that are not job records, unknown ops and jobs of an earlier
    daemon fold in order."""
    jobs: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        op = ev.get("op")
        job = ev.get("job")
        if op not in JOB_OPS or not isinstance(job, str):
            continue
        st = jobs.setdefault(job, {"job": job, "ops": [], "op": None,
                                   "spec": None, "ordinal": None,
                                   "deadline_t": None, "terminal": False,
                                   "verdict": None})
        st["ops"].append(op)
        st["op"] = op
        if op == "admitted":
            st["spec"] = ev.get("spec")
            if isinstance(ev.get("ordinal"), int):
                st["ordinal"] = ev["ordinal"]
            if isinstance(ev.get("deadline_t"), (int, float)):
                st["deadline_t"] = float(ev["deadline_t"])
        if op in TERMINAL_OPS:
            st["terminal"] = True
            st["verdict"] = ev.get("verdict", ev.get("reason"))
    return jobs


def next_ordinal(jobs: Dict[str, Dict[str, Any]]) -> int:
    """The next absolute admission ordinal.  Ordinals never restart
    across daemons (the ``@job:`` faults and replay index by them), so a
    new daemon continues the journal's numbering."""
    taken = [st["ordinal"] for st in jobs.values()
             if isinstance(st.get("ordinal"), int)]
    return max(taken) + 1 if taken else 0
