"""The solve-service daemon: poll -> admit -> pack -> dispatch, exactly
once a job, until drained.

Port of ``pcg_mpi_solver_tpu/serve/daemon.py``.  One
:class:`ServeDaemon` owns one built :class:`~pcg_mpi_solver_tpu_torch.
solver.driver.Solver` (operator partitioned and on its device) and one
spool directory.  The loop:

1. **poll** ``spool/incoming`` (``serve/jobs.py``): validate each spec,
   drop ids the journal already knows (crash remnants, double
   submissions), and pass the rest through admission control
   (``serve/admission.py``: cost-model pricing, bounded queue, shedding);
2. **pack** queued jobs into a block of a standard width
   (``serve/packer.py``) and journal the ``packed`` record;
3. **dispatch** the block through ``Solver.solve_many``: on the card ONE
   lockstep loop whose float32 (mixed) or float64 (direct) matvec is one
   kernel launch over R x P slabs; a column that breaks down is
   quarantined alone (flag 5) while its co-batched jobs finish;
4. **finish** each job: the solution ``.npy`` first, then the result
   file, then the terminal journal record (``done`` / ``failed``): the
   crash ordering that makes replay exactly-once.

**Crash durability.**  Every lifecycle step is an fsync'd journal record
(``serve/journal.py``).  Construction replays the journal: terminal jobs
stay terminal, a dispatched job whose result file survived is completed
from it (``replayed=true``), anything else is queued again with its
original ordinal and deadline.  A SIGKILL loses no job and solves none
twice.

**Faults.**  The ``@job:`` domain of ``resilience/faultinject.py`` fires
at the service boundary by absolute admission ordinal: ``exc@job:k``
fails that job with a named verdict, ``nan@job:k`` poisons its load
column (screened out as ``rhs_nonfinite`` before the block goes to
``solve_many``, whose request check would fail the whole block),
``sleep@job:k`` delays the block.  Replay drops the faults of ordinals
the journal shows as dispatched or terminal, so a restart never fires a
fault a dead daemon consumed.

**No fallback.**  A block whose dispatch raises (a kernel that does not
build or launch, a device lost past the retry guard) fails every job of
the block with ``dispatch_failed: ...``; the daemon never solves it again
anywhere else, on the CPU or otherwise.

**Signals.**  SIGTERM turns admission to draining (new arrivals rejected
``draining``), finishes the queued blocks, writes the ``drain`` record
and the ``serve_drain`` event and returns.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Any, Dict, List, Optional

from pcg_mpi_solver_tpu_torch.serve import jobs as sjobs
from pcg_mpi_solver_tpu_torch.serve.admission import AdmissionController
from pcg_mpi_solver_tpu_torch.serve.journal import (
    JobJournal, next_ordinal, read_journal, replay_jobs)
from pcg_mpi_solver_tpu_torch.serve.packer import (
    STANDARD_WIDTHS, normalize_widths, pack_block)

DEFAULT_QUEUE_MAX = 16
DEFAULT_POLL_S = 0.05


class ServeDaemon:
    """The solve service over one built solver and one spool.

    ``run()`` is the loop; ``poll_once()`` and ``serve_block()`` are its
    single steps.  Construction replays the journal, so building a daemon
    over a crashed spool is the recovery procedure.
    """

    def __init__(self, solver, spool: str, *,
                 queue_max: int = DEFAULT_QUEUE_MAX,
                 widths=STANDARD_WIDTHS,
                 expected_iters: Optional[int] = None,
                 fault_plan=None,
                 poll_s: float = DEFAULT_POLL_S,
                 journal_fsync: Optional[bool] = None):
        self.solver = solver
        self.spool = spool
        sjobs.ensure_spool(spool)
        self._rec = solver.recorder
        self.widths = normalize_widths(widths)
        self.poll_s = float(poll_s)
        self.journal = JobJournal(sjobs.journal_path(spool),
                                  fsync=journal_fsync)
        if fault_plan is None:
            from pcg_mpi_solver_tpu_torch.resilience import FaultPlan

            fault_plan = FaultPlan.from_env(recorder=self._rec)
        self.fault_plan = fault_plan
        if expected_iters is None:
            # a job must be feasible even at the iteration cap
            expected_iters = int(solver.config.solver.max_iter)
        self.admission = AdmissionController(
            queue_max, pricer=solver.predicted_ms_per_iter,
            journal=self.journal, recorder=self._rec,
            expected_iters=expected_iters,
            price_width=max(self.widths),
            on_shed=self._finish_shed)
        self.jobs_done = 0
        self.jobs_failed = 0
        self.blocks = 0
        self._seen: set = set()      # every job id the journal knows
        self._drain_requested = False
        self._replay()

    # -- replay ---------------------------------------------------------
    def _replay(self) -> None:
        """Fold the journal into the queue, the seen set and the fault
        plan: the exactly-once restart (nothing on a fresh spool)."""
        events, truncated = read_journal(self.journal.path)
        states = replay_jobs(events)
        if truncated:
            self._rec.note(f"serve journal: {truncated} torn line(s) "
                           f"skipped (crash artifact)")
        self.admission._next_ordinal = next_ordinal(states)
        plan = self.fault_plan
        for st in sorted(states.values(),
                         key=lambda s: (s["ordinal"] is None,
                                        s["ordinal"] or 0)):
            job = st["job"]
            self._seen.add(job)
            ordinal = st["ordinal"]
            if st["terminal"]:
                # a consumed service-boundary fault must not fire again
                if plan is not None and isinstance(ordinal, int):
                    plan.replay_consume_job(ordinal)
                continue
            if plan is not None and isinstance(ordinal, int) \
                    and "dispatched" in st["ops"]:
                plan.replay_consume_job(ordinal)
            result = sjobs.read_result(self.spool, job)
            if result is not None:
                # killed after the result write, before the terminal
                # record: complete from the result, never solve again
                ok = bool(result.get("ok"))
                verdict = result.get("verdict", "unknown")
                self.journal.record("done" if ok else "failed", job,
                                    verdict=verdict, replayed=True)
                self._rec.event("job_done", job=job, ok=ok,
                                verdict=verdict, replayed=True)
                self._count_finish(ok)
                continue
            if st["spec"] is None or ordinal is None:
                self._finish_failed(
                    {"job": job, "ordinal": -1},
                    "replay_unrecoverable: admitted record incomplete")
                continue
            self.admission.requeue({
                "job": job, "spec": st["spec"], "ordinal": ordinal,
                "deadline_t": st["deadline_t"] or 0.0,
                "admit_t": st["deadline_t"] or 0.0})
        if self.admission.queue:
            self._rec.note(f"serve replay: {len(self.admission.queue)} "
                           f"job(s) re-enqueued from journal")

    # -- admission ------------------------------------------------------
    def poll_once(self, now: Optional[float] = None) -> int:
        """One sweep of the incoming directory; returns the number of jobs
        admitted.  Every file is consumed with a journaled outcome:
        admitted, rejected (named reason) or dropped as a duplicate."""
        admitted = 0
        for path, spec in sjobs.list_incoming(self.spool):
            job = ((spec or {}).get("job")
                   or os.path.basename(path)[:-len(".json")])
            if not isinstance(job, str) or not job:
                job = os.path.basename(path)[:-len(".json")]
            if job in self._seen:
                # the journal knows this id (a consumed submission left
                # by a crash, or a double submit): dropped, not admitted
                self._unlink(path)
                continue
            err = ("bad_spec: unreadable/unparseable file"
                   if spec is None else sjobs.check_spec(spec))
            self._seen.add(job)
            if err:
                self.journal.record("rejected", job, reason=err)
                self._rec.event("job_reject", job=job, reason=err)
                sjobs.write_result(self.spool, job,
                                   {"ok": False,
                                    "verdict": f"rejected: {err}"})
                self._unlink(path)
                continue
            verdict, out = self.admission.admit(spec, now=now)
            if verdict == "admitted":
                admitted += 1
            else:
                sjobs.write_result(self.spool, job,
                                   {"ok": False,
                                    "verdict": f"rejected: {out}"})
            self._unlink(path)
        return admitted

    def _unlink(self, path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass     # consumed by a racing sweep

    # -- dispatch -------------------------------------------------------
    def serve_block(self) -> int:
        """Pack and dispatch ONE block off the queue; returns the number
        of jobs it took (0 when idle)."""
        block = pack_block(self.admission.queue, self.widths)
        if not block:
            return 0
        blk = self.blocks
        self.blocks += 1
        self.journal.record("packed", None, block=blk,
                            jobs=[e["job"] for e in block],
                            ordinals=[e["ordinal"] for e in block],
                            width=len(block))
        self._dispatch_block(block, blk)
        return len(block)

    def _dispatch_block(self, block: List[Dict[str, Any]],
                        blk: int) -> None:
        """One packed block through ``Solver.solve_many``."""
        import numpy as np

        from pcg_mpi_solver_tpu_torch.resilience.faultinject import (
            InjectedDispatchError)
        from pcg_mpi_solver_tpu_torch.solver.pcg import QUARANTINE_FLAG

        t0 = time.monotonic()
        # service-boundary faults, a job at a time by absolute ordinal
        plan, poison, live = self.fault_plan, set(), []
        for e in block:
            if plan is not None and plan.job_armed:
                try:
                    p = plan.at_job(e["ordinal"])
                except InjectedDispatchError as exc:
                    self._finish_failed(e, f"injected: {exc}", block=blk)
                    continue
                if p == "nan":
                    poison.add(e["job"])
            live.append(e)
        # the load block; a bad column fails its own job only
        cols, kept = [], []
        for e in live:
            try:
                col = self._rhs_column(e["spec"])
            except (OSError, ValueError) as exc:
                self._finish_failed(
                    e, f"rhs_load_failed: {type(exc).__name__}: {exc}",
                    block=blk)
                continue
            if e["job"] in poison:
                col = col * np.nan     # the injected poison
            if not np.isfinite(col).all():
                # solve_many's request check fails the WHOLE block on a
                # non-finite column: screened here, so the job with the
                # poison fails alone
                self._rec.event("job_quarantine", job=e["job"],
                                verdict="rhs_nonfinite")
                self._finish_failed(e, "rhs_nonfinite", block=blk)
                continue
            cols.append(col)
            kept.append(e)
        if not kept:
            return
        fb = np.stack(cols, axis=-1)
        self.journal.record("dispatched", None, block=blk,
                            jobs=[e["job"] for e in kept],
                            width=len(kept))
        try:
            res = self.solver.solve_many(fb)
        except Exception as exc:                       # noqa: BLE001
            # the whole block failed (a kernel that does not build or
            # launch, a device lost past the retry guard): every job of
            # it fails by name, and nothing solves it elsewhere
            self._rec.note(f"serve block {blk} dispatch failed: "
                           f"{type(exc).__name__}: {exc}")
            for e in kept:
                self._finish_failed(
                    e, f"dispatch_failed: {type(exc).__name__}: {exc}",
                    block=blk)
            return
        u = self.solver.displacement_global_many(res.x)
        wall = time.monotonic() - t0
        now = time.time()
        for j, e in enumerate(kept):
            flag = int(res.flags[j])
            quarantined = (j in tuple(res.quarantined)
                           or flag == QUARANTINE_FLAG)
            ok = flag == 0
            verdict = ("converged" if ok
                       else "quarantined" if quarantined
                       else f"flag{flag}")
            result = {"ok": ok, "verdict": verdict, "flag": flag,
                      "relres": float(res.relres[j]),
                      "iters": int(res.iters[j]),
                      "block": blk, "width": len(kept),
                      "wall_s": round(wall, 6),
                      "deadline_met": now <= float(e["deadline_t"])}
            # the solution first (a quarantined job gets its
            # min-residual iterate), then the result, then the terminal
            # record: replay's crash ordering
            np.save(sjobs.solution_path(self.spool, e["job"]), u[:, j])
            sjobs.write_result(self.spool, e["job"], result)
            if quarantined:
                self._rec.event("job_quarantine", job=e["job"],
                                verdict=verdict, rhs=j)
            self.journal.record("done" if ok else "failed", e["job"],
                                verdict=verdict, block=blk)
            self._rec.event("job_done", job=e["job"], ok=ok,
                            verdict=verdict)
            self._count_finish(ok)

    def _rhs_column(self, spec: Dict[str, Any]):
        """One (n_dof,) load column of a validated spec: ``scale`` times
        the model's reference load, or an ``rhs`` .npy file."""
        import numpy as np

        n_dof = int(self.solver._model.n_dof)
        if spec.get("rhs"):
            col = np.asarray(np.load(spec["rhs"]), dtype=np.float64)
            col = col.reshape(-1)
            if col.shape[0] != n_dof:
                raise ValueError(
                    f"rhs length {col.shape[0]} != n_dof {n_dof}")
            return col
        return (np.asarray(self.solver._model.F, dtype=np.float64)
                * float(spec["scale"]))

    # -- finishing ------------------------------------------------------
    def _count_finish(self, ok: bool) -> None:
        if ok:
            self.jobs_done += 1
        else:
            self.jobs_failed += 1

    def _finish_failed(self, entry: Dict[str, Any], verdict: str,
                       block: Optional[int] = None) -> None:
        """A failure with a named verdict: the result file first, then the
        journal record and the ``job_done`` event (ok=false)."""
        job = entry["job"]
        sjobs.write_result(self.spool, job,
                           {"ok": False, "verdict": verdict})
        fields = {"verdict": verdict}
        if block is not None:
            fields["block"] = block
        self.journal.record("failed", job, **fields)
        self._rec.event("job_done", job=job, ok=False, verdict=verdict)
        self._count_finish(False)

    def _finish_shed(self, entry: Dict[str, Any], reason: str) -> None:
        """Admission's shed hook: the journal record and ``job_shed`` are
        written; the daemon adds the result file (shed is terminal)."""
        sjobs.write_result(self.spool, entry["job"],
                           {"ok": False, "verdict": f"shed: {reason}"})

    # -- the loop -------------------------------------------------------
    def request_drain(self, *_args) -> None:
        """SIGTERM handler (also callable directly): reject new arrivals
        from now on, finish what is queued, then return from ``run``."""
        self._drain_requested = True
        self.admission.draining = True

    def run(self, max_blocks: Optional[int] = None,
            idle_exit_s: Optional[float] = None,
            install_signals: bool = True) -> str:
        """Serve until drained; returns the drain reason.

        ``max_blocks`` bounds the number of blocks; ``idle_exit_s`` drains
        after that long with an empty queue and an empty incoming
        directory (None serves until SIGTERM); ``install_signals`` wires
        SIGTERM to the drain (off where the daemon does not run on the
        main thread)."""
        if install_signals:
            try:
                signal.signal(signal.SIGTERM, self.request_drain)
            except ValueError:
                self._rec.note("serve: not main thread, SIGTERM "
                               "handler not installed")
        last_work = time.monotonic()
        reason = "drained"
        while True:
            admitted = self.poll_once()
            served = self.serve_block() if self.admission.queue else 0
            if admitted or served:
                last_work = time.monotonic()
            if max_blocks is not None and self.blocks >= max_blocks:
                reason = "max_blocks"
                break
            if served:
                continue
            if self._drain_requested:
                reason = "sigterm"
                break
            if (idle_exit_s is not None
                    and time.monotonic() - last_work >= idle_exit_s):
                reason = "idle"
                break
            time.sleep(self.poll_s)
        # drain: reject late submissions by name, then the drain record
        # inside the still-open serve bracket
        self.admission.draining = True
        self.poll_once()
        if self.admission.queue:
            self._rec.note(
                f"serve drain: {len(self.admission.queue)} admitted "
                f"job(s) left queued (journal replays them on restart)")
        self.journal.drain(reason, jobs_done=self.jobs_done,
                           jobs_failed=self.jobs_failed,
                           jobs_shed=self.admission.shed_count,
                           blocks=self.blocks)
        self._rec.event("serve_drain", reason=reason,
                        jobs_done=self.jobs_done,
                        jobs_failed=self.jobs_failed,
                        jobs_shed=self.admission.shed_count)
        self.journal.close()
        return reason
