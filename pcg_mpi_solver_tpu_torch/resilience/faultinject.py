"""Deterministic fault injection for the resilience subsystem.

Port of ``pcg_mpi_solver_tpu/resilience/faultinject.py``.  Faults fire at
exact, configured positions of the chunked dispatch sequence, so every
recovery path (breakdown ladder, dispatch guard, mid-solve snapshot and
resume) runs reproducibly on the CPU and on the card.

A :class:`FaultPlan` is parsed from a spec string (env ``PCG_TPU_FAULTS``
or passed programmatically, ``Solver.fault_plan = FaultPlan(...)``), with
the JAX package's grammar:

    spec     := term ("," term)*
    term     := mode "@" ["s:" | "col:" | "job:" | "rank:" rank ":"]
                index ["*" count]
    mode     := "kill" | "exc" | "nan" | "inf" | "rho0" | "sleep"
    count    := consecutive firings (default 1; "exc@3*2" also fails the
                first retry of dispatch 3)

Five counter domains fire in the port.  The first two are monotone over
the life of the plan (they keep running across recovery restarts, so a
second fault can be aimed at a later ladder rung):

* the DISPATCH counter advances once per successfully completed Krylov
  dispatch ("exc" fires *before* the dispatch with that index runs);
* the BOUNDARY counter advances once per chunk boundary: after a direct
  chunk, a mixed refinement cycle or a blocked chunk completes and any
  due snapshot is taken ("kill" / "nan" / "inf" / "rho0" / "sleep" fire
  *at* it);
* the COLUMN domain (``col:``, as ``nan@col:2`` or ``rho0@col:0``) is
  indexed by the column of a blocked solve's block
  (``Solver.solve_many`` on its chunked path): the fault fires at the
  next blocked chunk boundary, after any due snapshot, and poisons only
  that column of the carry (``nan`` and ``inf`` its residual, ``rho0``
  its rho), every other column staying bit for bit as it was;
  ``*count`` fires it at that many consecutive boundaries.  The one-shot
  blocked path has no boundary, so a column fault stays pending there.

The STEP domain (``s:``, as ``kill@s:3`` or ``nan@s:5``) is indexed by
the absolute timestep of a time history (``DynamicsSolver.run``,
``NewmarkSolver.run``): it fires after completed timestep N and any due
step snapshot (:meth:`FaultPlan.at_step`, through
``resilience.engine.TimeHistoryGuard``); ``nan`` and ``inf`` poison the
kinematic state ``u``, ``kill`` raises.  The explicit driver ends its
device chunk at the next pending step fault
(:meth:`FaultPlan.next_step_fault`), so the fault's timestep is a host
boundary; a rollback or resume that replays past it does not fire it
again.  The JOB domain (``job:``, as ``exc@job:1`` or ``nan@job:0``) is
indexed by a solve-service job's absolute admission ordinal: the daemon
(``serve/daemon.py``) calls :meth:`FaultPlan.at_job` for each job of a
packed block before it dispatches the block (``sleep`` delays the block,
``nan`` poisons that job's load column, ``exc`` fails that job alone),
and journal replay drops the faults of ordinals a killed daemon already
passed (:meth:`FaultPlan.replay_consume_job`).  The rank
(``rank:``) domain rides the dispatch and boundary counters of one
process: the port runs in one (index 0), so a fault aimed at rank 0 fires
as its unprefixed twin and one aimed at any other rank never lands
(multi-process runs are item 12).

Modes: ``exc`` raises :class:`InjectedDispatchError` (device loss: the
dispatch guard re-dispatches from a snapshot, else the ladder restarts
the step); ``kill`` raises :class:`SimulatedKill` (a ``BaseException``,
so no handler swallows it: only a new process's ``solve(resume=True)``
continues); ``inf`` sets the carry residual's nonzero entries to inf
(flag 2 in direct mode); ``rho0`` zeroes the carry's rho (flag 4);
``nan`` multiplies the residual by NaN (no flag trips: the host-side
NaN-carry detection); ``sleep`` delays the host by ``sleep_s``
(``PCG_TPU_FAULT_SLEEP_S``, default 0.25 s).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

MODES = ("kill", "exc", "nan", "inf", "rho0", "sleep")
_STEP_MODES = ("kill", "nan", "inf")
_COL_MODES = ("nan", "inf", "rho0")
_JOB_MODES = ("exc", "nan", "sleep")

# the port's process index (one process; multi-process is ROADMAP queue 1
# item 12): a rank-domain fault aimed elsewhere stays pending
_PROCESS = 0


class SimulatedKill(BaseException):
    """Simulated process death at a chunk boundary.

    Derives from ``BaseException`` (like ``KeyboardInterrupt``) so no
    recovery handler can catch it: a killed process does not get to run
    its ladder, only a NEW process's ``solve(resume=True)`` does."""


class InjectedDispatchError(RuntimeError):
    """Synthetic device-loss exception (what a dropped device would
    raise); ``resilience.recovery.is_device_loss`` classifies it so."""


def _parse(spec: str):
    """spec string -> ({mode: {index: count}}, {mode: {step: count}},
    {mode: {col: count}}, {mode: {job: count}},
    {mode: {(rank, index): count}}): the dispatch/boundary domains, the
    step domain, the column domain, the job domain and the rank domain."""
    out: Dict[str, Dict[int, int]] = {}
    steps: Dict[str, Dict[int, int]] = {}
    cols: Dict[str, Dict[int, int]] = {}
    jobs: Dict[str, Dict[int, int]] = {}
    ranks: Dict[str, Dict[tuple, int]] = {}
    for term in (t.strip() for t in spec.split(",")):
        if not term:
            continue
        try:
            mode, rest = term.split("@", 1)
            count = 1
            if "*" in rest:
                rest, c = rest.split("*", 1)
                count = int(c)
            rest = rest.strip()
            step_domain = rest.startswith("s:")
            col_domain = rest.startswith("col:")
            job_domain = rest.startswith("job:")
            rank_domain = rest.startswith("rank:")
            rank = None
            if rank_domain:
                bits = rest[len("rank:"):].split(":")
                if len(bits) > 2:
                    raise ValueError(rest)
                rank = int(bits[0])
                idx = int(bits[1]) if len(bits) > 1 else 0
            else:
                idx = int(rest[4:] if col_domain or job_domain
                          else rest[2:] if step_domain else rest)
        except ValueError:
            raise ValueError(
                f"bad fault term {term!r} "
                "(want mode@[s:|col:|job:|rank:R:]index[*count])")
        mode = mode.strip()
        if mode not in MODES:
            raise ValueError(f"unknown fault mode {mode!r} "
                             f"(valid: {', '.join(MODES)})")
        if idx < 0 or count < 1 or (rank is not None and rank < 0):
            raise ValueError(f"bad fault term {term!r}: rank >= 0, "
                             f"index >= 0, count >= 1")
        for domain, valid, name in (
                (step_domain, _STEP_MODES, "step"),
                (col_domain, _COL_MODES, "column"),
                (job_domain, _JOB_MODES, "job")):
            if domain and mode not in valid:
                prefix = {"step": "s", "column": "col"}.get(name, name)
                raise ValueError(
                    f"fault mode {mode!r} has no {name}-domain trigger "
                    f"(valid at {prefix}: indices: {', '.join(valid)})")
        if rank_domain:
            ranks.setdefault(mode, {})[(rank, idx)] = count
        elif step_domain:
            steps.setdefault(mode, {})[idx] = count
        elif col_domain:
            cols.setdefault(mode, {})[idx] = count
        elif job_domain:
            jobs.setdefault(mode, {})[idx] = count
        else:
            out.setdefault(mode, {})[idx] = count
    return out, steps, cols, jobs, ranks


class FaultPlan:
    """One deterministic injection schedule (module docstring).

    Stateful and single-use: counters and remaining fire-counts advance
    as the solve runs, so a plan describes one process lifetime, like
    the failures it simulates."""

    def __init__(self, spec: str, recorder=None):
        (self._faults, self._step_faults, self._col_faults,
         self._job_faults, self._rank_faults) = _parse(spec)
        self.recorder = recorder
        self.dispatches = 0         # completed Krylov dispatches
        self.boundaries = 0         # completed chunk boundaries
        self.fired: List[dict] = []  # (mode, point, index) audit trail
        try:
            self.sleep_s = float(
                os.environ.get("PCG_TPU_FAULT_SLEEP_S", 0.25))
        except ValueError:
            self.sleep_s = 0.25

    @classmethod
    def from_env(cls, recorder=None) -> Optional["FaultPlan"]:
        """Plan from ``PCG_TPU_FAULTS``; None when unset or empty."""
        spec = os.environ.get("PCG_TPU_FAULTS", "").strip()
        return cls(spec, recorder=recorder) if spec else None

    @property
    def armed(self) -> bool:
        """Any fault of any domain still pending."""
        return any(any(d.values()) for d in (
            self._faults, self._step_faults, self._col_faults,
            self._job_faults, self._rank_faults))

    @property
    def col_armed(self) -> bool:
        """Any column-domain fault still pending."""
        return any(self._col_faults.values())

    @property
    def step_armed(self) -> bool:
        """Any step-domain fault still pending."""
        return any(self._step_faults.values())

    @property
    def job_armed(self) -> bool:
        """Any job-domain (service-boundary) fault still pending."""
        return any(self._job_faults.values())

    def next_step_fault(self, after: int) -> Optional[int]:
        """Smallest pending step-domain index > ``after``, or None: the
        explicit time loop ends its device chunk there, so the fault's
        timestep is a host boundary."""
        pending = [i for m in self._step_faults.values() for i in m
                   if i > after]
        return min(pending) if pending else None

    def _take(self, mode: str, idx: int) -> bool:
        pending = self._faults.get(mode, {})
        if pending.get(idx, 0) <= 0:
            return False
        pending[idx] -= 1
        if pending[idx] <= 0:
            del pending[idx]
        return True

    def _take_rank(self, mode: str, idx: int) -> bool:
        """Consume a rank-domain fault of ``mode`` at counter position
        ``idx`` aimed at this process (index 0 of 1)."""
        pending = self._rank_faults.get(mode, {})
        key = (_PROCESS, idx)
        if pending.get(key, 0) <= 0:
            return False
        pending[key] -= 1
        if pending[key] <= 0:
            del pending[key]
        return True

    def _fire(self, mode: str, point: str, idx: int) -> None:
        self.fired.append({"mode": mode, "point": point, "at": idx})
        if self.recorder is not None:
            self.recorder.event("fault", mode=mode, point=point, at=idx)

    # -- engine hooks ---------------------------------------------------
    def on_dispatch(self) -> None:
        """Called immediately before a Krylov dispatch.  May raise
        :class:`InjectedDispatchError` (the count is consumed, so a
        guarded retry of the same dispatch succeeds unless the spec asked
        for consecutive failures with ``*count``)."""
        idx = self.dispatches
        if self._take("exc", idx):
            self._fire("exc", "dispatch", idx)
            raise InjectedDispatchError(
                f"injected device loss before dispatch {idx} "
                "(PCG_TPU_FAULTS)")
        if self._take_rank("exc", idx):
            self._fire("exc", "rank-dispatch", idx)
            raise InjectedDispatchError(
                f"injected device loss before dispatch {idx} on this "
                "process (PCG_TPU_FAULTS rank domain)")

    def on_dispatch_done(self) -> None:
        """Called after a dispatch completes successfully."""
        self.dispatches += 1

    def at_boundary(self, carry: dict, blocked: bool = False) -> dict:
        """Called at a chunk boundary AFTER any snapshot was taken (the
        snapshot holds the clean state; corruption happens to the live
        carry).  Returns the (possibly poisoned) carry, whose poisoned
        leaves are new tensors; may raise :class:`SimulatedKill`.  A
        poison mode whose target leaf is absent (``rho0`` on the mixed
        outer state, which has no rho) is neither consumed nor recorded:
        a drill must never read "exercised" off a fault that could not
        land.  ``blocked`` marks a blocked solve's boundary, where the
        pending column faults fire too (a column past the block's width
        cannot land, and stays pending)."""
        idx = self.boundaries
        self.boundaries += 1
        if self._take("sleep", idx):
            # a straggler: fires before any poison or kill here
            self._fire("sleep", "boundary", idx)
            time.sleep(self.sleep_s)
        if self._take_rank("sleep", idx):
            self._fire("sleep", "rank-boundary", idx)
            time.sleep(self.sleep_s)
        for mode, leaf in (("nan", "r"), ("inf", "r"), ("rho0", "rho")):
            if leaf in carry and self._take(mode, idx):
                self._fire(mode, "boundary", idx)
                carry = _poison(carry, mode)
            if leaf in carry and self._take_rank(mode, idx):
                self._fire(mode, "rank-boundary", idx)
                carry = _poison(carry, mode)
        if blocked:
            width = int(np.asarray(carry["flag"]).shape[0]) \
                if "flag" in carry else 0
            for mode, leaf in (("nan", "r"), ("inf", "r"),
                               ("rho0", "rho")):
                for col in sorted(self._col_faults.get(mode, {})):
                    if col < width and leaf in carry \
                            and self._take_col(mode, col):
                        self._fire(mode, "col", col)
                        carry = _poison_col(carry, mode, col)
        if self._take("kill", idx):
            self._fire("kill", "boundary", idx)
            raise SimulatedKill(
                f"injected kill at chunk boundary {idx} (PCG_TPU_FAULTS)")
        if self._take_rank("kill", idx):
            self._fire("kill", "rank-boundary", idx)
            raise SimulatedKill(
                f"injected kill at chunk boundary {idx} on this process "
                "(PCG_TPU_FAULTS rank domain)")
        return carry

    def _take_step(self, mode: str, t: int) -> bool:
        pending = self._step_faults.get(mode, {})
        if pending.get(t, 0) <= 0:
            return False
        pending[t] -= 1
        if pending[t] <= 0:
            del pending[t]
        return True

    def at_step(self, t: int, state: dict) -> dict:
        """Called after completed timestep ``t`` of a time history, AFTER
        any due step snapshot (the snapshot holds the clean state; the
        poison lands on the live run).  ``nan`` and ``inf`` poison the
        kinematic leaf ``u`` into a new tensor; ``kill`` raises
        :class:`SimulatedKill` last, so a poison and a kill at one step
        leave the clean snapshot behind.  Indexed by the ABSOLUTE
        timestep: a rollback or resume that replays past ``t`` does not
        fire a consumed fault again."""
        for mode in ("nan", "inf"):
            if "u" in state and self._take_step(mode, t):
                self._fire(mode, "step", t)
                state = _poison(state, mode, leaf="u")
        if self._take_step("kill", t):
            self._fire("kill", "step", t)
            raise SimulatedKill(
                f"injected kill at timestep {t} (PCG_TPU_FAULTS)")
        return state

    def _take_col(self, mode: str, col: int) -> bool:
        pending = self._col_faults.get(mode, {})
        if pending.get(col, 0) <= 0:
            return False
        pending[col] -= 1
        if pending[col] <= 0:
            del pending[col]
        return True


    def _take_job(self, mode: str, job: int) -> bool:
        pending = self._job_faults.get(mode, {})
        if pending.get(job, 0) <= 0:
            return False
        pending[job] -= 1
        if pending[job] <= 0:
            del pending[job]
        return True

    def at_job(self, ordinal: int) -> Optional[str]:
        """Called by the solve service before it dispatches the block that
        holds the job of absolute admission ordinal ``ordinal``.  Fires
        straggler first, as :meth:`at_boundary` does: ``sleep`` delays the
        host (the whole block arrives late: the window a SIGKILL drill
        fires inside), then ``nan`` returns ``"nan"`` (the caller poisons
        that job's load column), then ``exc`` raises
        :class:`InjectedDispatchError` (the job fails by name, its
        co-batched jobs dispatch).  An ordinal never admitted never reaches
        this hook."""
        poison = None
        if self._take_job("sleep", ordinal):
            self._fire("sleep", "job", ordinal)
            time.sleep(self.sleep_s)
        if self._take_job("nan", ordinal):
            self._fire("nan", "job", ordinal)
            poison = "nan"
        if self._take_job("exc", ordinal):
            self._fire("exc", "job", ordinal)
            raise InjectedDispatchError(
                f"injected service-boundary failure for job ordinal "
                f"{ordinal} (PCG_TPU_FAULTS job domain)")
        return poison

    def replay_consume_job(self, ordinal: int) -> None:
        """Journal replay: drop every pending job-domain fault aimed at
        ``ordinal`` without firing or recording it.  A restarted daemon
        parses ``PCG_TPU_FAULTS`` into a fresh plan, but the journal shows
        that ordinal already passed the service boundary (a ``dispatched``
        or terminal record): the dead process consumed its fault, and an
        absolutely indexed fault never fires twice."""
        for pending in self._job_faults.values():
            pending.pop(ordinal, None)


def _poison(carry: dict, mode: str, leaf: str = "r") -> dict:
    """Corrupt a carry dict into a new dict with new leaves (the input's
    tensors are never written in place): ``rho0`` zeroes the host scalar
    ``rho``, ``nan`` multiplies ``leaf`` by NaN, ``inf`` sets its nonzero
    entries to inf (constrained dofs stay exactly 0, so the inf lands
    where the preconditioner inverse is > 0).  ``leaf`` is the Krylov
    residual ``r`` at chunk boundaries, the kinematic state ``u`` at
    timestep boundaries."""
    out = dict(carry)
    if mode == "rho0":
        if "rho" in out:
            out["rho"] = np.zeros_like(np.asarray(out["rho"]))[()]
        return out
    r = out.get(leaf)
    if r is None:
        return out
    if mode == "nan":
        out[leaf] = r * float("nan")
    elif mode == "inf":
        out[leaf] = torch.where(r != 0, torch.full_like(r, float("inf")), r)
    return out


def _poison_col(carry: dict, mode: str, col: int) -> dict:
    """Column-domain poisoner of a blocked carry ((R, P, n_loc) vectors,
    (R,) host scalars): corrupt only column ``col`` into new leaves, the
    other columns copied bit for bit.  ``rho0`` zeroes the column's rho,
    ``nan`` multiplies its residual by NaN, ``inf`` sets its residual's
    nonzero entries to inf."""
    out = dict(carry)
    if mode == "rho0":
        rho = np.array(out["rho"])
        rho[col] = 0
        out["rho"] = rho
        return out
    r = out["r"].clone()
    if mode == "nan":
        r[col] = r[col] * float("nan")
    elif mode == "inf":
        r[col] = torch.where(r[col] != 0,
                             torch.full_like(r[col], float("inf")), r[col])
    out["r"] = r
    return out
