"""The recovery ladders around a chunked solve.

Port of ``pcg_mpi_solver_tpu/resilience/engine.py`` (:class:`RecoveryHooks`
and :func:`run_with_recovery` for a single right-hand side;
:class:`ManyRecoveryHooks`, :func:`_upgrade_many_carry` and
:func:`run_many_with_recovery`, its blocked twin with one ladder a column;
:func:`kinematic_state_io` and :class:`TimeHistoryGuard`, the timestep
snapshots, step faults and NaN rollback of the time-history drivers
``solver/dynamics.py`` and ``solver/newmark.py``).  Across processes
the ladder's triggers are group-agreed (``parallel/consensus.py``), so
every rank takes the same branch; with one process the agreement is the
identity.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from pcg_mpi_solver_tpu_torch.parallel.consensus import (
    agree_trigger, agree_triggers)
from pcg_mpi_solver_tpu_torch.resilience.recovery import (
    RecoveryLadder, breakdown_trigger, column_trigger, is_device_loss)


@dataclasses.dataclass
class RecoveryHooks:
    """Driver-supplied recovery pieces for :func:`run_with_recovery`.

    ``restart(x) -> (carry, normr)``: a cold Krylov carry at the ladder's
    restart iterate.  ``cold_restart() -> (carry, normr, prec)``: the
    step's cold start state after a device loss (the in-flight carry may
    be gone with the failed dispatch); the returned prec replaces the
    original when the loop was still using it.  ``fallback_prec() ->
    prec``: the weaker-but-safer preconditioner (rung 2).
    ``escalation() -> (engine, data, prec)``: the direct-f64 engine
    (rung 3, mixed mode)."""

    restart: Callable[[Any], Tuple[Any, Any]]
    cold_restart: Optional[Callable[[], Tuple[Any, Any, Any]]] = None
    fallback_prec: Optional[Callable[[], Any]] = None
    escalation: Optional[Callable[[], Tuple[Any, Any, Any]]] = None


def run_with_recovery(engine, data, fext, carry, normr0, n2b, prec, *,
                      scfg, mixed: bool, recorder, hooks: RecoveryHooks,
                      resilience=None, total0: int = 0):
    """Run a chunked solve to termination through the bounded recovery
    ladder: when the budget loop ends on a flag-2/4/6 breakdown, a
    NaN/Inf carry or a device-loss exception, restart from the engine's
    tracked min-residual iterate (plain restart -> fallback
    preconditioner -> f64 escalation) instead of reporting the failure.
    ``scfg.max_iter`` spans all attempts; ``scfg.max_recoveries`` bounds
    them (0: report and stop).  Returns ``(engine_used, x_fin, flag,
    relres, total)``."""
    rec = recorder
    note = rec.note if rec is not None else (lambda s: None)
    comm = getattr(resilience, "comm", None)
    eng, eng_data, eng_prec = engine, data, prec
    ladder = None
    total = int(total0)
    while True:
        err = None
        try:
            x_fin, flag, relres, total = eng.run(
                eng_data, fext, carry, normr0, n2b, eng_prec,
                vlog=note, resilience=resilience, total0=total)
            trigger = breakdown_trigger(flag, relres)
            restart_x = eng.restart_x
        except Exception as e:          # noqa: BLE001 — classified below
            # the engine's guard already retried from the snapshot;
            # reaching here means its budget is spent or there was no
            # snapshot to re-dispatch from
            if scfg.max_recoveries <= 0 or not is_device_loss(e):
                raise
            trigger, restart_x, err = "device_loss", None, e
        # group consensus: every rank takes the SAME ladder branch (a
        # divergent branch pairs a live collective against a missing
        # one): the max-reduce of the encoded triggers lets one rank's
        # breakdown drive every rank's ladder
        trigger = agree_trigger(comm, trigger)
        if trigger == "device_loss" and err is None:
            # another rank lost its device: only the cold start state is
            # the same on every rank
            restart_x = None
        if trigger is None:
            break
        if ladder is None:
            ladder = RecoveryLadder(
                precond=scfg.precond, mixed=mixed,
                max_recoveries=scfg.max_recoveries, recorder=rec)
        action = ladder.next_action(trigger)
        if action is None:              # recovery budget spent
            if err is not None:
                raise err
            if trigger == "device_loss":
                # agreed loss seen on another rank: returning normally
                # while that rank raises would split the group
                raise RuntimeError(
                    "group-agreed device loss with the recovery budget "
                    f"spent ({ladder.attempt} attempts); the failing "
                    "rank carries the original error")
            note(f"recovery budget exhausted ({ladder.attempt} "
                 f"attempts); reporting flag={flag} relres={relres:.3e}")
            break
        note(f"recovery attempt {ladder.attempt}/{scfg.max_recoveries}: "
             f"{action} after {trigger} (total={total})")
        if action == "fallback_prec" and hooks.fallback_prec is not None:
            eng_prec = hooks.fallback_prec()
        elif action == "escalate_f64" and hooks.escalation is not None:
            eng, eng_data, eng_prec = hooks.escalation()
        if restart_x is None:
            # device loss: rebuild the step's cold start state
            if hooks.cold_restart is None:
                raise err if err is not None else RuntimeError(
                    "device_loss recovery without a cold_restart hook")
            carry, normr0, prec0 = hooks.cold_restart()
            if eng_prec is prec:
                eng_prec = prec0
            prec = prec0
        else:
            # a cold Krylov carry at the best iterate seen
            carry, normr0 = hooks.restart(restart_x)
    if ladder is not None and ladder.attempt and rec is not None:
        rec.event("recovery_done", flag=flag, relres=relres,
                  attempts=ladder.attempt,
                  actions=list(ladder.actions_taken))
    return eng, x_fin, flag, relres, total


# ----------------------------------------------------------------------
# Per-column recovery of a blocked (multi right-hand side) solve
# ----------------------------------------------------------------------

@dataclasses.dataclass
class ManyRecoveryHooks:
    """Driver-supplied pieces of a blocked chunked solve for
    :func:`run_many_with_recovery`.

    ``cycle(carry, budget) -> (x, carry)``: one capped resumable blocked
    call (``budget``: the iterations left).  ``recover(carry,
    restart_mask, fallback_mask, quarantine_mask) -> carry``: the masked
    per-column surgery (``solver/pcg.restart_carry_many``).
    ``has_fallback``: whether the cycle carries the scalar-Jacobi
    fallback operand; without it the ladder's fallback rung repeats the
    plain restart."""

    cycle: Callable[[Any, int], Tuple[Any, Any]]
    recover: Callable[[Any, Any, Any, Any], Any]
    has_fallback: bool = False


def _upgrade_many_carry(carry: Dict[str, Any], nrhs: int,
                        lagged: bool) -> Dict[str, Any]:
    """A blocked carry from a snapshot written before the per-column
    recovery state existed, with its ``prec_sel`` (and a recurrence
    variant's ``drift``) at their cold values, zeros, so it resumes."""
    carry = dict(carry)
    carry.setdefault("prec_sel", np.zeros(nrhs, np.int64))
    if lagged:
        carry.setdefault("drift", np.zeros(nrhs, np.int64))
    return carry


def run_many_with_recovery(carry, *, scfg, nrhs: int, hooks, recorder,
                           resilience=None, resume: bool = False,
                           lagged: bool = False, total0: int = 0,
                           iters_cols0=None):
    """Run a blocked chunked solve to termination with the columns'
    faults kept apart (JAX ``resilience/engine.py:214-416``).

    After each capped call every running column is classified
    (:func:`~pcg_mpi_solver_tpu_torch.resilience.recovery.column_trigger`):
    a flag-2/4/6 breakdown or a NaN/Inf carry spends one attempt of that
    column's own :class:`RecoveryLadder` (restart from its min-residual
    iterate, then the scalar-Jacobi fallback) while the other columns run
    on bit for bit; a column whose budget is spent (or absent,
    ``scfg.max_recoveries <= 0``) is quarantined: ``QUARANTINE_FLAG``,
    one ``rhs_quarantine`` event, and the block completes.  The dispatch
    guard, the ``many_*.npz`` snapshots, the resume and the faults thread
    through ``resilience`` (``ResilienceContext``) as on the scalar path;
    column faults (``mode@col:k``) land at the chunk boundaries.

    Returns ``(x, carry, flags, total, iters_cols, quarantined,
    recoveries, drift_cols)``."""
    from pcg_mpi_solver_tpu_torch.solver.pcg import QUARANTINE_FLAG

    rec = recorder
    note = rec.note if rec is not None else (lambda s: None)
    R = int(nrhs)
    total = int(total0)
    iters_cols = (np.zeros(R, np.int64) if iters_cols0 is None
                  else np.asarray(iters_cols0, np.int64).copy())
    faults = resilience.faults if resilience is not None else None
    max_iter = int(scfg.max_iter)
    ladders: Dict[int, RecoveryLadder] = {}
    actions_taken: list = []

    def restore(st):
        """Snapshot state -> (carry, total, iters_cols)."""
        c = resilience.restore_device(
            {"carry": _upgrade_many_carry(st["carry"], R, lagged)})["carry"]
        return (c, int(np.asarray(st["total"])),
                np.asarray(st["iters_cols"], np.int64).copy())

    st = resilience.load_resume_state() if resilience is not None else None
    if st is not None and str(np.asarray(st.get("kind", ""))) == "many":
        carry, total, iters_cols = restore(st)
        note(f"resumed blocked solve (nrhs={R}) at {total} iterations")
    elif resume:
        note(f"solve_many resume requested but no usable blocked "
             f"snapshot found (nrhs={R}); starting cold")

    flags = np.asarray(carry["flag"])
    quarantined = {k for k in range(R) if flags[k] == QUARANTINE_FLAG}
    # drift accumulates per call: a ladder restart zeroes the carry's
    # drift leaf, so reading it once at the end would miss the drift that
    # triggered the restart
    drift_cols = np.zeros(R, np.int64)
    drift_prev = np.zeros(R, np.int64)
    x_fin = carry["x"]
    while np.any(flags == 1) and total < max_iter:
        if resilience is not None:
            resilience.sync_boundary()
        try:
            if faults is not None:
                faults.on_dispatch()
            x_fin, carry = hooks.cycle(carry, max_iter - total)
            execv = np.asarray(carry["exec"])
            flags = np.asarray(carry["flag"])
            normr = np.asarray(carry["normr_act"], dtype=np.float64)
        except Exception as e:          # noqa: BLE001 — classified below
            st = (resilience.handle_dispatch_failure(e, "many")
                  if resilience is not None else None)
            if st is None:
                raise
            # re-dispatch from the snapshot; a column quarantined after
            # it is classified again from the restored carry
            carry, total, iters_cols = restore(st)
            flags = np.asarray(carry["flag"])
            quarantined = {k for k in range(R)
                           if flags[k] == QUARANTINE_FLAG}
            if lagged and "drift" in carry:
                drift_prev = np.asarray(carry["drift"], dtype=np.int64)
            continue
        if faults is not None:
            faults.on_dispatch_done()
        iters_cols += execv.astype(np.int64)
        total += int(execv.max()) if execv.size else 0
        if lagged and "drift" in carry:
            cur = np.asarray(carry["drift"], dtype=np.int64)
            drift_cols += np.maximum(cur - drift_prev, 0)
            drift_prev = cur

        triggers = {}
        for k in range(R):
            if k in quarantined:
                continue
            t = column_trigger(int(flags[k]), float(normr[k]))
            if t is not None:
                triggers[k] = t
        # group consensus: one packed max-reduce, so every rank drives
        # the same per-column ladders
        comm = getattr(resilience, "comm", None)
        if comm is not None and getattr(comm, "n_procs", 1) > 1:
            triggers = {k: t
                        for k, t in agree_triggers(comm, triggers,
                                                   R).items()
                        if k not in quarantined}
        if triggers:
            restart_m = np.zeros(R, bool)
            fb_m = np.zeros(R, bool)
            quar_m = np.zeros(R, bool)
            for k, trig in sorted(triggers.items()):
                lad = ladders.get(k)
                if lad is None and scfg.max_recoveries > 0:
                    # the fallback rung only where the cycle carries the
                    # fallback operand (else it would announce a
                    # fallback_prec that is a second plain restart)
                    lad = ladders[k] = RecoveryLadder(
                        precond=(scfg.precond if hooks.has_fallback
                                 else "jacobi"), mixed=False,
                        max_recoveries=scfg.max_recoveries,
                        recorder=rec, extra={"rhs": k})
                action = lad.next_action(trig) if lad is not None else None
                if action is None:
                    quar_m[k] = True
                    quarantined.add(k)
                    if rec is not None:
                        rec.event("rhs_quarantine", rhs=k, trigger=trig,
                                  flag=QUARANTINE_FLAG,
                                  attempts=lad.attempt if lad else 0)
                        rec.inc("resilience.rhs_quarantine")
                    note(f"solve_many: column {k} quarantined "
                         f"({trig}, attempts="
                         f"{lad.attempt if lad else 0})")
                else:
                    actions_taken.append(action)
                    restart_m[k] = True
                    if action == "fallback_prec" and hooks.has_fallback:
                        fb_m[k] = True
                    note(f"solve_many recovery: column {k} {action} "
                         f"after {trig} (total={total})")
            carry = hooks.recover(carry, restart_m, fb_m, quar_m)
            flags = np.asarray(carry["flag"])
            if lagged and "drift" in carry:
                # restarted columns come back with a zeroed drift leaf
                drift_prev = np.asarray(carry["drift"], dtype=np.int64)
        if not np.any(flags == 1):
            break
        if resilience is not None:
            resilience.after_chunk(lambda: dict(
                kind="many", total=total, iters_cols=iters_cols,
                carry=carry))
            if faults is not None:
                carry = faults.at_boundary(carry, blocked=True)
    recoveries = sum(lad.attempt for lad in ladders.values())
    if recoveries and rec is not None:
        rec.event("recovery_done", flag=[int(v) for v in flags],
                  relres=None, attempts=recoveries,
                  actions=actions_taken)
    if rec is not None and int(drift_cols.sum()) > 0:
        rec.event("resid_drift", drift=int(drift_cols.sum()),
                  cols=[int(v) for v in drift_cols])
        rec.gauge("resid.drift", int(drift_cols.sum()))
    return (x_fin, carry, flags, total, iters_cols,
            sorted(quarantined), recoveries, drift_cols)


# ----------------------------------------------------------------------
# Snapshot state transfer and the timestep-granular harness
# ----------------------------------------------------------------------

def kinematic_state_io(device, dtype: torch.dtype, device_keys,
                       mesh=None):
    """``(fetch, put)`` closures for a flat state dict whose
    ``device_keys`` leaves are (n_parts, n_loc) tensors on ``device`` (the
    kinematic state) and whose other leaves are host numpy (histories,
    counters, schedules).  ``fetch`` copies the tensors to host numpy;
    ``put`` uploads them to ``device`` in ``dtype``, bitwise, and passes
    the host leaves through.  Across processes (``mesh``) ``fetch``
    gathers every rank's rows (a collective) and ``put`` uploads this
    rank's."""
    from pcg_mpi_solver_tpu_torch.parallel.distributed import (
        fetch_global, put_sharded)

    device_keys = frozenset(device_keys)

    def fetch(state: Dict[str, Any]) -> Dict[str, Any]:
        return {k: (fetch_global(v, mesh) if k in device_keys
                    else np.asarray(v))
                for k, v in state.items()}

    def put(state: Dict[str, Any]) -> Dict[str, Any]:
        return {k: (put_sharded(np.array(v), mesh, dtype=dtype,
                                device=device)
                    if k in device_keys else v)
                for k, v in state.items()}

    return fetch, put


class TimeHistoryGuard:
    """Resilience harness of the time-history drivers (explicit
    ``solver/dynamics.py`` and implicit ``solver/newmark.py``), driven by
    their host time loops:

    * :meth:`load_resume` restores the newest step snapshot
      (``step_*.npz`` under the checkpoint directory), so ``resume=True``
      continues mid-history with bit-identical histories;
    * :meth:`boundary`, after each completed timestep, snapshots the full
      state at cadence (the clean state first), then lets step faults fire
      (``kill`` raises after the snapshot, as a real preemption would;
      poisons corrupt the live state the snapshot just protected);
    * :meth:`rollback` answers a non-finite state found after a step with
      the last good snapshot (from memory, no disk round trip), within
      ``max_recoveries`` like the Krylov ladder.
    """

    def __init__(self, *, store=None, snapshot_every: int = 0,
                 fetch_state=None, put_state=None, recorder=None,
                 faults=None, max_recoveries: int = 0):
        self.store = store
        self.snapshot_every = int(snapshot_every)
        self.fetch_state = fetch_state or (lambda s: s)
        self.put_state = put_state or (lambda s: s)
        self.recorder = recorder
        self.faults = faults
        self.max_recoveries = int(max_recoveries)
        self.recoveries = 0
        self._mem: Optional[Tuple[int, Dict[str, Any]]] = None

    def load_resume(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        """The newest persisted step snapshot as ``(t, device_state)``, or
        None when there is none.  Its host copy is the first rollback
        point."""
        if self.store is None:
            return None
        t = self.store.latest()
        if t is None:
            return None
        state = self.store.load(t)
        if state is None:
            return None
        self._mem = (t, state)
        if self.recorder is not None:
            self.recorder.event("step_snapshot", op="restore", step=t)
            self.recorder.inc("resilience.step_snapshot.restore")
        return t, self.put_state(state)

    def boundary(self, t: int, state_fn: Callable[[], Dict[str, Any]]) \
            -> Optional[Dict[str, Any]]:
        """After completed timestep ``t``: ``state_fn`` builds the full
        device state lazily (nothing is built when snapshots and faults
        are idle).  Returns the possibly poisoned state the caller must
        continue with, or None when untouched."""
        state = None
        if self.snapshot_every > 0 and t % self.snapshot_every == 0:
            state = state_fn()
            host = self.fetch_state(state)
            self._mem = (t, host)
            if self.store is not None:
                self.store.save(t, host)
                if self.recorder is not None:
                    self.recorder.event("step_snapshot", op="save", step=t)
                    self.recorder.inc("resilience.step_snapshot.save")
        if self.faults is not None and self.faults.step_armed:
            if state is None:
                state = state_fn()
            state = self.faults.at_step(t, state)
        return state

    def rollback(self, t: int) -> Tuple[int, Dict[str, Any]]:
        """A non-finite state after timestep ``t``: the state to roll back
        to as ``(t0, device_state)``.  Spends one recovery; raises
        :class:`FloatingPointError` when there is no snapshot or the
        budget is spent (an honest failure beats looping on a
        deterministic instability)."""
        if self._mem is None or self.recoveries >= self.max_recoveries:
            raise FloatingPointError(
                f"non-finite state after timestep {t} and no rollback "
                f"available (snapshot={'yes' if self._mem else 'no'}, "
                f"recoveries={self.recoveries}/{self.max_recoveries}); "
                "for explicit dynamics check dt against stable_dt()")
        self.recoveries += 1
        t0, host = self._mem
        if self.recorder is not None:
            self.recorder.event("recovery", action="rollback",
                                attempt=self.recoveries,
                                trigger="nan_carry", step=t, to_step=t0)
            self.recorder.inc("resilience.recovery.rollback")
        return t0, self.put_state(host)
