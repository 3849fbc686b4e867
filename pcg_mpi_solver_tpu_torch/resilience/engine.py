"""The recovery ladder around a chunked solve.

Port of ``pcg_mpi_solver_tpu/resilience/engine.py:42-162``
(:class:`RecoveryHooks`, :func:`run_with_recovery`).  The blocked twin
(``run_many_with_recovery``), the time-history guard and the kinematic
state transfers wait for the blocked chunked path and the dynamics
drivers (ROADMAP queue 1 items 9 and 10).  The group consensus of a
multi-process run (every rank takes the same ladder branch) is the
identity in the port's one process.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from pcg_mpi_solver_tpu_torch.resilience.recovery import (
    RecoveryLadder, breakdown_trigger, is_device_loss)


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
