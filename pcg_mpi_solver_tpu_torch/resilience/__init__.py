"""Resilience subsystem of the port: mid-solve snapshots and resume, the
bounded recovery ladder, the device-loss dispatch guard, the time-history
guard (timestep snapshots and NaN rollback), and deterministic fault
injection (ports of
``pcg_mpi_solver_tpu/resilience/{recovery,faultinject,engine}.py``)."""

from pcg_mpi_solver_tpu_torch.resilience.engine import (
    ManyRecoveryHooks, RecoveryHooks, TimeHistoryGuard, kinematic_state_io,
    run_many_with_recovery, run_with_recovery)
from pcg_mpi_solver_tpu_torch.resilience.faultinject import (
    MODES, FaultPlan, InjectedDispatchError, SimulatedKill)
from pcg_mpi_solver_tpu_torch.resilience.recovery import (
    DispatchGuard, RecoveryLadder, ResilienceContext, breakdown_trigger,
    column_trigger, is_device_loss, retry_deadline_s)

__all__ = [
    "MODES", "DispatchGuard", "FaultPlan", "InjectedDispatchError",
    "ManyRecoveryHooks", "RecoveryHooks", "RecoveryLadder",
    "ResilienceContext", "SimulatedKill", "TimeHistoryGuard",
    "breakdown_trigger", "column_trigger", "is_device_loss",
    "kinematic_state_io", "retry_deadline_s",
    "run_many_with_recovery", "run_with_recovery",
]
