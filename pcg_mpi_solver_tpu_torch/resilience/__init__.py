"""Resilience subsystem of the port: mid-solve snapshots and resume, the
bounded recovery ladder, the device-loss dispatch guard, the time-history
guard (timestep snapshots and NaN rollback), deterministic fault
injection, and the multi-process pieces: deadline-guarded collectives
naming a dead peer and group-consistent snapshot epochs (ports of
``pcg_mpi_solver_tpu/resilience/{recovery,faultinject,engine,
distributed}.py``)."""

from pcg_mpi_solver_tpu_torch.resilience.distributed import (
    DeadPeerError, GroupSnapshotStore, GuardedComm, collective_deadline_s,
    suspect_dead_rank)
from pcg_mpi_solver_tpu_torch.resilience.engine import (
    ManyRecoveryHooks, RecoveryHooks, TimeHistoryGuard, kinematic_state_io,
    run_many_with_recovery, run_with_recovery)
from pcg_mpi_solver_tpu_torch.resilience.faultinject import (
    MODES, FaultPlan, InjectedDispatchError, SimulatedKill)
from pcg_mpi_solver_tpu_torch.resilience.recovery import (
    DispatchGuard, RecoveryLadder, ResilienceContext, breakdown_trigger,
    column_trigger, is_device_loss, retry_deadline_s)

__all__ = [
    "MODES", "DeadPeerError", "DispatchGuard", "FaultPlan",
    "GroupSnapshotStore", "GuardedComm", "InjectedDispatchError",
    "ManyRecoveryHooks", "RecoveryHooks", "RecoveryLadder",
    "ResilienceContext", "SimulatedKill", "TimeHistoryGuard",
    "breakdown_trigger", "collective_deadline_s", "column_trigger",
    "is_device_loss",
    "kinematic_state_io", "retry_deadline_s",
    "run_many_with_recovery", "run_with_recovery", "suspect_dead_rank",
]
