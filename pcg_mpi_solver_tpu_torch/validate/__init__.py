"""Request validation (port of ``pcg_mpi_solver_tpu/validate``): the
per-column checks of a blocked right-hand side, the mg preflight and the
time-history drivers' preflight."""

from pcg_mpi_solver_tpu_torch.validate.preflight import (
    CheckResult, PreflightError, check_rhs_block, run_mg_preflight,
    run_time_preflight)

__all__ = ["CheckResult", "PreflightError", "check_rhs_block",
           "run_mg_preflight", "run_time_preflight"]
