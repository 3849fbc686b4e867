"""Request validation (port of ``pcg_mpi_solver_tpu/validate``): the
per-column checks of a blocked right-hand side and the mg preflight."""

from pcg_mpi_solver_tpu_torch.validate.preflight import (
    CheckResult, PreflightError, check_rhs_block, run_mg_preflight)

__all__ = ["CheckResult", "PreflightError", "check_rhs_block",
           "run_mg_preflight"]
