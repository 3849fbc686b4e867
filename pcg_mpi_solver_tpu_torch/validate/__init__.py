"""Model, config and request validation (port of
``pcg_mpi_solver_tpu/validate``): the preflight gate of the solvers and
the per-column checks of a blocked right-hand side."""

from pcg_mpi_solver_tpu_torch.validate.preflight import (
    CheckResult, PreflightError, check_mg_interval, check_rhs_block,
    preflight_checks, resolve_policy, run_preflight)

__all__ = ["CheckResult", "PreflightError", "check_mg_interval",
           "check_rhs_block",
           "preflight_checks", "resolve_policy", "run_preflight"]
