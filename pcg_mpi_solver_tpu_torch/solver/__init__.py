from pcg_mpi_solver_tpu_torch.solver.backends import select_time_backend
from pcg_mpi_solver_tpu_torch.solver.driver import (
    ManySolveResult, Solver, StepResult, normalize_rhs_block)
from pcg_mpi_solver_tpu_torch.solver.dynamics import (
    DynamicsResult, DynamicsSolver, stable_dt)
from pcg_mpi_solver_tpu_torch.solver.newmark import (
    MassShiftedOps, NewmarkSolver)

__all__ = ["DynamicsResult", "DynamicsSolver", "ManySolveResult",
           "MassShiftedOps", "NewmarkSolver", "Solver", "StepResult",
           "normalize_rhs_block", "select_time_backend", "stable_dt"]
