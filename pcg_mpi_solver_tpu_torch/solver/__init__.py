from pcg_mpi_solver_tpu_torch.solver.driver import (
    ManySolveResult, Solver, StepResult, normalize_rhs_block)

__all__ = ["ManySolveResult", "Solver", "StepResult", "normalize_rhs_block"]
