from pcg_mpi_solver_tpu_torch.solver.driver import Solver, StepResult

__all__ = ["Solver", "StepResult"]
