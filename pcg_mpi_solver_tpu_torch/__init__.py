"""PyTorch/CUDA port of pcg_mpi_solver_tpu: matrix-free PCG for
structured-cube elastostatics on an NVIDIA Hopper card.

The JAX package ``pcg_mpi_solver_tpu`` is the reference; this package
imports nothing of it and no JAX.  Ported so far: the structured-cube
solve end to end (``models.make_cube_model`` -> ``parallel.structured``
-> scalar Jacobi, 3x3 block Jacobi or the geometric multigrid V-cycle
(``ops.mg``) -> ``pcg`` (classic, fused or pipelined) inside the mixed
f32/f64 refinement shell -> ``solver.Solver``), with hand-written CUDA
kernels for the slab stencil matvec (``csrc/structured_matvec*.cu``, one
per ported Pallas variant, chosen by ``PCG_TPU_PALLAS_V``).
"""

from pcg_mpi_solver_tpu_torch.config import (
    RunConfig, SolverConfig, TimeHistoryConfig)

__all__ = ["RunConfig", "SolverConfig", "TimeHistoryConfig"]
