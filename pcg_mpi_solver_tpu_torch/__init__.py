"""PyTorch/CUDA port of pcg_mpi_solver_tpu: matrix-free PCG for
elastostatics (and scalar Poisson) on octree and structured hexahedral
meshes, on an NVIDIA Hopper card.

The JAX package ``pcg_mpi_solver_tpu`` is the reference; this package
imports nothing of it and no JAX.  Ported so far: the structured-cube
solve end to end (``models.make_cube_model`` -> ``parallel.structured``
-> scalar Jacobi, 3x3 block Jacobi or the geometric multigrid V-cycle
(``ops.mg``) -> ``pcg`` (classic, fused or pipelined) inside the mixed
f32/f64 refinement shell -> ``solver.Solver``), blocks of load cases in
one lockstep loop (``pcg_many``, ``Solver.solve_many``; request checks
in ``validate``), with hand-written CUDA
kernels for the slab stencil matvec (``csrc/structured_matvec*.cu``, one
per ported Pallas variant, chosen by ``PCG_TPU_PALLAS_V``); and the
general (pattern-type) backend for every model the slab cannot take
(``models.make_octree_model``, ``make_glued_blocks_model``,
``make_poisson_model`` -> ``parallel.partition_model`` -> the bucketed
general operator of ``ops.matvec``), under Jacobi or block Jacobi; the
hybrid level-grid backend for octree models (``parallel.hybrid``: each
refinement level's brick cells through the slab kernels, the transition
cells on the general operator, the bucketed float64 refresh); and
the chunked path that ``Solver.step`` takes at 4 M dofs and above
(``solver.chunked``: capped dispatches of the resumable ``pcg``) with the
recovery ladder, the dispatch guard, mid-solve snapshots, step
checkpoints and fault injection (``resilience``, ``utils.checkpoint``,
``obs.metrics``); the mixed shell's plateau and progress exits; and the
export path: ``Solver.solve(store=...)`` writes the displacement and the
nodal strain/stress fields (``ops.stress``, ``ops.nonlocal_stress``) in
the JAX package's run-directory layout (``utils.io.RunStore``), read back
as ``.vtu`` files (``vtk``) and post-processed (``utils.postproc``), with
the MDF bundle reader/writer (``models.mdf``) and the command line
(``python -m pcg_mpi_solver_tpu_torch.cli``); and the time integrators on
the general and hybrid backends (``solver.select_time_backend``):
explicit central-difference dynamics (``solver.DynamicsSolver``,
``solver.stable_dt``) and implicit Newmark-beta with a PCG solve a step
(``solver.NewmarkSolver`` on ``solver.MassShiftedOps``), with timestep
snapshots, step faults and NaN rollback
(``resilience.TimeHistoryGuard``); the native dual-graph partitioner
(``native``, built with g++ at first use; ``partition_method="graph"``
and ``"auto"``) and the content-addressed partition cache behind
``RunConfig.cache_dir`` (``cache``); and the bench (``python -m
pcg_mpi_solver_tpu_torch.bench``: one JSON line of dof-iterations a
second on the card against a live numpy baseline, ``solver.numpy_ref``;
its serve leg ``serve.bench``; the trend sentinel ``obs.trend``).
"""

from pcg_mpi_solver_tpu_torch.config import (
    RunConfig, SolverConfig, TimeHistoryConfig)

# the port's own version: it keys the partition cache's entries
# (cache/keys.py), so a version bump invalidates them
__version__ = "0.1.0"

__all__ = ["RunConfig", "SolverConfig", "TimeHistoryConfig", "__version__"]
