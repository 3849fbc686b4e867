"""The JAX package's iteration count on an octree of chip_smoke.py's
phase 4e (bench.py's octree arguments at n0 cells a side): a mixed PCG
solve, classic, tol 1e-7, one part, on the CPU, under the preconditioner
``--precond`` (jacobi by default; mg builds its hierarchy from the
octree lattice), on the backend ``--backend`` (auto by default: the
general backend, or the hybrid one under ``PCG_TPU_ENABLE_HYBRID=1``).

    python tools/octree_jax_count.py [n0] [--precond jacobi|mg]
        [--backend auto|general|hybrid]

Prints the model size, the backend the JAX Solver chose, and flag,
iterations and relres; chip_smoke.py's JAX_OCTREE6_ITERS is its n0 = 6
count, JAX_OCTREE6_MG_ITERS its n0 = 6 count under ``--precond mg``,
JAX_OCTREE6_HYBRID_ITERS its n0 = 6 count on the hybrid backend.  Needs
JAX (the port does not); takes about a minute at n0 = 6.
"""

import argparse
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from pcg_mpi_solver_tpu import RunConfig, SolverConfig  # noqa: E402
from pcg_mpi_solver_tpu.models.octree import make_octree_model  # noqa: E402
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh  # noqa: E402
from pcg_mpi_solver_tpu.solver import Solver  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n0", nargs="?", type=int, default=6)
    ap.add_argument("--precond", default="jacobi",
                    choices=("jacobi", "block3", "mg"))
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "general", "hybrid"))
    args = ap.parse_args()
    n = args.n0
    t0 = time.perf_counter()
    model = make_octree_model(n, n, n, max_level=4, n_incl=6, seed=2,
                              E=30e9, nu=0.2, load="traction",
                              load_value=1e6)
    print(f"octree {n}^3/L4: {model.n_dof} dofs, {len(model.elem_lib)} "
          f"types, build {time.perf_counter() - t0:.1f} s", flush=True)
    # iters_per_dispatch=0: the one-shot loop, which the port's auto cap
    # also gives a model below 4 M dofs (on the hybrid backend both
    # packages' auto cap takes the chunked path at any size; at n0 = 6 JAX
    # counts 1149 there, against 1145 one-shot)
    cfg = RunConfig(solver=SolverConfig(
        tol=1e-7, precision_mode="mixed", precond=args.precond,
        pcg_variant="classic", iters_per_dispatch=0))
    solver = Solver(model, cfg, mesh=make_mesh(1), n_parts=1,
                    backend=args.backend)
    res = solver.step(1.0)
    print(f"precond {args.precond}, backend {solver.backend}: flag "
          f"{res.flag}, iterations "
          f"{res.iters}, relres {res.relres:.4e}, {res.wall_s:.1f} s")


if __name__ == "__main__":
    main()
