"""The mixed shell's windows in both packages on the CPU: the flagship's
arguments (``make_cube_model(n, E=30e9, nu=0.2, load="traction",
load_value=1e6, heterogeneous=True)``) at n cells a side, mixed, jacobi,
classic, tol 1e-7, one part, on the chunked path at cap ``--cap``
(chip_smoke.py's flagship runs the auto cap, 1089), with
``mixed_plateau_window`` / ``mixed_progress_window`` set.

    python tools/window_parity.py [n] [--plateau W] [--progress W]
        [--cap C]

Prints each package's flag, iterations, relres and seconds, the port's
refinement cycles (inner flag, iterations), and the JAX Solver's
dispatch counters (``refine`` calls = its refinement cycles,
``inner_cycle`` calls).  Needs JAX (the port
does not); at n = 96 each package takes about four minutes.
"""

import argparse
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from pcg_mpi_solver_tpu import RunConfig as JaxRunConfig  # noqa: E402
from pcg_mpi_solver_tpu import SolverConfig as JaxSolverConfig  # noqa: E402
from pcg_mpi_solver_tpu.models import make_cube_model as jax_cube  # noqa: E402
from pcg_mpi_solver_tpu.parallel.mesh import make_mesh  # noqa: E402
from pcg_mpi_solver_tpu.solver import Solver as JaxSolver  # noqa: E402
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig  # noqa: E402
from pcg_mpi_solver_tpu_torch.models import make_cube_model  # noqa: E402
from pcg_mpi_solver_tpu_torch.solver import Solver  # noqa: E402

FLAGSHIP = dict(E=30e9, nu=0.2, load="traction", load_value=1e6,
                heterogeneous=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="?", type=int, default=48)
    ap.add_argument("--plateau", type=int, default=0)
    ap.add_argument("--progress", type=int, default=0)
    ap.add_argument("--cap", type=int, default=1089)
    args = ap.parse_args()
    sc = dict(tol=1e-7, precision_mode="mixed", iters_per_dispatch=args.cap,
              mixed_plateau_window=args.plateau,
              mixed_progress_window=args.progress)
    print(f"cube {args.n}^3, {sc}")
    t0 = time.perf_counter()
    s = Solver(make_cube_model(args.n, **FLAGSHIP),
               RunConfig(solver=SolverConfig(**sc)), device="cpu")
    r = s.step(1.0)
    print(f"port: flag {r.flag}, iterations {r.iters}, relres "
          f"{r.relres:.4e}, {time.perf_counter() - t0:.1f} s; refinement "
          f"cycles (inner flag, iterations) "
          f"{[(f, n) for k, f, n in s.dispatch_log if k == 'refine']}")
    t0 = time.perf_counter()
    js = JaxSolver(jax_cube(args.n, **FLAGSHIP),
                   JaxRunConfig(solver=JaxSolverConfig(**sc)),
                   mesh=make_mesh(1), n_parts=1)
    r = js.step(1.0)
    print(f"jax: flag {int(r.flag)}, iterations {int(r.iters)}, relres "
          f"{float(r.relres):.4e}, {time.perf_counter() - t0:.1f} s; "
          f"dispatch counters "
          f"{ {k: v for k, v in js.recorder.counters.items() if k.startswith('dispatch.')} }")


if __name__ == "__main__":
    main()
