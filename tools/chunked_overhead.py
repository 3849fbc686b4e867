"""The chunked path's cost on the card: the flagship cube (chip_smoke.py's
phase 4 configuration: 150^3 cells, 10,328,853 dofs, mixed, jacobi,
classic, v6, tol 1e-7) solved in turns on the chunked path at the JAX
package's auto cap and on the one-shot path (``iters_per_dispatch=0``),
in the order chunked, one-shot, one-shot, chunked, chunked, one-shot,
each on its own Solver, with no profiler window.

    python3 tools/chunked_overhead.py [cells]     # default 150

Prints each solve's iterations, dispatches, wall and ms/iter (for a
chunked solve also the seconds of each dispatch name from its
``MetricsRecorder``: start, inner_start, inner_cycle, final32, refine,
and the inner_cycle seconds an iteration), then the median ms/iter of
each path and their ratio, and the card's name and power limit
(``nvidia-smi``).  Needs the card.
"""

import os
import statistics
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig  # noqa: E402
from pcg_mpi_solver_tpu_torch.models import make_cube_model  # noqa: E402
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder  # noqa: E402
from pcg_mpi_solver_tpu_torch.ops.kernels import build_kernels  # noqa: E402
from pcg_mpi_solver_tpu_torch.solver import Solver  # noqa: E402

ORDER = ("chunked", "one-shot", "one-shot", "chunked", "chunked",
         "one-shot")


def main() -> int:
    if not torch.cuda.is_available():
        print("chunked_overhead: no CUDA device available", file=sys.stderr)
        return 1
    cells = int(sys.argv[1]) if len(sys.argv) > 1 else 150
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    build_kernels()
    t0 = time.perf_counter()
    model = make_cube_model(cells, E=30e9, nu=0.2, load="traction",
                            load_value=1e6, heterogeneous=True)
    print(f"cube {cells}^3, {model.n_dof} dofs; build "
          f"{time.perf_counter() - t0:.2f} s; {smi}", flush=True)
    ms = {"chunked": [], "one-shot": []}
    for path in ORDER:
        cap = -1 if path == "chunked" else 0
        rec = MetricsRecorder()
        s = Solver(model, RunConfig(solver=SolverConfig(
            tol=1e-7, precision_mode="mixed", iters_per_dispatch=cap)),
            recorder=rec)
        torch.cuda.synchronize()
        r = s.solve()[-1]
        calls = [n for k, n, _f in s.dispatch_log if k != "refine"]
        ms[path].append(r.wall_s / r.iters * 1e3)
        print(f"{path}: cap {s._dispatch_cap}, flag {r.flag}, iterations "
              f"{r.iters}, dispatches {calls or 'one-shot'}, wall "
              f"{r.wall_s:.4f} s, {ms[path][-1]:.4f} ms/iter", flush=True)
        stats = {k: v["cold_s"] + v["warm_s"]
                 for k, v in rec.dispatch_stats().items()}
        if stats:
            print(f"{path}: seconds by dispatch "
                  f"{ {k: round(v, 4) for k, v in stats.items()} }; "
                  f"inner_cycle {stats['inner_cycle'] / sum(calls) * 1e3:.4f}"
                  f" ms an iteration, the rest "
                  f"{r.wall_s - stats['inner_cycle']:.4f} s", flush=True)
        if r.flag != 0:
            raise AssertionError(f"{path} solve did not converge: {r}")
        del s
        torch.cuda.empty_cache()
    mc, mo = (statistics.median(ms[p]) for p in ("chunked", "one-shot"))
    print(f"median ms/iter: chunked {mc:.4f}, one-shot {mo:.4f}; chunked "
          f"/ one-shot {mc / mo:.4f} ({(mc / mo - 1) * 100:+.2f} %); {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
