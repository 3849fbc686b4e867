"""BENCH_SERVE leg: sustained solve-service throughput — saturated queue
(nrhs packing engaged) against one-at-a-time dispatch.

Port of ``pcg_mpi_solver_tpu/serve/bench.py``.  Run through the bench's
front door::

    BENCH_SERVE=1 python -m pcg_mpi_solver_tpu_torch.bench

on the card, or on the CPU with ``BENCH_FORCE_CPU=1``.

Both phases serve the SAME jobs through the SAME warm solver from a
fresh spool each: the serial phase pins the width set to {1} (every job
its own dispatch — the no-service baseline an operator would script),
the saturated phase submits everything up front and lets the packer
co-batch into the standard widths.  Every engaged block width is warmed
before either timer starts, so the line measures service throughput,
not first launches.

Emits one schema-versioned bench line — ``metric=serve_jobs_per_s``,
``vs_baseline`` = saturated/serial — stamping the typed detail fields
``jobs_per_s`` / ``jobs_per_s_serial`` / ``queue_depth_max`` /
``jobs_shed`` (``obs/schema.py`` BENCH_DETAIL_NUMERIC), and writes the
artifact to ``$BENCH_SERVE_OUT`` (default BENCH_SERVE.json; empty = no
file).

Knobs: ``BENCH_SERVE_NX`` (cube dims, default ``6,5,5``),
``BENCH_SERVE_JOBS`` (job count per phase, default 12),
``BENCH_SERVE_WIDTHS`` (packed widths, default ``1,2,4,8``).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time


def _log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def _serve_phase(solver, n_jobs: int, widths, deadline_s: float) -> dict:
    """Submit ``n_jobs`` scale-ramp jobs into a fresh spool, serve them
    to drain, return the phase numbers.  Jobs are pre-submitted
    (saturated arrival) so the queue — not the submitter — paces the
    daemon."""
    from pcg_mpi_solver_tpu_torch.serve import jobs as sjobs
    from pcg_mpi_solver_tpu_torch.serve.daemon import ServeDaemon

    spool = tempfile.mkdtemp(prefix="pcg_bench_serve_")
    try:
        for i in range(n_jobs):
            sjobs.submit(spool, {"scale": 1.0 + 0.1 * i,
                                 "deadline_s": deadline_s},
                         submit_t=float(i))
        daemon = ServeDaemon(solver, spool, queue_max=n_jobs + 2,
                             widths=widths, fault_plan=None, poll_s=0.001)
        t0 = time.perf_counter()
        daemon.run(idle_exit_s=0.0, install_signals=False)
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(spool, ignore_errors=True)
    return {"wall_s": wall, "jobs_done": daemon.jobs_done,
            "jobs_failed": daemon.jobs_failed,
            "jobs_shed": daemon.admission.shed_count,
            "queue_depth_max": daemon.admission.depth_max,
            "blocks": daemon.blocks,
            "jobs_per_s": daemon.jobs_done / max(wall, 1e-9)}


def main(device=None) -> int:
    """The serve leg; ``device`` None is the card (``bench.py`` passes
    ``"cpu"`` under ``BENCH_FORCE_CPU=1``)."""
    import numpy as np

    from pcg_mpi_solver_tpu_torch.bench import device_label
    from pcg_mpi_solver_tpu_torch.config import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.models.synthetic import make_cube_model
    from pcg_mpi_solver_tpu_torch.obs.schema import BENCH_SCHEMA
    from pcg_mpi_solver_tpu_torch.serve.packer import (
        normalize_widths, pick_width)
    from pcg_mpi_solver_tpu_torch.solver.driver import Solver

    dims = [int(v) for v in
            os.environ.get("BENCH_SERVE_NX", "6,5,5").split(",")]
    dims += [0] * (3 - len(dims))
    n_jobs = int(os.environ.get("BENCH_SERVE_JOBS", 12))
    widths = normalize_widths(
        int(v) for v in
        os.environ.get("BENCH_SERVE_WIDTHS", "1,2,4,8").split(","))
    out_path = os.environ.get("BENCH_SERVE_OUT", "BENCH_SERVE.json")

    model = make_cube_model(dims[0], dims[1], dims[2],
                            heterogeneous=True)
    cfg = RunConfig(solver=SolverConfig(tol=1e-8, max_iter=2000))
    _log(f"serve bench: {model.n_dof} dofs, {n_jobs} jobs, "
         f"widths {widths}")
    solver = Solver(model, cfg, backend="general", device=device)
    platform = "gpu" if solver.device.type == "cuda" else "cpu"

    # warm every width either phase can engage BEFORE any timer: the
    # line is service throughput, not the first launches
    warm = set()
    left = n_jobs
    while left > 0:
        w = pick_width(left, widths)
        warm.add(w)
        left -= w
    warm.add(1)
    f = np.asarray(model.F, dtype=np.float64)
    for w in sorted(warm):
        _log(f"warming width {w}")
        solver.solve_many(np.stack([f] * w, axis=-1))

    serial = _serve_phase(solver, n_jobs, (1,), deadline_s=3600.0)
    _log(f"serial: {serial['jobs_done']} jobs in "
         f"{serial['wall_s']:.3f}s ({serial['jobs_per_s']:.2f} jobs/s)")
    packed = _serve_phase(solver, n_jobs, widths, deadline_s=3600.0)
    _log(f"saturated: {packed['jobs_done']} jobs in "
         f"{packed['wall_s']:.3f}s ({packed['jobs_per_s']:.2f} jobs/s), "
         f"{packed['blocks']} block(s), "
         f"depth_max {packed['queue_depth_max']}")

    line = {
        "schema": BENCH_SCHEMA,
        "metric": "serve_jobs_per_s",
        "value": round(packed["jobs_per_s"], 3),
        "unit": "jobs/s",
        "vs_baseline": round(packed["jobs_per_s"]
                             / max(serial["jobs_per_s"], 1e-9), 3),
        "detail": {
            "jobs_per_s": round(packed["jobs_per_s"], 3),
            "jobs_per_s_serial": round(serial["jobs_per_s"], 3),
            "queue_depth_max": packed["queue_depth_max"],
            "jobs_shed": packed["jobs_shed"],
            "jobs_failed": packed["jobs_failed"] + serial["jobs_failed"],
            "n_jobs": n_jobs,
            "n_dof": int(model.n_dof),
            "nrhs": max(warm),
            "blocks": packed["blocks"],
            "blocks_serial": serial["blocks"],
            "predicted_ms_per_iter": solver.predicted_ms_per_iter(
                max(warm)),
            "pcg_variant": cfg.solver.pcg_variant,
            "precond": cfg.solver.precond,
            "backend": solver.backend,
            "platform": platform,
            "device": device_label(platform),
        },
    }
    print(json.dumps(line), flush=True)
    if out_path:
        with open(out_path, "w") as fh:
            json.dump(line, fh, indent=1)
        _log(f"artifact written: {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
