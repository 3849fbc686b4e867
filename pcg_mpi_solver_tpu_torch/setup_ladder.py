"""Weak-scaling setup ladder: the n-process setup rungs over gloo.

Port of ``pcg_mpi_solver_tpu/setup_ladder.py``.  Measures the COLD
SETUP PATH — partition build, model ingest, warm-cache reload — as a
weak-scaling ladder over process counts: each rung runs a real N-process
``torch.distributed`` gloo group with a FIXED per-process
problem size (the model grows with N along x), so the numbers answer one
question directly: does setup cost scale with process count instead of
model size?

Per rung the harness records one line (and the ``BENCH_SETUP_OUT``
artifact):

* ``partition_build_s``  — max per-process SHARDED partition build wall
  (each process builds only its own parts; ``Solver.partition_build_s``);
* ``partition_serial_s`` — the monolithic full build of the SAME model,
  measured once in the parent: what every process would pay without the
  sharded path; ``vs_baseline`` = serial / parallel;
* ``cold_setup_s`` / ``warm_setup_s`` — solver construction wall on the
  cold build vs the shard-addressed warm cache (every process reads ONLY
  its own per-part entries — asserted in the child via the recorder's
  cache event);
* ``ingest_peak_bytes``  — peak host memory of the streamed slab ingest
  (``models/mdf.read_mdf_slab``) of the rung's model, per process.

Run as ``python -m pcg_mpi_solver_tpu_torch.setup_ladder [--device cpu]``.
Knobs:
``BENCH_SETUP_LADDER`` (comma process counts, default 1,2,4),
``BENCH_SETUP_NX`` (per-process cells/axis, default 40),
``BENCH_SETUP_PPP`` (parts per process, default 2), ``BENCH_SETUP_OUT``
(artifact path, default ``setup_ladder.json``), ``BENCH_SETUP_TIMEOUT_S``
(per-rung child timeout), ``BENCH_CACHE_DIR`` (the parent of the rung's
fresh cache directory).  The partition build runs on the host; each
child's Solver runs on the card (rank ``r`` on ``cuda:(r % device_count)``,
the mesh's device), so the setup times include the upload a rank pays,
unless ``--device cpu`` asks for the CPU.  The children set one torch
thread each.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

# Child process body: one rank of a rung.  Builds the (deterministic)
# synthetic model itself, constructs a COLD sharded Solver against the
# shared cache dir, then a WARM one, asserting the warm start built
# nothing and read only this process's shard entries; finally measures
# the streamed slab ingest of the rung's MDF bundle.  Prints one
# "LADDER {json}" line.
_CHILD = r"""
import json, os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
N_PROCS = int(sys.argv[3]); PPP = int(sys.argv[4]); NX = int(sys.argv[5])
CACHE = sys.argv[6]; MDF = sys.argv[7]; DEVICE = sys.argv[8] or None
from pcg_mpi_solver_tpu_torch.parallel.distributed import (
    fetch_global, init_distributed, make_global_mesh)
pid = init_distributed(sys.argv[1], N_PROCS, int(sys.argv[2])) \
    if N_PROCS > 1 else 0
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, TimeHistoryConfig
from pcg_mpi_solver_tpu_torch.models.synthetic import make_cube_model
from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
from pcg_mpi_solver_tpu_torch.solver.driver import Solver

class CapSink:
    def __init__(self): self.events = []
    def emit(self, ev): self.events.append(ev)
    def close(self): pass

model = make_cube_model(NX * N_PROCS, NX, NX, heterogeneous=True)
n_parts = N_PROCS * PPP
def cfg():
    return RunConfig(cache_dir=CACHE, partition_method="slab2",
                     solver=SolverConfig(tol=1e-6, max_iter=60),
                     time_history=TimeHistoryConfig(
                         time_step_delta=[0.0, 1.0], export_flag=False))
mesh = make_global_mesh()
s_cold = Solver(model, cfg(), mesh=mesh, n_parts=n_parts,
                backend="general", device=DEVICE)
# the ratio's denominator must be a real build: a pre-warmed cache dir
# would record partition_build_s ~ 0
assert s_cold.setup_cache == "cold", s_cold.setup_cache
cold = {"setup_s": s_cold.setup_s,
        "partition_build_s": s_cold.partition_build_s,
        "cache": s_cold.setup_cache}
r = s_cold.step(1.0)
checksum = float(np.abs(fetch_global(s_cold.un, mesh)).sum())
cap = CapSink()
s_warm = Solver(model, cfg(), mesh=mesh, n_parts=n_parts,
                backend="general", device=DEVICE,
                recorder=MetricsRecorder(sinks=(cap,)))
assert s_warm.setup_cache == "warm", s_warm.setup_cache
assert s_warm.partition_build_s == 0.0, "warm start built a partition"
ev = [e for e in cap.events if e.get("kind") == "cache"
      and e.get("shard")]
lo, hi = s_warm._part_range
expect = list(range(lo, hi))
if N_PROCS > 1:
    assert ev and ev[0]["parts"] == expect, (ev, expect)
r2 = s_warm.step(1.0)
checksum2 = float(np.abs(fetch_global(s_warm.un, mesh)).sum())
assert checksum == checksum2, (checksum, checksum2)
warm = {"setup_s": s_warm.setup_s, "cache": s_warm.setup_cache,
        "entries": ev[0]["entries"] if ev else 1, "parts": expect}
ingest = None
if MDF and os.path.isdir(MDF):
    from pcg_mpi_solver_tpu_torch.models.mdf import (
        IngestStats, read_mdf_slab)

    st = IngestStats()
    t0 = time.perf_counter()
    read_mdf_slab(MDF, pid, N_PROCS, stats=st)
    ingest = {"peak_bytes": st.peak_bytes,
              "wall_s": time.perf_counter() - t0}
print("LADDER " + json.dumps({
    "pid": pid, "n_dof": int(model.n_dof), "flag": int(r.flag),
    "cold": cold, "warm": warm, "ingest": ingest,
    "checksum": checksum}), flush=True)
"""

def _log(msg: str) -> None:
    print(f"# setup_ladder: {msg}", file=sys.stderr, flush=True)


def _ensure(d: str) -> str:
    os.makedirs(d, exist_ok=True)
    return d


def _run_rung(n_procs: int, ppp: int, nx: int, cache_dir: str,
              mdf_dir: str, timeout_s: float, device: str):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    with tempfile.TemporaryDirectory() as td:
        script = os.path.join(td, "child.py")
        with open(script, "w") as f:
            f.write(_CHILD)
        env = dict(os.environ)
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        env["PYTHONPATH"] = os.pathsep.join(
            [repo] + env.get("PYTHONPATH", "").split(os.pathsep))
        # child stdout goes to FILES, not pipes: the children form one
        # collective group, and a later child blocking on a full 64KB
        # pipe while the parent drains an earlier child's would wedge
        # the whole rung mid-collective
        logs = [open(os.path.join(td, f"child{i}.log"), "w+")
                for i in range(n_procs)]
        procs = [subprocess.Popen(
            [sys.executable, script, coord, str(i), str(n_procs),
             str(ppp), str(nx), cache_dir, mdf_dir, device or ""],
            stdout=logs[i], stderr=subprocess.STDOUT, text=True,
            env=env) for i in range(n_procs)]
        outs = []
        try:
            deadline = time.monotonic() + timeout_s
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.seek(0)
                outs.append(f.read())
                f.close()
    results = []
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"setup_ladder rung {n_procs}: child {i} "
                               f"failed:\n{out[-4000:]}")
        lines = [ln for ln in out.splitlines() if ln.startswith("LADDER ")]
        results.append(json.loads(lines[-1][len("LADDER "):]))
    return results


def run_ladder(rungs, *, nx: int, ppp: int, cache_dir: str,
               out_path: str, timeout_s: float = 900.0, device=None):
    """Run the ladder; returns the list of per-rung BENCH-schema lines
    (also printed to stdout and written to ``out_path``).  ``device``
    None puts each rank's Solver on the mesh's card; ``"cpu"`` on the
    CPU."""
    # unique per-invocation subdir: rungs must COLD-build (the in-child
    # assert), then warm from their own entries; earlier entries in a
    # shared BENCH_CACHE_DIR must not pre-warm the measurement.  Removed on exit — the rung models/MDF
    # bundles are measurement scratch (hundreds of MB at default sizes)
    # that evict_lru's flat-file scan would never reclaim.
    cache_dir = tempfile.mkdtemp(prefix="run_", dir=_ensure(cache_dir))
    lines = []
    try:
        return _run_rungs(rungs, nx, ppp, cache_dir, out_path,
                          timeout_s, lines, device)
    finally:
        import shutil

        shutil.rmtree(cache_dir, ignore_errors=True)


def _run_rungs(rungs, nx, ppp, cache_dir, out_path, timeout_s, lines,
               device):
    from pcg_mpi_solver_tpu_torch.models.mdf import write_mdf
    from pcg_mpi_solver_tpu_torch.models.synthetic import make_cube_model
    from pcg_mpi_solver_tpu_torch.obs.schema import BENCH_SCHEMA
    from pcg_mpi_solver_tpu_torch.parallel.partition import partition_model

    for n in rungs:
        n_parts = n * ppp
        _log(f"rung {n}: {nx * n}x{nx}x{nx} cells, {n_parts} parts")
        model = make_cube_model(nx * n, nx, nx, heterogeneous=True)
        # serial reference: the monolithic full build of the SAME model
        # and the SAME two-level method — what every process pays
        # without the sharded path
        t0 = time.perf_counter()
        partition_model(model, n_parts, method="slab2", slab2_slabs=n)
        serial_s = time.perf_counter() - t0
        mdf_dir = os.path.join(cache_dir, f"ladder_mdf_{n}")
        if not os.path.isdir(mdf_dir):
            write_mdf(model, mdf_dir)
        res = _run_rung(n, ppp, nx, cache_dir, mdf_dir,
                        timeout_s=timeout_s, device=device)
        par_s = max(r["cold"]["partition_build_s"] for r in res)
        line = {
            "schema": BENCH_SCHEMA,
            "metric": "setup_partition_build",
            "value": round(par_s, 4),
            "unit": "s",
            "vs_baseline": round(serial_s / max(par_s, 1e-9), 3),
            "detail": {
                "procs": n,
                "n_parts": n_parts,
                "n_dof": res[0]["n_dof"],
                "partition_build_s": round(par_s, 4),
                "partition_serial_s": round(serial_s, 4),
                "cold_setup_s": round(
                    max(r["cold"]["setup_s"] for r in res), 4),
                "warm_setup_s": round(
                    max(r["warm"]["setup_s"] for r in res), 4),
                "ingest_peak_bytes": max(
                    (r["ingest"] or {}).get("peak_bytes", 0)
                    for r in res),
                "setup_cache": "warm",
                "pcg_variant": "classic",
            },
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    artifact = {"schema": BENCH_SCHEMA, "metric": "setup_ladder",
                "value": lines[-1]["vs_baseline"] if lines else 0.0,
                "unit": "x_vs_serial",
                "vs_baseline": lines[-1]["vs_baseline"] if lines else 0.0,
                "rungs": lines}
    if out_path:
        with open(out_path, "w") as f:
            json.dump(artifact, f, indent=1)
        _log(f"artifact written: {out_path}")
    return lines


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="setup_ladder")
    ap.add_argument("--device", choices=("cpu",), default=None,
                    help="run the ranks' Solvers on the CPU (default: "
                         "the card, rank r on cuda:(r %% device_count))")
    args = ap.parse_args(argv)
    rungs = [int(v) for v in
             os.environ.get("BENCH_SETUP_LADDER", "1,2,4").split(",")
             if v.strip()]
    nx = int(os.environ.get("BENCH_SETUP_NX", 40))
    ppp = int(os.environ.get("BENCH_SETUP_PPP", 2))
    cache = os.environ.get("BENCH_CACHE_DIR", "")
    own_tmp = None
    if not cache:
        cache = own_tmp = tempfile.mkdtemp(prefix="pcg_setup_ladder_")
    out = os.environ.get("BENCH_SETUP_OUT", "setup_ladder.json")
    timeout_s = float(os.environ.get("BENCH_SETUP_TIMEOUT_S", 900))
    try:
        run_ladder(rungs, nx=nx, ppp=ppp, cache_dir=cache, out_path=out,
                   timeout_s=timeout_s, device=args.device)
    finally:
        if own_tmp is not None:     # run_ladder removes only its run_
            import shutil           # subdir; the parent we made is ours

            shutil.rmtree(own_tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
