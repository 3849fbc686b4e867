"""What each piece of telemetry costs the flagship solve, timed apart.

The flagship of ``chip_smoke.py`` (150^3 cube, mixed, classic, jacobi,
v6, chunked at the auto cap) on ONE Solver, each piece switched on and
off between solves, so every configuration runs on the same device
buffers:

    off          no ring, no sink, no flight file
    off2         a second Solver, built alike with nothing on: the
                 spread between two Solvers' buffers (``chip_smoke.py``
                 phase 4l compares two Solvers)
    ring         the convergence ring (``trace_resid`` = RING)
    jsonl        a JSONL sink (``telemetry_path``)
    flight       a flight file, every record fsync'd (``flight_path``)
    flight_nofs  a flight file flushed only (PCG_TPU_FLIGHT_FSYNC=0)
    all          ring + jsonl + flight (phase 4l's "on")

Every configuration solves once untimed, then ``--rounds`` timed solves
in turns, the order reversed every other round (off, off2, ..., all,
all, ..., off2, off, ...), so a drift of the host or the card falls on
every side alike.  Each line gives a configuration's ms/iter a round,
its median and its median against ``off``'s; flag, iterations and u
must be ``off``'s bit for bit.  Beside them: the flight records a solve
writes, the host cost of one fsync'd and one flushed record in the same
directory (``--fsync-reps`` of each), and the host cost of a ring
record.

    python tools/telemetry_overhead.py [--nx 150] [--rounds 6]
        [--device cuda] [--out build/telemetry_overhead.json]

(``--device cpu --nx 6`` checks the script itself without a card.)
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig  # noqa: E402
from pcg_mpi_solver_tpu_torch.models import make_cube_model  # noqa: E402
from pcg_mpi_solver_tpu_torch.obs.flight import (  # noqa: E402
    FlightRecorder, read_jsonl_tolerant)
from pcg_mpi_solver_tpu_torch.obs.metrics import JsonlSink  # noqa: E402
from pcg_mpi_solver_tpu_torch.obs.trace import (  # noqa: E402
    clamp_trace_len, trace_init)
from pcg_mpi_solver_tpu_torch.solver import Solver  # noqa: E402

RING = 4000
CONFIGS = ("off", "off2", "ring", "jsonl", "flight", "flight_nofs", "all")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIR = os.path.join(ROOT, "build", "telemetry_overhead")


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Switch:
    """Turns each piece of telemetry on and off on one Solver: the ring
    through its ``trace_len`` (and its chunked engine's), the JSONL sink
    through ``add_sink``/``remove_sink``, the flight file by setting the
    recorder's ``flight`` (one fsync'd and one flushed FlightRecorder,
    kept open across solves)."""

    def __init__(self, s):
        self.s = s
        self.ring = clamp_trace_len(RING, s.config.solver.max_iter)
        self.sink = JsonlSink(os.path.join(DIR, "run.jsonl"))
        self.flights = {
            "flight": FlightRecorder(os.path.join(DIR, "flight.jsonl"),
                                     fsync=True),
            "flight_nofs": FlightRecorder(
                os.path.join(DIR, "flight_nofs.jsonl"), fsync=False)}

    def set(self, name: str) -> None:
        s, rec = self.s, self.s.recorder
        s.trace_len = self.ring if name in ("ring", "all") else 0
        if s._engine is not None:
            s._engine.trace_len = s.trace_len
        rec.remove_sink(self.sink)
        if name in ("jsonl", "all"):
            rec.add_sink(self.sink)
        rec.flight = self.flights.get("flight" if name == "all" else name)

    def close(self) -> None:
        self.set("off")
        self.sink.close()
        for fr in self.flights.values():
            fr.close()


def solve(s):
    """One timed solve from zero: (result, u)."""
    if s.device.type == "cuda":
        torch.cuda.synchronize()
    (r,) = s.solve()
    u = s.un.clone()
    s.reset_state()
    return r, u


def record_costs(reps: int) -> dict:
    """Host µs a flight record (fsync'd, flushed) and a ring record."""
    out = {}
    for name, fs in (("fsync", True), ("flush", False)):
        path = os.path.join(DIR, f"probe_{name}.jsonl")
        fr = FlightRecorder(path, fsync=fs)
        t = []
        for i in range(reps):
            t0 = time.perf_counter()
            fr.emit("probe", i=i)
            t.append(time.perf_counter() - t0)
        fr.close()
        out[f"record_{name}_us"] = dict(
            median=statistics.median(t) * 1e6, mean=statistics.mean(t) * 1e6,
            max=max(t) * 1e6)
    ring = trace_init(RING, torch.float32)
    n = 3334
    t0 = time.perf_counter()
    for i in range(n):
        ring.record(np.float32(1.0 / (i + 1)), np.float64(0.5), 0, 1,
                    np.float64(2.0))
    out["ring_record_us"] = (time.perf_counter() - t0) / n * 1e6
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nx", type=int, default=150)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--fsync-reps", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "telemetry_overhead.json"))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("telemetry_overhead: no CUDA device", file=sys.stderr)
        return 1
    smi = smi_line() if args.device == "cuda" else "cpu"
    shutil.rmtree(DIR, ignore_errors=True)
    os.makedirs(DIR)
    t0 = time.perf_counter()
    model = make_cube_model(args.nx, E=30e9, nu=0.2, load="traction",
                            load_value=1e6, heterogeneous=True)
    print(f"model {args.nx}^3, {model.n_dof} dofs, "
          f"{time.perf_counter() - t0:.2f} s; {smi}", flush=True)
    cfg = RunConfig(solver=SolverConfig(tol=1e-7, precision_mode="mixed"))
    s = Solver(model, cfg, device=args.device)
    s2 = Solver(model, cfg, device=args.device)
    sw = Switch(s)

    def run(name):
        if name == "off2":
            return solve(s2)
        sw.set(name)
        return solve(s)

    base = {}
    for n in CONFIGS:                           # the untimed first solves
        r, u = run(n)
        # the ring's records: every iteration when on, none when off
        rec = s.last_trace.n_recorded if n in ("ring", "all") else 0
        base[n] = (r, u, rec)
    ref = base["off"]
    for n, (r, u, rec) in base.items():
        same = ((r.flag, r.iters) == (ref[0].flag, ref[0].iters)
                and torch.equal(u, ref[1]))
        print(f"{n}: flag {r.flag}, iterations {r.iters}, u "
              f"{'bitwise' if same else 'DIFFERENT from'} off's, ring "
              f"records {rec}", flush=True)
        if not same or rec != (r.iters if n in ("ring", "all") else 0):
            return 2
    ms = {n: [] for n in CONFIGS}
    for k in range(args.rounds):
        order = CONFIGS if k % 2 == 0 else CONFIGS[::-1]
        for n in order:
            r, _u = run(n)
            ms[n].append(r.wall_s / r.iters * 1e3)
        print(f"round {k}: " + " ".join(f"{n} {ms[n][-1]:.4f}"
                                        for n in CONFIGS), flush=True)
    sw.close()
    med = {n: statistics.median(v) for n, v in ms.items()}
    iters = ref[0].iters
    for n in CONFIGS:
        d = med[n] - med["off"]
        print(f"{n:12s} median {med[n]:.4f} ms/iter ({d:+.4f}, "
              f"{d / med['off']:+.2%}; {d * iters:+.1f} ms a solve); "
              f"rounds {' '.join(f'{v:.4f}' for v in ms[n])}", flush=True)
    # each of flight / flight_nofs solved 1 + rounds times, all too
    solves = {n: 1 + args.rounds for n in ("flight", "flight_nofs")}
    solves["flight"] *= 2
    records = {}
    for n in ("flight", "flight_nofs"):
        evs, _bad = read_jsonl_tolerant(os.path.join(DIR, f"{n}.jsonl"))
        records[n] = len(evs) / solves[n]
    print(f"flight records a solve: {records}", flush=True)
    costs = record_costs(args.fsync_reps)
    print("host cost: " + "; ".join(
        f"{k} {json.dumps(v) if isinstance(v, dict) else f'{v:.3f}'}"
        for k, v in costs.items()), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=smi, nx=args.nx, iterations=iters,
                       ms_per_iter=ms, median=med, flight_records=records,
                       **costs), f, indent=1)
    shutil.rmtree(DIR, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
