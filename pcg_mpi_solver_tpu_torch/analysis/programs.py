"""The recorded program matrix of the contract lint's trip rules.

The counterpart of the JAX package's ``analysis/programs.py``: REAL
solvers (``solver/driver.py``) at the JAX package's sizes (cubes of 3^3
on the general backend, 4^3 on the structured one and under mg, 2
parts), each solved and recorded trip by trip (``analysis/trip.py``).

The matrix (:func:`matrix`): every ``pcg_variant`` x nrhs in {1, 8}
(``Solver.step`` and ``Solver.solve_many``) x {general, structured}, all
direct float64, one all-float32 program per backend, and mg on (general,
classic), (general, fused) and (structured, classic).  ``fast``: the
general backend, classic and fused, with its float32 program, and the
structured float32 program, whose matvecs are the slab kernel's (so the
card's fast gate proves one v6 launch a structured matvec).

The port's sums over parts are the identity in one process, so a
one-process recording would prove nothing about collectives: the matrix
is recorded by ONE spawn of two ``torch.distributed`` gloo ranks (each
holding one part, on ``cuda:(rank % device_count)`` or on the CPU), which
record every program and hand their recordings back as JSON.  The spawn
is bounded by a timeout; ranks still running then are killed.

Each program is solved four times on each rank: capped at k iterations
(unrecorded, so lazy set-up is done), at k and at k + 1 (the difference
of their totals must equal the longer run's last trip, an ``iterate``
trip), and to convergence, whose first ``check`` trip is the deferred
true-residual check.  The pipelined programs' first trip is their
``prime`` trip.

Run as ``python -m pcg_mpi_solver_tpu_torch.analysis.programs`` only by
:func:`build_programs` (the rank entry point).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from pcg_mpi_solver_tpu_torch.analysis.trip import (
    Trip, TripRecorder, difference)

#: the capped run's iterations (k) and the tolerances of the capped runs
#: (never reached) and of the converging run
CAP_ITERS = 3
TOL_CAPPED = 1e-30
TOL_CONVERGE = 1e-8
CONVERGE_ITERS = 400
#: the width of the blocked programs, and the spawn's bound (seconds)
NRHS_BLOCKED = 8
SPAWN_TIMEOUT_S = 600.0
WORLD = 2


@dataclasses.dataclass
class Program:
    """One recorded program on one rank: its configuration, the budgets
    it declares for each trip kind (``ops.trip_collective_budget``, the
    host reads of ``solver/pcg.trip_host_reads``, slab-kernel launches),
    and its recorded trips by kind."""

    name: str
    backend: str
    variant: str
    precond: str
    nrhs: int
    role: str                      # "f64" | "f32" (dtype-discipline)
    rank: int
    world: int
    device: str
    budgets: Dict[str, dict]       # kind -> {all_reduce, halo, halo_msgs}
    host_reads: Dict[str, int]     # kind -> declared host reads
    launches: Dict[str, int]       # kind -> declared kernel launches
    trips: Dict[str, Trip]         # kind -> recorded trip
    delta: Dict[str, int]          # (k + 1)-run totals minus k-run's
    iters: int = 0                 # the converging run's iterations

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["trips"] = {k: t.to_dict() for k, t in self.trips.items()}
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Program":
        d = dict(d)
        d["trips"] = {k: Trip.from_dict(t) for k, t in d["trips"].items()}
        return cls(**d)


def matrix(fast: bool = False) -> List[dict]:
    """The program specs (module docstring)."""
    specs = []
    backends = ("general",) if fast else ("general", "structured")
    variants = (("classic", "fused") if fast
                else ("classic", "fused", "pipelined"))
    for backend in backends:
        for variant in variants:
            for nrhs in (1, NRHS_BLOCKED):
                specs.append(dict(backend=backend, variant=variant,
                                  nrhs=nrhs, role="f64", precond="jacobi"))
        specs.append(dict(backend=backend, variant="classic", nrhs=1,
                          role="f32", precond="jacobi"))
    if fast:
        specs.append(dict(backend="structured", variant="classic", nrhs=1,
                          role="f32", precond="jacobi"))
    else:
        for backend, variant in (("general", "classic"),
                                 ("general", "fused"),
                                 ("structured", "classic")):
            for nrhs in (1, NRHS_BLOCKED):
                specs.append(dict(backend=backend, variant=variant,
                                  nrhs=nrhs, role="f64", precond="mg"))
    return specs


def program_name(spec: dict) -> str:
    mg = ",mg" if spec["precond"] == "mg" else ""
    return (f"trip[{spec['backend']},{spec['variant']}{mg},"
            f"nrhs={spec['nrhs']},{spec['role']}]")


# ---------------------------------------------------------------------------
# Solvers
# ---------------------------------------------------------------------------

_MODELS: dict = {}


def model_for(backend: str, precond: str = "jacobi"):
    """The JAX package's sizes: 3^3 on the general backend, 4^3 on the
    structured one (its slabs need nx divisible by the parts) and under
    mg (one 2:1 coarsening needs even dims)."""
    from pcg_mpi_solver_tpu_torch.models import make_cube_model

    nx = 4 if (backend == "structured" or precond == "mg") else 3
    if nx not in _MODELS:
        _MODELS[nx] = make_cube_model(nx, nx, nx)
    return _MODELS[nx]


def build_solver(backend: str = "general", device: Optional[str] = "cpu",
                 mesh=None, n_parts: int = 2, precond: str = "jacobi",
                 run_overrides: Optional[dict] = None, **solver_overrides):
    """A real quasi-static Solver of the matrix: one-shot dispatch
    (``iters_per_dispatch=0``) unless overridden.  ``device=None`` puts
    each rank on its own card (``mesh.device``)."""
    from pcg_mpi_solver_tpu_torch.config import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.solver.driver import Solver

    kw = dict(iters_per_dispatch=0, precond=precond)
    kw.update(solver_overrides)
    cfg = RunConfig(solver=SolverConfig(**kw), **(run_overrides or {}))
    return Solver(model_for(backend, kw["precond"]), cfg, n_parts=n_parts,
                  device=device, backend=backend, mesh=mesh)


def rhs_block(n_dof: int, nrhs: int, seed: int = 0):
    """A blocked program's columns: one seeded load, scaled by powers of
    two, so every column runs the same trips bit for bit."""
    import numpy as np

    f = np.random.default_rng(seed).standard_normal(n_dof)
    return f[:, None] * (2.0 ** np.arange(nrhs))[None, :]


def _run(solver, nrhs: int, max_iter: int, tol: float, fb=None) -> int:
    """One solve of the program at (max_iter, tol); returns iterations."""
    sc = dataclasses.replace(solver.config.solver, max_iter=int(max_iter),
                             tol=float(tol))
    solver.config = dataclasses.replace(solver.config, solver=sc)
    if nrhs == 1:
        solver.reset_state()
        return int(solver.step(1.0).iters)
    return int(solver.solve_many(fb).iters.max())


def record_program(solver, spec: dict, inject_read: bool = False,
                   cap: int = CAP_ITERS) -> Program:
    """Record ``spec``'s trips on ``solver`` (module docstring); raises
    ``RuntimeError`` when the difference of the capped runs is not the
    longer run's last trip."""
    from pcg_mpi_solver_tpu_torch.solver.pcg import trip_host_reads

    nrhs = int(spec["nrhs"])
    dev = solver.device.type
    fb = (rhs_block(solver.pm.glob_n_dof, nrhs) if nrhs > 1 else None)
    name = program_name(spec)

    def recorded(max_iter, tol):
        with TripRecorder(dev, profile=True,
                          inject_read=inject_read) as rec:
            iters = _run(solver, nrhs, max_iter, tol, fb)
        return rec, iters

    _run(solver, nrhs, cap, TOL_CAPPED, fb)
    short, _ = recorded(cap, TOL_CAPPED)
    long_, _ = recorded(cap + 1, TOL_CAPPED)
    conv, iters = recorded(CONVERGE_ITERS, TOL_CONVERGE)
    delta = difference(long_.totals(), short.totals())
    trips_long = long_.trips()
    if not trips_long or trips_long[-1].kind != "iterate":
        raise RuntimeError(f"{name}: the capped run's last trip is not an "
                           f"iterate trip ({[t.kind for t in trips_long]})")
    last = trips_long[-1]
    if last.counts() != delta:
        raise RuntimeError(
            f"{name}: the k + 1 run minus the k run ({delta}) is not its "
            f"last trip ({last.counts()}): set-up or finalize moved with "
            "the cap, so the recording cannot tell the loop apart")
    trips = {"iterate": last}
    checks = [t for t in conv.trips() if t.kind == "check"]
    if not checks:
        raise RuntimeError(f"{name}: the converging run ran no deferred "
                           "check trip")
    trips["check"] = checks[0]
    if spec["variant"] == "pipelined":
        if trips_long[0].kind != "prime":
            raise RuntimeError(f"{name}: the pipelined run did not start "
                               "with a priming trip")
        trips["prime"] = trips_long[0]
    blocked = nrhs > 1
    ops = solver.ops
    mv_extra = (2 * int(ops.mg_degree) if spec["precond"] == "mg" else 0)
    group = getattr(ops, "group", None)
    budgets, reads, launches = {}, {}, {}
    for kind in trips:
        budgets[kind] = ops.trip_collective_budget(
            spec["variant"], spec["precond"], kind, blocked)
        reads[kind] = trip_host_reads(spec["variant"], kind, blocked)
        launches[kind] = _declared_launches(solver, spec, kind, blocked,
                                            mv_extra)
    return Program(
        name=name, backend=spec["backend"], variant=spec["variant"],
        precond=spec["precond"], nrhs=nrhs, role=spec["role"],
        rank=group.rank if group is not None else 0,
        world=group.world if group is not None else 1, device=dev,
        budgets=budgets, host_reads=reads, launches=launches, trips=trips,
        delta=delta, iters=iters)


def _declared_launches(solver, spec, kind, blocked, mv_extra) -> int:
    """Slab-kernel launches a trip declares: one a structured matvec on
    the card (a block's columns ride one launch), none on the CPU, whose
    slab product is the plain version, or on the general operator."""
    from pcg_mpi_solver_tpu_torch.ops.matvec import trip_shape

    if solver.backend != "structured" or solver.device.type != "cuda":
        return 0
    mv, applies, _ = trip_shape(spec["variant"], kind, blocked)
    return mv + applies * mv_extra


# ---------------------------------------------------------------------------
# The two-rank spawn
# ---------------------------------------------------------------------------

def _child(argv: List[str]) -> int:
    """Rank entry point: ``addr rank world device out specs.json``."""
    addr, rank, world, device, out_path, spec_path = argv
    import torch

    torch.set_num_threads(1)
    from pcg_mpi_solver_tpu_torch.parallel.distributed import (
        init_distributed, make_global_mesh)

    init_distributed(addr, int(world), int(rank))
    mesh = make_global_mesh()
    with open(spec_path, encoding="utf-8") as f:
        specs = json.load(f)
    progs = []
    for spec in specs:
        s = build_solver(spec["backend"],
                         device="cpu" if device == "cpu" else None,
                         mesh=mesh, precond=spec["precond"],
                         pcg_variant=spec["variant"],
                         **({"dtype": "float32", "dot_dtype": "float32"}
                            if spec["role"] == "f32" else {}))
        if s.backend != spec["backend"]:
            raise RuntimeError(f"{program_name(spec)}: the solver took the "
                               f"{s.backend} backend")
        progs.append(record_program(s, spec).to_dict())
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(progs, f)
    return 0


_CACHE: Dict[tuple, List[Program]] = {}


def build_programs(fast: bool = False, device: str = "cpu",
                   specs: Optional[List[dict]] = None,
                   timeout: float = SPAWN_TIMEOUT_S) -> List[Program]:
    """Record the matrix (or ``specs``) on one spawn of two gloo ranks
    and return every rank's programs; cached per process.  ``device``
    "cuda" puts rank r on ``cuda:(r % device_count)``."""
    specs = list(specs if specs is not None else matrix(fast))
    key = (device, json.dumps(specs, sort_keys=True))
    if key in _CACHE:
        return _CACHE[key]
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PCG_TPU_")}
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    with tempfile.TemporaryDirectory(prefix="pcg_lint_") as tmp:
        spec_path = os.path.join(tmp, "specs.json")
        with open(spec_path, "w", encoding="utf-8") as f:
            json.dump(specs, f)
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(WORLD)]
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+",
                     encoding="utf-8") for r in range(WORLD)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", __name__, f"127.0.0.1:{port}", str(r),
             str(WORLD), device, outs[r], spec_path],
            stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=tmp)
            for r in range(WORLD)]
        t_end = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(t_end - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            r = bad[0]
            raise RuntimeError(
                f"recording rank {r} exited {procs[r].returncode} "
                f"(timeout {timeout:.0f} s):\n{texts[r][-4000:]}")
        progs = []
        for path in outs:
            with open(path, encoding="utf-8") as f:
                progs.extend(Program.from_dict(d) for d in json.load(f))
    _CACHE[key] = progs
    return progs


def print_counts(programs: List[Program], say=print) -> None:
    """One line a program, rank and trip kind: the per-trip counts."""
    for p in programs:
        for kind, trip in p.trips.items():
            c = trip.counts()
            launch = ", ".join(f"{k} {v}" for k, v in
                               sorted(trip.launches().items())) or "none"
            say(f"lint trip: {p.name} rank {p.rank} {kind}: "
                f"{c['all_reduce']} all-reduces, {c['halo']} plane "
                f"exchanges ({c['halo_msgs']} messages), "
                f"{c['host_reads']} host reads, {c['aten_ops']} aten ops, "
                f"{c['uploads']} uploads; launches {launch}")


# ---------------------------------------------------------------------------
# Signatures (fingerprint-completeness) and donation surfaces
# ---------------------------------------------------------------------------

def partition_digest(solver) -> str:
    """Content hash of the solver's partition (every array of it)."""
    from pcg_mpi_solver_tpu_torch.cache.keys import _hash_update

    h = hashlib.sha256()
    _hash_update(h, solver.pm)
    return h.hexdigest()


def program_signature(solver) -> str:
    """Digest of what a field can change in a solve: every trip of one
    step (its kind, and each op's name, dtypes, shapes and counter
    increments) and the solution's bits.  Set-up and dispatch cadence
    are not in it: they change no trip and no bit."""
    solver.reset_state()
    with TripRecorder(solver.device.type, profile=False) as rec:
        solver.step(1.0)
    h = hashlib.sha256()
    for trip in rec.trips():
        h.update(trip.kind.encode())
        for o in trip.ops:
            h.update(json.dumps([o["op"], o["dt"], o["sh"],
                                 o.get("n", {})]).encode())
    h.update(solver.un.detach().cpu().numpy().tobytes())
    return h.hexdigest()


#: surfaces whose handoff allocates by design, with the reason (the
#: donation-integrity rule lists them and checks the others)
UNDONATED_SURFACES = {
    "mixed refine (f64 iterate)": (
        "the refine writes x + xinc into a new tensor: the iterate it "
        "replaces is the one the recovery ladder's restart copy "
        "(good_x) and a boundary snapshot were taken from, and the "
        "float64 correction must not overwrite it in place; the f32 "
        "inner carry, which the cycles hand on, is checked"),
}


def donation_calls(surface: str, copy_carry: bool = False,
                   device: str = "cpu") -> List[dict]:
    """The capped dispatches of one chunked surface, each as ``{"in":
    id of the carry dict it was handed, "out": id of the carry dict it
    returned, "cin" / "cout": {vector leaf: storage address}}``.
    ``copy_carry``, the seeded violation, clones the carry a dispatch
    hands on before the next one takes it.  One process, two parts, on
    ``device``."""
    import torch

    from pcg_mpi_solver_tpu_torch.solver import chunked, driver

    def storages(carry):
        return {k: v.untyped_storage().data_ptr()
                for k, v in (carry or {}).items()
                if isinstance(v, torch.Tensor) and v.dim() >= 2
                and v.numel()}

    calls: List[dict] = []
    keep: list = []

    def wrap(orig):
        def wrapped(*a, **k):
            handed = k.get("carry_in")
            used = handed
            if handed is not None and copy_carry:
                used = {n: (v.clone() if isinstance(v, torch.Tensor)
                            else v) for n, v in handed.items()}
                k["carry_in"] = used
            res, out = orig(*a, **k)
            keep.extend([handed, used, out])
            calls.append({"in": id(handed), "out": id(out),
                          "cin": storages(used), "cout": storages(out)})
            return res, out
        return wrapped

    blocked = surface.startswith("chunked blocked")
    owner = driver if blocked else chunked
    attr = "pcg_many" if blocked else "pcg"
    orig = getattr(owner, attr)
    setattr(owner, attr, wrap(orig))
    try:
        s = build_solver("general", device=device, n_parts=2,
                         iters_per_dispatch=3, donate_carry=True,
                         tol=1e-8,
                         **({"precision_mode": "mixed"}
                            if surface.startswith("mixed") else {}))
        if blocked:
            s.solve_many(rhs_block(s.pm.glob_n_dof, 4))
        else:
            s.step(1.0)
    finally:
        setattr(owner, attr, orig)
    return calls


DONATION_SURFACES = ("chunked direct cycle (carry)",
                     "chunked blocked cycle (blocked carry)",
                     "mixed inner cycle (f32 carry)")


def donation_handoffs(calls: List[dict]) -> List[tuple]:
    """(dispatch, next dispatch) pairs where the next one was handed the
    carry the first returned (a new refinement cycle's cold carry, or a
    ladder restart's, is not a handoff)."""
    return [(a, b) for a, b in zip(calls, calls[1:]) if b["in"] == a["out"]]


def check_donation(surface: str, calls: List[dict]) -> List[str]:
    """Errors for one surface: at every handoff, each vector leaf the
    next dispatch takes must be the storage the last one returned (no
    copy between dispatches); a surface with no handoff of a vector leaf
    proves nothing and is an error too."""
    errs = []
    pairs = 0
    for a, b in donation_handoffs(calls):
        for leaf, ptr in b["cin"].items():
            if leaf not in a["cout"]:
                continue
            pairs += 1
            if a["cout"][leaf] != ptr:
                errs.append(f"{surface}: carry leaf {leaf!r} was copied "
                            "between dispatches (the next dispatch took "
                            "another storage than the last one returned)")
    if pairs == 0:
        errs.append(f"{surface}: {len(calls)} dispatch(es), no vector "
                    "leaf handed from one to the next: nothing checked")
    return errs


def donation_pairs(calls: List[dict]) -> int:
    return sum(1 for a, b in donation_handoffs(calls)
               for leaf in b["cin"] if leaf in a["cout"])


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1:]))

