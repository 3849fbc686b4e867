"""One run of one cell: inputs, set-up, the measured window, the traced
call, the judgement, and the result line.

Stages (``run``):

1. Inputs: the configuration's model from its frozen generator (or the
   model cache), and the traffic's loads drawn from the seed by its rule.
2. Set-up: the port's ``Solver`` built as a user builds it, with the
   configuration's settings, then the program's own ``Solver.warmup()``.
   ``setup_s`` runs from the process's start to the window's first call.
3. Window: whole calls of the traffic's entry (``entries/``: a load case
   through ``Solver.step`` from a zeroed state, or a block through
   ``Solver.solve_many``) back to back; a call starts only while
   ``seconds`` have not run out, and every call begun is counted to its
   end.  Each call's loads are built on the host before its wall; the wall
   ends in a device sync, and the answer is fetched after it.
4. With ``trace``: one more call inside a ``torch.profiler`` capture,
   after the window, since a profiled process runs its later solves slower.
5. The peak memory is read, the program freed, and every answer judged by
   the plain reference (``reference/``) on the same device.

The measuring path needs the card: ``main`` exits without a result where
there is none.  ``run(..., device="cpu")`` drives the same stages on the
CPU for the tests.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from cardbench import inputs
from cardbench.inputs.loads import Loads, column_vector, pattern_vectors
from cardbench.metrics import _profile
from cardbench.registry import REPO, Registry

#: top-level module names that no run may load (the JAX package's name is a
#: prefix of the port's, so names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "pcg_mpi_solver_tpu")

CASE_RANGE = "cardbench/case"


class NoDevice(RuntimeError):
    """The card the cell asks for is not there."""


class Departure(RuntimeError):
    """The program ran otherwise than the configuration states."""


class Forbidden(RuntimeError):
    """JAX or the JAX package is loaded."""


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def log(msg: str) -> None:
    print(f"[cardbench] {msg}", file=sys.stderr, flush=True)


def port_model(model):
    """The frozen generator's model as the port's own ``ModelData``."""
    from pcg_mpi_solver_tpu_torch.models.model_data import ModelData

    names = {f.name for f in dataclasses.fields(ModelData)}
    return ModelData(**{f.name: getattr(model, f.name)
                        for f in dataclasses.fields(model)
                        if f.name in names})


def mesh_counts(model, config: dict, block: int) -> dict:
    """The counts ``metrics/_roofline.py`` needs: dofs, elements, the unit
    matrices' entries, the inner matvec's itemsize, the block width."""
    sc = config["solver"]
    inner = ("float32" if sc.get("precision_mode", "mixed") == "mixed"
             else sc.get("dtype", "float64"))
    return {"n_dof": int(model.n_dof), "n_elem": int(model.n_elem),
            "ke_entries": int(sum(np.asarray(lib["Ke"]).size
                                  for lib in model.elem_lib.values())),
            "itemsize": 4 if inner == "float32" else 8, "block": block}


@dataclasses.dataclass
class Call:
    """One call of the window or the traced one: its columns, wall, trips,
    flags and host answers (n_dof, block)."""
    cols: list
    wall: float
    trips: int
    flags: list
    u: np.ndarray


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _call(solver, entry, loads: Loads, k: int, patterns: dict,
          device) -> Call:
    """Call k of the run through the traffic's entry; the wall ends in a
    device sync, the answer is fetched after it."""
    cols = loads.case(k)
    fb = np.stack([column_vector(c, patterns) for c in cols], axis=1)
    t = time.perf_counter()
    trips, flags, handle = entry.solve(solver, fb)
    _sync(device)
    wall = time.perf_counter() - t
    return Call(cols, wall, trips, flags, entry.answer(solver, handle))


def _profiled_call(solver, entry, loads, k, patterns, device):
    """Call k inside a torch.profiler capture; returns (call, summary)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(CASE_RANGE):
            call = _call(solver, entry, loads, k, patterns, device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        del prof
        log(f"trace: {os.path.getsize(path) / 2**20:.1f} MiB")
        events = _profile.read_trace(path)
    finally:
        os.unlink(path)
    return call, _profile.summarize(events, CASE_RANGE)


def _judge(model, calls, patterns, ud, device) -> list:
    """relres of every answer of every call, by the plain reference, each
    against its column's load built anew from the seed."""
    from cardbench.reference.judge import Judge
    from cardbench.reference.operator import ElementOperator

    judge = Judge(model, ElementOperator(model, device=device))
    return [judge.relres(c.u[:, j], column_vector(col, patterns), ud)
            for c in calls for j, col in enumerate(c.cols)]


def run(cell_name: str, seed: int, seconds: float, trace: bool, *,
        root: Path = REPO, device: str = "cuda", t_start: float | None = None,
        solver_overrides: dict | None = None) -> dict:
    """One run of cell ``cell_name``; returns the result line's object."""
    t_start = time.perf_counter() if t_start is None else t_start
    reg = Registry(root)
    cell = reg.cell(cell_name)
    config = reg.config(cell["config"])
    traffic = reg.traffic(cell["traffic"])
    entry = reg.module("entries", traffic["entry"])
    loads = Loads(traffic, seed, reg.module("rules", traffic["load"]["rule"]),
                  entry)

    import torch

    log(f"torch {torch.__version__} imported "
        f"({time.perf_counter() - t_start:.2f} s from start)")
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        raise NoDevice(f"cell {cell_name} needs {cell['chips']} CUDA "
                       "device(s); torch.cuda finds "
                       f"{torch.cuda.device_count()}")
    if config.get("kernel"):
        # the port reads its slab kernel from this variable at Solver()
        os.environ["PCG_TPU_PALLAS_V"] = config["kernel"].removeprefix("v")
    from pcg_mpi_solver_tpu_torch.config import (
        RunConfig, SolverConfig, TimeHistoryConfig)
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.solver.driver import Solver

    log(f"port imported ({time.perf_counter() - t_start:.2f} s from start)")

    # ---- inputs
    cache = reg.pkg / ".cache"
    model = inputs.build_model(config, cache / "models", reg)
    patterns = pattern_vectors(model.F)
    log(f"inputs: {config['name']} {model.n_dof} dofs, {model.n_elem} "
        f"elements ({time.perf_counter() - t_start:.2f} s from start)")

    # ---- set-up
    sc = dict(config["solver"], **(solver_overrides or {}))
    sc["nrhs"] = loads.block
    rc = RunConfig(solver=SolverConfig(**sc),
                   time_history=TimeHistoryConfig(time_step_delta=[0.0, 1.0]))
    rc.cache_dir = (str(cache / "partitions")
                    if config.get("partition_cache") else "")
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    spans = {}
    t = time.perf_counter()
    solver = Solver(port_model(model), rc, n_parts=config["n_parts"],
                    device=device, backend=config["backend"])
    spans["partition"] = [time.perf_counter() - t]
    if solver.backend != config["backend"]:
        raise Departure(f"backend {solver.backend}, configured "
                        f"{config['backend']}")
    if config.get("kernel") and solver.kernel_variant != config["kernel"]:
        raise Departure(f"kernel {solver.kernel_variant}, configured "
                        f"{config['kernel']}")
    try:
        entry.prepare(solver, model)
    except ValueError as e:
        raise Departure(str(e)) from e
    t = time.perf_counter()
    solver.warmup()
    spans["warmup"] = [time.perf_counter() - t]
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (Solver {spans['partition'][0]:.3f} s, "
        f"setup_cache {solver.setup_cache}, warmup "
        f"{spans['warmup'][0]:.3f} s)")

    # ---- window
    reset_launch_counts()
    calls = []
    t_w0 = time.perf_counter()
    while not calls or time.perf_counter() - t_w0 < seconds:
        calls.append(_call(solver, entry, loads, len(calls), patterns,
                           device))
        c = calls[-1]
        log(f"call {len(calls) - 1}: {c.wall:.4f} s, {c.trips} trips, "
            f"flags {c.flags}")
    window_s = time.perf_counter() - t_w0
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    launches = {f"{v} {d}": n for (v, d), n in LAUNCHES.items() if n}
    trips = sum(c.trips for c in calls)
    log(f"window {window_s:.3f} s: {len(calls)} calls, {trips} trips, "
        f"launches {launches}")
    if (device == "cuda" and config.get("kernel")
            and sum(n for (v, _d), n in LAUNCHES.items()
                    if v == config["kernel"]) < trips):
        raise Departure(f"the configured kernel {config['kernel']} ran "
                        f"fewer times than the window's {trips} trips: "
                        f"{launches}")

    # ---- traced call
    profile = None
    judged = list(calls)
    if trace:
        call, summary = _profiled_call(solver, entry, loads, len(calls),
                                       patterns, device)
        judged.append(call)
        profile = ({"trips": call.trips, "summary": summary}
                   if summary else None)
        log(f"traced call: {call.wall:.4f} s, {call.trips} trips")

    found = forbidden_modules()
    if found:
        raise Forbidden("modules of JAX or of the JAX package are loaded: "
                        + ", ".join(found))

    # ---- free the program, then judge every answer
    del solver
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    relres = _judge(model, judged, patterns, entry.dirichlet(model),
                    device)
    log(f"judged {len(relres)} load cases in "
        f"{time.perf_counter() - t:.2f} s")

    # a load case fails when its solve did not converge or its answer
    # misses the tolerance (flags and relres are in the same case order)
    tol = float(sc["tol"])
    flags = [f for c in judged for f in c.flags]
    failed = sum(1 for f, r in zip(flags, relres) if f != 0 or not r <= tol)
    checks = {
        "relres_max": {"value": max(relres, key=lambda r: r if r == r
                                    else math.inf), "limit": tol},
        "not_converged": {"value": sum(1 for f in flags if f != 0),
                          "limit": 0},
    }
    record = {
        "spans": dict(spans, case=[c.wall for c in calls]),
        "counters": {"cases": len(calls) * loads.block,
                     "calls": len(calls), "trips": trips},
        "setup_s": setup_s,
        "peak_bytes": peak,
        "profile": profile,
        "mesh": mesh_counts(model, config, loads.block),
        "device_kind": (torch.cuda.get_device_name(0) if device == "cuda"
                        else "cpu"),
    }
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in reg.metrics(cell_name, kind):
        v = reg.reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": record["device_kind"],
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(peak)}
    out = {"correct": failed == 0, "attempted": len(relres),
           "failed": failed,
           "metrics": metrics, "device": dev}
    if profile:
        s = profile["summary"]
        dev["busy_s"] = s["busy_us"] * 1e-6
        dev["window_s"] = s["window_us"] * 1e-6
        # kernel names cut to 200 characters (C++ template names run to
        # many hundreds)
        out["breakdown"] = {
            "device_ops": [[n[:200], v * 1e-6] for n, v in
                           _profile.top(s["by_name_us"])],
            "idle_gaps": [[n, v * 1e-6] for n, v in
                          _profile.top(s["gaps_us"])]}
    out["checks"] = checks
    return out


def main(argv=None, t_start=None) -> int:
    """The command: one run, the result as the last line of standard
    output and each compared number with its limit as the last lines of
    standard error."""
    import argparse
    import json
    import traceback

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the result line must be the last line of standard output: whatever
    # the program prints goes to standard error
    sys.stdout.flush()
    out_fd = os.dup(1)
    os.dup2(2, 1)
    try:
        res = run(args.workload, args.seed, args.seconds, bool(args.trace),
                  t_start=t_start)
    except NoDevice as e:
        log(f"no result: {e}")
        return 3
    except Departure as e:
        log(f"no result: the run departs from its configuration: {e}")
        return 5
    except Forbidden as e:
        log(f"no result: {e}")
        return 4
    except Exception:                                   # noqa: BLE001
        traceback.print_exc()
        log("no result: the run failed")
        return 1
    found = forbidden_modules()
    if found:
        log("no result: modules of JAX or of the JAX package are loaded: "
            + ", ".join(found))
        return 4
    for name, c in res["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    os.write(out_fd, (json.dumps(res) + "\n").encode())
    os.close(out_fd)
    return 0
