"""Inner cycles of mixed Newmark and mixed quasi-static solves, on each
device and part count, to compare the card's iteration totals with the
spread that round-off alone gives on the CPU.

The Newmark case is ``tests/test_torch_cuda.py::
test_newmark_on_card_matches_cpu``'s: the 12x6x5 cube (``seed=5``), dt
0.2, damping 0.1, tol 1e-12, ``TIME_DELTAS``, mixed, at
``iters_per_dispatch`` 0 (one-shot) and 7 (chunked).  The quasi-static
cases are ``test_windowed_mixed_solve_on_card_matches_cpu``'s 16x6x6
cube at tol 1e-8, inner_tol 1e-6: no window, plateau 25, progress 10.

    python tools/newmark_drift.py [--devices cpu,cuda] [--parts 1,2]
        [--jax] [--exact-f32] [--out build/newmark_drift.json]

For each (case, device, parts, iters_per_dispatch) it prints one line a
step: flag, iterations and the inner cycles as (exit flag, iterations);
then each case's totals side by side and the first step and cycle at
which a device's cycles leave the CPU's at the same part count.  ``--jax``
adds the JAX package's totals a step (CPU only; needs JAX, which the
machine with the card does not have).  ``--exact-f32`` adds one-shot
Newmark runs on each device whose f32 operator returns the float64
operator's product rounded to float32 (the most accurate f32 matvec
there is): if the card's totals are set by its f32 arithmetic, these
land beside the card's.  Each device also prints ``accuracy`` lines:
the f32 operator's and the f32 dot's error against float64 on one
seeded vector.  The whole table goes to ``--out`` as JSON.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig  # noqa: E402
from pcg_mpi_solver_tpu_torch.models import make_cube_model  # noqa: E402
from pcg_mpi_solver_tpu_torch.solver import (  # noqa: E402
    NewmarkSolver, Solver)
import pcg_mpi_solver_tpu_torch.solver.pcg as pcgmod  # noqa: E402

TIME_DELTAS = [0.5, 1.0, 1.0, 0.7, 0.3]
NEWMARK_CUBE = ((12, 6, 5), dict(E=30e9, nu=0.2, heterogeneous=True, seed=5,
                                 load_value=1e6))
STATIC_CUBE = ((16, 6, 6), dict(E=30e9, heterogeneous=True, seed=5,
                                load_value=1e6))
STATIC_CASES = {"static": {},
                "static-plateau25": dict(mixed_plateau_window=25),
                "static-progress10": dict(mixed_progress_window=10)}


class CycleLog:
    """Records (exit flag, executed iterations) of every inner f32 cycle
    of the one-shot mixed shell (``pcg_mixed`` calls the module's
    ``pcg``)."""

    def __init__(self):
        self.cycles = []
        self._pcg = pcgmod.pcg

    def __enter__(self):
        def logged(*a, **kw):
            out = self._pcg(*a, **kw)
            if kw.get("return_carry"):
                res, carry = out
                self.cycles.append((int(res.flag),
                                    int(max(carry["exec"], 1))))
            return out
        pcgmod.pcg = logged
        return self

    def __exit__(self, *exc):
        pcgmod.pcg = self._pcg

    def take(self):
        out, self.cycles = self.cycles, []
        return out


def _chunked_cycles(log):
    """Inner cycles of a chunked step from its dispatch log: each
    ``("refine", inner_flag, cycle_iters)`` entry ends one cycle."""
    return [(int(e[1]), int(e[2])) for e in log if e[0] == "refine"]


class ExactF32:
    """An f32 operator whose matvec is the float64 operator's product
    rounded to float32."""

    def __init__(self, ops32, ops64, data64):
        self._ops32, self._ops64, self._data64 = ops32, ops64, data64

    def __getattr__(self, name):
        return getattr(self._ops32, name)

    def matvec(self, data, x):
        return self._ops64.matvec(self._data64, x.double()).float()


def _newmark(device, parts, ipd):
    model = make_cube_model(*NEWMARK_CUBE[0], **NEWMARK_CUBE[1])
    cfg = RunConfig(solver=SolverConfig(tol=1e-12, max_iter=2000,
                                        iters_per_dispatch=ipd,
                                        precision_mode="mixed"))
    return NewmarkSolver(model, cfg, n_parts=parts, dt=0.2, damping=0.1,
                         device=device)


def accuracy(device, parts):
    """(max |A32 v - A64 v| / max |A64 v|, |dot32 - dot64| / |dot64|) on
    one seeded vector v of the Newmark operator A = K + c M."""
    import torch

    s = _newmark(device, parts, 0)
    rng = np.random.default_rng(0)
    v = torch.as_tensor(rng.normal(size=(s.pm.n_parts, s.pm.n_loc)),
                        device=s.data["eff"].device) * s.data["eff"]
    y64 = s.ops.matvec(s.data, v)
    y32 = s.ops32.matvec(s.data32, v.float())
    mv = float((y32.double() - y64).abs().max() / y64.abs().max())
    w = s.data["weight"] * s.data["eff"]
    d64 = float(s.ops.wdot(w, y64, v))
    d32 = float(s.ops32.wdot(w.float(), y32, v.float()))
    return mv, abs(d32 - d64) / abs(d64)


def newmark_run(device, parts, ipd, exact_f32=False):
    s = _newmark(device, parts, ipd)
    if exact_f32:
        s.ops32 = ExactF32(s.ops32, s.ops, s.data)
    steps = []
    with CycleLog() as log:
        for delta in TIME_DELTAS:
            r = s.step(delta)
            cyc = log.take() if ipd == 0 else _chunked_cycles(
                s.dispatch_log)
            steps.append(dict(flag=int(r.flag), iters=int(r.iters),
                              cycles=cyc))
    u = s.displacement_global()
    return steps, float(np.abs(u).sum())


def static_run(device, parts, opts):
    model = make_cube_model(*STATIC_CUBE[0], **STATIC_CUBE[1])
    cfg = RunConfig(solver=SolverConfig(tol=1e-8, max_iter=2000,
                                        precision_mode="mixed",
                                        inner_tol=1e-6, **opts))
    s = Solver(model, cfg, n_parts=parts, device=device)
    with CycleLog() as log:
        r = s.step(1.0)
        cyc = log.take()
    return [dict(flag=int(r.flag), iters=int(r.iters), cycles=cyc)], \
        float(np.abs(s.displacement_global()).sum())


def jax_newmark(parts):
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from pcg_mpi_solver_tpu.config import RunConfig as JRC
    from pcg_mpi_solver_tpu.config import SolverConfig as JSC
    from pcg_mpi_solver_tpu.models import make_cube_model as jcube
    from pcg_mpi_solver_tpu.parallel.mesh import make_mesh
    from pcg_mpi_solver_tpu.solver.newmark import NewmarkSolver as JN

    out = {}
    for ipd in (0, 7):
        m = jcube(*NEWMARK_CUBE[0], **NEWMARK_CUBE[1])
        s = JN(m, JRC(solver=JSC(tol=1e-12, max_iter=2000,
                                 iters_per_dispatch=ipd,
                                 precision_mode="mixed")),
               mesh=make_mesh(parts), n_parts=parts, dt=0.2, damping=0.1)
        res = s.run(TIME_DELTAS)
        out[ipd] = [dict(flag=int(r.flag), iters=int(r.iters), cycles=None)
                    for r in res]
    return out


def first_divergence(a, b):
    """(step, cycle) of the first inner cycle where ``a`` and ``b`` differ,
    or None."""
    for i, (sa, sb) in enumerate(zip(a, b)):
        ca, cb = sa["cycles"] or [], sb["cycles"] or []
        for j in range(max(len(ca), len(cb))):
            if j >= len(ca) or j >= len(cb) or tuple(ca[j]) != tuple(cb[j]):
                return i, j
        if sa["iters"] != sb["iters"]:
            return i, len(ca)
    return None


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", default="cpu,cuda")
    ap.add_argument("--parts", default="1,2")
    ap.add_argument("--jax", action="store_true")
    ap.add_argument("--exact-f32", action="store_true")
    ap.add_argument("--out", default="build/newmark_drift.json")
    args = ap.parse_args()
    devices = args.devices.split(",")
    parts = [int(p) for p in args.parts.split(",")]
    table = {}

    def record(case, dev, p, ipd, steps, usum, wall):
        key = f"{case}|{dev}|P{p}|ipd{ipd}"
        table[key] = dict(steps=steps, usum=usum, wall_s=wall)
        for i, st in enumerate(steps):
            print(f"{key} step {i}: flag {st['flag']} iters {st['iters']} "
                  f"cycles {st['cycles']}", flush=True)
        print(f"{key} total {sum(s['iters'] for s in steps)} "
              f"sum|u| {usum!r} ({wall:.1f} s)", flush=True)

    for dev in devices:
        for p in parts:
            mv, dot = accuracy(dev, p)
            print(f"accuracy {dev} P{p}: f32 matvec {mv:.3e} of max|A v|, "
                  f"f32 dot {dot:.3e}", flush=True)
            table[f"accuracy|{dev}|P{p}"] = dict(matvec=mv, dot=dot)
            if args.exact_f32:
                t0 = time.perf_counter()
                steps, usum = newmark_run(dev, p, 0, exact_f32=True)
                record("newmark-exactf32", dev, p, 0, steps, usum,
                       time.perf_counter() - t0)
            for ipd in (0, 7):
                t0 = time.perf_counter()
                steps, usum = newmark_run(dev, p, ipd)
                record("newmark", dev, p, ipd, steps, usum,
                       time.perf_counter() - t0)
            for case, opts in STATIC_CASES.items():
                t0 = time.perf_counter()
                steps, usum = static_run(dev, p, opts)
                record(case, dev, p, 0, steps, usum,
                       time.perf_counter() - t0)
    if args.jax:
        for p in parts:
            t0 = time.perf_counter()
            for ipd, steps in jax_newmark(p).items():
                record("newmark", "jax-cpu", p, ipd, steps, None,
                       time.perf_counter() - t0)

    print("totals:")
    groups = {}
    for key, v in table.items():
        if key.startswith("accuracy|"):
            continue
        case, dev, p, ipd = key.split("|")
        groups.setdefault((case, ipd), {})[(dev, p)] = v
    for (case, ipd), runs in groups.items():
        tot = {f"{d}/{p}": sum(s["iters"] for s in v["steps"])
               for (d, p), v in runs.items()}
        cpu = [t for k, t in tot.items() if k.startswith("cpu/")]
        spread = (max(cpu) - min(cpu)) / min(cpu) if cpu else None
        print(f"  {case} {ipd}: {tot}; CPU spread over part counts "
              f"{spread if spread is None else round(100 * spread, 2)} %")
        for (d, p), v in runs.items():
            ref = runs.get(("cpu", p))
            if d == "cpu" or ref is None or v["steps"][0]["cycles"] is None:
                continue
            print(f"    {d}/{p} first differs from cpu/{p} at (step, "
                  f"cycle) {first_divergence(v['steps'], ref['steps'])}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(table, f, indent=1)


if __name__ == "__main__":
    main()
