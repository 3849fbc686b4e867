#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (pcg_mpi_solver_tpu_torch) on one
NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero):
  1. device   — the card's name and power limit;
  2. build    — compile every CUDA kernel of the port from csrc/, all at
                once, and echo each one's registers, spills and shared
                memory;
  3. kernels  — each kernel against its plain PyTorch version on the card:
                the nine float32 variants (v6, v1-v5, v7-v9) and v6's
                float64 kernel, on ragged shapes, two parts, and every
                slab shape phases 4 and 5 give it in that dtype, two
                launches bitwise equal, with CUDA-event times and the
                card's bound; the chunked variants (v3, v4, v5, v7, v8,
                v9) also at 16 planes a chunk;
  4. main     — the flagship structured cube (150^3 cells, 10,328,853
                dofs) solved in mixed precision through ``Solver`` once
                under each of the nine float32 variants
                (``PCG_TPU_PALLAS_V``), v6 last, with the kernel launch
                counts of each solve; then a profiled window of inner f32
                iterations under v6;
  5. checks   — a direct float64 solve (48x32x32) to flag 0, and small
                mixed and direct solves on the card against the same
                solves on the CPU (the plain path).
The line before the last is the per-kernel JSON record (one per variant
and dtype, launch counts from the solve under that variant), the last line
{"ok": true, "device": {...}}.  Without a CUDA device the script exits 1
and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

# NVIDIA data-sheet rates of the H100 SXM (dense, no sparsity, at the full
# power limit): memory bytes/s, float32 and float64 FLOP/s on the CUDA cores.
H100_SXM = ("H100 80GB HBM3", 3.35e12, 67e12, 34e12)

FLAGSHIP = dict(nx=150, E=30e9, nu=0.2, load="traction", load_value=1e6,
                heterogeneous=True)
DIRECT_F64_CELLS = (48, 32, 32)     # phase 5's direct float64 solve
CARD_VS_CPU_CELLS = (12, 6, 5)      # phase 5's card-against-CPU solves
# The JAX package's record of the same solve (docs/HW_SESSION.log:134):
# flag 0, 3334 iterations, relres 4.989e-08.
JAX_FLAGSHIP_ITERS = 3334

KERNEL_TOL = {"float32": 2e-5, "float64": 1e-12}   # x max|y_plain|
# The float32 kernels, v6 (the default) first, and the JAX wrapper each
# replaces; float64 runs v6's double kernel under every variant.
F32_VARIANTS = ("v6", "v1", "v2", "v3", "v4", "v5", "v7", "v8", "v9")
PALLAS = "pcg_mpi_solver_tpu/ops/pallas_matvec.py"
REPLACES = {"v1": f"{PALLAS}:214", "v2": f"{PALLAS}:324",
            "v3": f"{PALLAS}:456", "v4": f"{PALLAS}:774",
            "v5": f"{PALLAS}:730", "v6": f"{PALLAS}:940",
            "v7": f"{PALLAS}:1094", "v8": f"{PALLAS}:1227",
            "v9": f"{PALLAS}:1410"}
# phase 3 runs the chunked variants at 16 planes a chunk on this shape too,
# so the ragged tail chunk is exercised (34 node planes)
RAGGED_PLANES = ((2, 33, 17, 9), 16)
ITERS_TOL = 0.05        # flagship iterations within 5 % of JAX's


def say(msg: str) -> None:
    print(msg, flush=True)


def card_rates(name: str):
    if H100_SXM[0] not in name:
        raise RuntimeError(f"no data-sheet rates for card {name!r}; the "
                           f"bounds are written for {H100_SXM[0]}")
    return H100_SXM


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, with L2 flushed before each
    (a 256 MB write: the solver finds x cold, as the PCG loop touches
    several other vectors between matvecs)."""
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def matvec_bound_ms(shape, itemsize: int, bw: float, flops: float):
    """Least time for one slab matvec on this card: each input read once
    (x, ck, Ke), each output written once (y), against 24*24 FMAs per
    cell at the CUDA-core rate.  Returns (ms, "bytes"|"operations")."""
    P, nx, ny, nz = shape
    nodes = P * (nx + 1) * (ny + 1) * (nz + 1)
    cells = P * nx * ny * nz
    nbytes = itemsize * (2 * 3 * nodes + cells + 24 * 24)
    nops = 2 * 24 * 24 * cells
    t_bytes, t_ops = nbytes / bw * 1e3, nops / flops * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def kernel_shapes():
    """(P, nx, ny, nz) the kernel is held to its plain version at, per
    dtype: two ragged ones (one with two parts), then every slab shape a
    driven path gives the kernel in that dtype (phase 4's flagship in both;
    phase 5's card-against-CPU cube in both, as its direct solve runs
    float64 and its mixed solve both; phase 5's direct solve in float64)."""
    n = FLAGSHIP["nx"]
    ragged = [(1, 7, 3, 5), (2, 33, 17, 9)]
    small, flag = (1, *CARD_VS_CPU_CELLS), (1, n, n, n)
    return {"float32": ragged + [small, flag],
            "float64": ragged + [small, (1, *DIRECT_F64_CELLS), flag]}


def phase_kernels(torch, np, rates):
    """Each kernel against the plain version at every shape of
    kernel_shapes(); returns the flagship record per (variant, dtype)."""
    from pcg_mpi_solver_tpu_torch.models.element import unit_element_library
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        VARIANTS, structured_matvec, structured_matvec_plain)

    _label, bw, f32_rate, f64_rate = rates
    rng = np.random.default_rng(2024)
    Ke = unit_element_library(FLAGSHIP["nu"])["Ke"]
    shapes = kernel_shapes()
    out = {}
    for dtype, rate in ((torch.float32, f32_rate), (torch.float64, f64_rate)):
        name = str(dtype).removeprefix("torch.")
        tol = KERNEL_TOL[name]
        variants = F32_VARIANTS if dtype == torch.float32 else ("v6",)
        for shape in shapes[name]:
            P, nx, ny, nz = shape
            x = torch.as_tensor(rng.standard_normal((P, 3, nx + 1, ny + 1,
                                                     nz + 1)),
                                dtype=dtype, device="cuda")
            ck = torch.as_tensor(rng.uniform(1.0, 10.0, (P, nx, ny, nz)),
                                 dtype=dtype, device="cuda")
            K = torch.as_tensor(Ke, dtype=dtype, device="cuda")
            y_plain = structured_matvec_plain(x, ck, K)
            scale = y_plain.abs().max().item()
            plain_ms = time_ms(torch,
                               lambda: structured_matvec_plain(x, ck, K))
            bound_ms, bound_by = matvec_bound_ms(
                shape, x.element_size(), bw, rate)
            say(f"kernel {name} P={P} cells=({nx},{ny},{nz}): plain "
                f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.4g} us "
                f"({bound_by})")
            plane_runs = [(v, None) for v in variants]
            if shape == RAGGED_PLANES[0] and dtype == torch.float32:
                plane_runs += [(v, RAGGED_PLANES[1]) for v in variants
                               if VARIANTS[v][1]]
            for v, planes in plane_runs:
                def run():
                    return structured_matvec(x, ck, K, variant=v,
                                             planes=planes)
                y, y2 = run(), run()
                torch.cuda.synchronize()
                err = (y - y_plain).abs().max().item()
                same = torch.equal(y, y2)
                ok = err <= tol * scale and same
                ms = time_ms(torch, run)
                tag = v if planes is None else f"{v} planes={planes}"
                say(f"  {tag}: max|err| {err:.3e} vs tol {tol:g} x max|y| "
                    f"{scale:.3e}, repeat bitwise "
                    f"{'equal' if same else 'DIFFERENT'} -> "
                    f"{'ok' if ok else 'FAIL'}; kernel {ms:.4f} ms, "
                    f"{bound_ms / ms:.2%} of bound")
                if not ok:
                    raise AssertionError(f"{tag} {name} {shape} disagrees "
                                         f"with its plain version or with "
                                         f"itself")
                if shape == shapes[name][-1] and planes is None:
                    # the main path's shape
                    out[(v, name)] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=bound_ms, bound_by=bound_by)
                del y, y2
            del x, ck, y_plain
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def inner_cycles():
    """Records (flag, iterations) of every f32 inner cycle that
    ``pcg_mixed`` runs inside the block.  The flagship's cycles end on
    stagnation exits (flag 3), whose iteration depends on round-off, so
    this is where the variants' totals part."""
    import pcg_mpi_solver_tpu_torch.solver.pcg as pcg_mod

    cycles, inner = [], pcg_mod.pcg

    def recorded(*args, **kwargs):
        out = inner(*args, **kwargs)
        res = out[0] if isinstance(out, tuple) else out
        cycles.append((res.flag, res.iters))
        return out

    pcg_mod.pcg = recorded
    try:
        yield cycles
    finally:
        pcg_mod.pcg = inner


def phase_main(torch, np):
    """The flagship mixed solve once under each float32 variant; returns
    {variant: launch counts of its solve}."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    kw = dict(FLAGSHIP)
    nx = kw.pop("nx")
    t0 = time.perf_counter()
    model = make_cube_model(nx, **kw)
    model_s = time.perf_counter() - t0
    say(f"main: cube {nx}^3, {model.n_dof} dofs; model build {model_s:.2f} "
        f"s")
    say(f"main: the JAX package recorded flag 0 and {JAX_FLAGSHIP_ITERS} "
        f"iterations for this configuration")
    cfg = RunConfig(solver=SolverConfig(tol=1e-7, precision_mode="mixed"))
    # physics: tip displacement against the 1-D bar estimate sigma*L/E,
    # a 3x window for the two-phase material
    sigma = FLAGSHIP["load_value"] * (nx + 1) ** 2 / nx ** 2
    bar = sigma * nx / FLAGSHIP["E"]
    launches_by = {}
    # v6 last: its profiled window follows its solve, and the torch.profiler
    # window slows every solve run after it (PERF.md, Findings)
    for variant in sorted(F32_VARIANTS, key=lambda v: v == "v6"):
        os.environ["PCG_TPU_PALLAS_V"] = variant.removeprefix("v")
        try:
            solver = Solver(model, cfg)
        finally:
            del os.environ["PCG_TPU_PALLAS_V"]
        if solver.kernel_variant != variant:
            raise AssertionError(f"Solver chose {solver.kernel_variant} "
                                 f"under PCG_TPU_PALLAS_V for {variant}")
        torch.cuda.synchronize()
        reset_launch_counts()
        with inner_cycles() as cycles:
            results = solver.solve()
        launches = dict(LAUNCHES)
        res = results[-1]
        wall = sum(r.wall_s for r in results)
        iters = sum(r.iters for r in results)
        shown = {f"{v} {d}": n for (v, d), n in launches.items()}
        say(f"main {variant}: partition {solver.partition_build_s:.2f} s, "
            f"setup {solver.setup_s:.2f} s; flag {res.flag}, iterations "
            f"{res.iters}, relres {res.relres:.4e}, solve wall {wall:.3f} "
            f"s, {wall / iters * 1e3:.4f} ms/iter, "
            f"{model.n_dof * iters / wall:.4e} dof*iter/s; inner cycles "
            f"(flag, iterations) {cycles}; launches {shown}")
        if res.flag != 0 or not res.relres <= 1e-7:
            raise AssertionError(f"flagship solve under {variant} did not "
                                 f"converge: {res}")
        if abs(res.iters - JAX_FLAGSHIP_ITERS) > ITERS_TOL * JAX_FLAGSHIP_ITERS:
            raise AssertionError(f"flagship solve under {variant} took "
                                 f"{res.iters} iterations, not within "
                                 f"{ITERS_TOL:.0%} of {JAX_FLAGSHIP_ITERS}")
        others = {k: n for k, n in launches.items()
                  if k[1] == "float32" and k[0] != variant and n}
        if (launches[(variant, "float32")] < res.iters or others
                or launches[("v6", "float64")] < 2):
            raise AssertionError(f"the solve under {variant} did not go "
                                 f"through its kernel: {shown} for "
                                 f"{res.iters} iterations")
        u = solver.displacement_global()
        if u.shape != (model.n_dof,) or not np.isfinite(u).all():
            raise AssertionError("flagship displacement not finite or "
                                 "misshapen")
        tip = float(u[0::3].max())
        say(f"main {variant}: tip ux {tip:.4e} m vs bar estimate "
            f"{bar:.4e} m (ratio {tip / bar:.3f}, window [1/3, 3])")
        if not bar / 3 <= tip <= 3 * bar:
            raise AssertionError("flagship tip displacement outside the "
                                 "physics window")
        if variant == "v6":
            profile_inner(torch, solver)
        launches_by[variant] = launches
        del solver, u
        torch.cuda.empty_cache()
    return launches_by


def profile_inner(torch, solver, iters: int = 100):
    """Device time by kernel over a window of f32 inner iterations of the
    flagship (the body of the mixed solve), and the device-busy share of
    the window's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pcg_mpi_solver_tpu_torch.ops.precond import make_prec
    from pcg_mpi_solver_tpu_torch.solver.pcg import pcg

    ops, data = solver.ops32, solver.data32
    rhs = (data["eff"] * data["F"])
    rhs = rhs / rhs.norm()
    inv = make_prec(ops, data, "jacobi")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _res, carry = pcg(ops, data, rhs, torch.zeros_like(rhs), inv,
                          tol=1e-30, max_iter=iters,
                          glob_n_dof_eff=solver.pm.glob_n_dof_eff,
                          return_carry=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, copies); the aten ops that
        # launched them carry the same time again
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    n = carry["exec"]
    say(f"profile: {n} inner f32 iterations, wall {wall * 1e3 / n:.4f} "
        f"ms/iter, device busy {busy * 1e3 / n:.4f} ms/iter "
        f"({busy / wall:.1%} of wall; idle {1 - busy / wall:.1%})")
    for dev_us, key, count in rows[:12]:
        say(f"profile:   {dev_us / n / 1e3:9.4f} ms/iter  {count:6d} calls"
            f"  {key[:90]}")


def phase_checks(torch, np):
    from pcg_mpi_solver_tpu_torch import (
        RunConfig, SolverConfig, TimeHistoryConfig)
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    kw = dict(FLAGSHIP)
    kw.pop("nx")
    model = make_cube_model(*DIRECT_F64_CELLS, **kw)
    cfg = RunConfig(solver=SolverConfig(tol=1e-7, dtype="float64"))
    reset_launch_counts()
    res = Solver(model, cfg).solve()[-1]
    cells = "x".join(map(str, DIRECT_F64_CELLS))
    say(f"direct f64 {cells} ({model.n_dof} dofs): flag {res.flag}, "
        f"iterations {res.iters}, relres {res.relres:.4e}, wall "
        f"{res.wall_s:.3f} s, launches "
        f"{ {f'{v} {d}': n for (v, d), n in LAUNCHES.items()} }")
    if res.flag != 0 or LAUNCHES[("v6", "float64")] < res.iters:
        raise AssertionError(f"direct f64 solve failed: {res}")

    # the whole path on the card against the same solve on the CPU
    small = make_cube_model(*CARD_VS_CPU_CELLS, seed=4,
                            **dict(kw, load="dirichlet", load_value=1e-3))
    th = TimeHistoryConfig(time_step_delta=(0.0, 0.5, 1.0))
    for mode, rtol in (("direct", 1e-8), ("mixed", 1e-5)):
        cfg = RunConfig(solver=SolverConfig(tol=1e-9, precision_mode=mode),
                        time_history=th)
        out = {}
        for dev in ("cuda", "cpu"):
            s = Solver(small, cfg, device=dev)
            rs = s.solve()
            out[dev] = ([(r.flag, r.iters) for r in rs],
                        s.displacement_global())
        (steps_g, u_g), (steps_c, u_c) = out["cuda"], out["cpu"]
        rel = float(np.abs(u_g - u_c).max() / np.abs(u_c).max())
        say(f"card vs cpu, {mode}, dirichlet "
            f"{'x'.join(map(str, CARD_VS_CPU_CELLS))}, 2 steps: "
            f"(flag, iters) card {steps_g} cpu {steps_c}, max rel diff "
            f"{rel:.3e} (tol {rtol:g})")
        if any(f != 0 for f, _ in steps_g) or not rel <= rtol:
            raise AssertionError(f"{mode} solve on the card disagrees with "
                                 f"the CPU")


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from pcg_mpi_solver_tpu_torch.ops.kernels import build_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    rates = card_rates(kind)
    say(f"device: {kind} ({torch.cuda.device_count()} visible); "
        f"nvidia-smi: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    say(f"device: H100 SXM data-sheet rates: {rates[1] / 1e12:g} TB/s,"
        f" {rates[2] / 1e12:g} TFLOP/s fp32, {rates[3] / 1e12:g} TFLOP/s "
        f"fp64 (CUDA cores)")

    # 2. build
    t0 = time.perf_counter()
    built = build_kernels()
    say(f"build: {len(built)} kernel(s) compiled in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, rep in built.items():
        say(f"build: {name}: {rep['seconds']:.2f} s")
        for line in rep["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "smem")):
                say(f"build: {name}: {line.strip()}")

    # 3. kernels against their plain versions
    kern = phase_kernels(torch, np, rates)
    # 4. main path at full size, once per float32 variant
    launches_by = phase_main(torch, np)
    # 5. direct f64 and card-vs-cpu checks
    phase_checks(torch, np)

    records = []
    for variant in F32_VARIANTS:
        for dtype in ("float32", "float64"):
            if (variant, dtype) not in kern:
                continue
            lib = "structured_matvec" + ("" if variant == "v6"
                                         else f"_{variant}")
            records.append(dict(
                name=f"{lib}_{dtype}", route="cuda",
                source=f"pcg_mpi_solver_tpu_torch/csrc/{lib}.cu",
                replaces=REPLACES[variant],
                launches=launches_by[variant][(variant, dtype)],
                library_ms=None, **kern[(variant, dtype)]))
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
