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
                card's bound (bytes, CUDA-core and tensor-core terms); the
                chunked variants (v3, v5, v7) also at 16 planes a
                chunk; v6 in both dtypes, v4, v2 and v8 (float32 on
                v6's tiles), v5, v3 and v7 (the node-owned gather, at 8
                and 16 planes) and v9 also on a single cell and on shapes
                that cross their strip, tile and segment edges, each with
                its launch geometry, v1 on shapes whose block runs cross
                its column tiles in mid-run and end on a ragged tile, with
                its launch split; v2 and v8 give v6 float's bits and v3
                and v7 v5's at every shape both run;
  4. main     — the flagship structured cube (150^3 cells, 10,328,853
                dofs) solved in mixed precision through ``Solver`` once
                under each of the nine float32 variants
                (``PCG_TPU_PALLAS_V``), v6 last, with the kernel launch
                counts and inner cycles of each solve (v4's, v7's, v8's
                and v9's beside v6's at the end); then a profiled window
                of inner f32 iterations under v6;
  4b. preconditioners — mixed solves (tol 1e-7, v6) of the 128^3 cube
                (6,440,067 dofs; the flagship's other arguments) under
                jacobi and mg, and of the 150^3 flagship under block3 and
                mg: levels, Chebyshev bounds, setup seconds, iterations,
                ms/iter, time to tol, inner cycles and launches of each
                (under mg at least 5 float32 launches an iteration and the
                16 float64 power-iteration matvecs), two V-cycles at 128^3
                bitwise equal, a profiled window of mg iterations at each
                size;
  4c. variants — the fused and pipelined PCG variants (tol 1e-7, v6): the
                150^3 flagship mixed under jacobi with each, the 128^3 cube
                mixed under pipelined and mg, the flagship direct float64
                under pipelined; iterations against the classic solve of
                phase 4 or 4b, ms/iter, time to tol, inner cycles, launches
                of each; 100 profiled inner iterations of each 150^3 mixed
                variant beside classic's; two pipelined mixed 12x6x5 solves
                bitwise equal.  The pipelined mixed flagship is held to the
                stall the JAX package's own algorithm shows (``STALLS``);
  5. checks   — a direct float64 solve (48x32x32) to flag 0, and small
                mixed and direct solves on the card against the same
                solves on the CPU (the plain path): classic under jacobi,
                block3 and mg, fused and pipelined under jacobi and mg.
The line before the last is the per-kernel JSON record (one per variant
and dtype, launch counts from the solve under that variant; v6's also by
preconditioner solve of phase 4b and by variant solve of phase 4c), the
last line
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
# power limit): memory bytes/s; FLOP/s of float32 and float64 on the CUDA
# cores, of TF32 and float64 on the tensor cores.
H100_SXM = dict(name="H100 80GB HBM3", bw=3.35e12, fp32=67e12, fp64=34e12,
                tf32_tc=495e12, fp64_tc=67e12)

FLAGSHIP = dict(nx=150, E=30e9, nu=0.2, load="traction", load_value=1e6,
                heterogeneous=True)
DIRECT_F64_CELLS = (48, 32, 32)     # phase 5's direct float64 solve
CARD_VS_CPU_CELLS = (12, 6, 5)      # phase 5's card-against-CPU solves
MG_CARD_VS_CPU_CELLS = (12, 8, 8)   # and its mg one (even: two levels)
# phase 5's (PCG variant, preconditioner, cells) of each card-against-CPU
# solve, in direct and mixed precision
CARD_VS_CPU_SOLVES = tuple(
    (v, pc, MG_CARD_VS_CPU_CELLS if pc == "mg" else CARD_VS_CPU_CELLS)
    for v, pcs in (("classic", ("jacobi", "block3", "mg")),
                   ("fused", ("jacobi", "mg")),
                   ("pipelined", ("jacobi", "mg")))
    for pc in pcs)
# phase 4b: (cells a side, preconditioner) of each mixed solve; 150 is the
# flagship, whose mg hierarchy has one level (75 is odd), 128 the even cube
# that gives mg six (64 ... 2)
PRECOND_SOLVES = ((128, "jacobi"), (128, "mg"), (150, "block3"),
                  (150, "mg"))
# phase 4c: (cells a side, preconditioner, PCG variant, precision) of each
# solve: the bench's variant legs on the flagship, RUNBOOK's pipelined +
# mg composition at 128^3, and the pipelined body in float64 at the
# flagship's width, where its recurrence holds
VARIANT_SOLVES = ((150, "jacobi", "fused", "mixed"),
                  (150, "jacobi", "pipelined", "mixed"),
                  (128, "mg", "pipelined", "mixed"),
                  (150, "jacobi", "pipelined", "direct"))
# Solves that the JAX package's own algorithm does not converge: its
# pipelined mixed solve stalls on this model family from 48^3 up (flag 3:
# every f32 GV cycle ends on a flag-4 breakdown, and a refresh fails to
# halve the f64 residual; both packages on the CPU at 48^3, 64^3 and
# 96^3, PERF.md, Findings).  Phase 4c holds the port to that outcome.
STALLS = {(150, "jacobi", "pipelined", "mixed")}
MG_ITER_RATIO = 5       # RUNBOOK: mg >= 5x fewer iterations than jacobi
MG_BITS_CELLS = 128     # phase 4b holds two V-cycles bitwise equal here
# The JAX package's record of the same solve (docs/HW_SESSION.log:134):
# flag 0, 3334 iterations, relres 4.989e-08.
JAX_FLAGSHIP_ITERS = 3334

KERNEL_TOL = {"float32": 2e-5, "float64": 1e-12}   # x max|y_plain|
# phase 3 also holds v6 (both dtypes), v4, v2 and v8 (float32, on v6's
# tiles) at these: a single cell, and shapes whose ny+1 and nz+1
# cross several of their (y, z) tiles without filling the last and whose
# nx+1 spans several x segments, one of them two parts
V6_EDGE_SHAPES = ((1, 1, 1, 1), (2, 40, 37, 70), (1, 20, 70, 40))
# and v5, v3 and v7 (float32, the node-owned gather, at 8 and 16 planes)
# at these: v6's, and one whose x segments are longer than two chunks, so
# its shared-memory ring wraps
V5_EDGE_SHAPES = V6_EDGE_SHAPES + ((1, 100, 200, 200),)
V5_EDGE_PLANES = (8, 16)
# and v9 (float32) at these: v6's, two parts whose nodes end exactly on
# its tile edges (40 x 31 nodes), one whose nodes end on a strip and tile
# edge, and one whose segments wrap its three-slot ring
V9_EDGE_SHAPES = V6_EDGE_SHAPES + ((2, 9, 79, 61), (1, 30, 39, 30),
                                   (1, 100, 200, 200))
# and v1 (float32, the x-march) at these: a single cell, and shapes (two
# of them two parts, whose tiles straddle the parts) where the card's
# resident blocks march runs that cross from one column tile into the next
# in mid-run, the last tile ragged
V1_EDGE_SHAPES = ((1, 1, 1, 1), (2, 40, 37, 70), (2, 60, 70, 40),
                  (1, 100, 200, 200))
EDGE_SHAPES = {"v6": V6_EDGE_SHAPES, "v4": V6_EDGE_SHAPES,
               "v2": V6_EDGE_SHAPES, "v8": V6_EDGE_SHAPES,
               "v5": V5_EDGE_SHAPES, "v3": V5_EDGE_SHAPES,
               "v7": V5_EDGE_SHAPES, "v9": V9_EDGE_SHAPES,
               "v1": V1_EDGE_SHAPES}
# variants that run another's kernel from a library of their own and give
# its bits: v2 and v8 run v6 float's tile kernel, v3 and v7 v5's gather
SAME_BITS = (("v2", "v6"), ("v8", "v6"), ("v3", "v5"), ("v7", "v5"))
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
    if H100_SXM["name"] not in name:
        raise RuntimeError(f"no data-sheet rates for card {name!r}; the "
                           f"bounds are written for {H100_SXM['name']}")
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


def matvec_bound_ms(shape, itemsize: int, rates: dict):
    """Least time for one slab matvec on this card: each input read once
    (x, ck, Ke) and each output written once (y), against 24*24 FMAs per
    cell by the fastest arithmetic that keeps the dtype's accuracy - float
    on the CUDA cores or as 3xTF32 on the tensor cores (three TF32
    products a product), double on the FP64 tensor cores.  Returns (ms,
    "bytes"|"operations", {term: ms}) with the bytes, CUDA-core and
    tensor-core terms."""
    P, nx, ny, nz = shape
    nodes = P * (nx + 1) * (ny + 1) * (nz + 1)
    cells = P * nx * ny * nz
    nbytes = itemsize * (2 * 3 * nodes + cells + 24 * 24)
    nops = 2 * 24 * 24 * cells
    if itemsize == 4:
        core, tensor = nops / rates["fp32"], 3 * nops / rates["tf32_tc"]
    else:
        core, tensor = nops / rates["fp64"], nops / rates["fp64_tc"]
    terms = {"bytes": nbytes / rates["bw"] * 1e3,
             "cuda_cores": core * 1e3, "tensor_cores": tensor * 1e3}
    t_ops = min(terms["cuda_cores"], terms["tensor_cores"])
    if t_ops >= terms["bytes"]:
        return t_ops, "operations", terms
    return terms["bytes"], "bytes", terms


def kernel_shapes():
    """(P, nx, ny, nz) the kernel is held to its plain version at, per
    dtype: two ragged ones (one with two parts), then every slab shape a
    driven path gives the kernel in that dtype (phase 4's flagship in both;
    phase 4b's 128^3 cube in both; phase 5's card-against-CPU cubes in
    both, as its direct solves run float64 and its mixed solves both;
    phase 5's direct solve in float64)."""
    n = FLAGSHIP["nx"]
    ragged = list(V6_EDGE_SHAPES) + [(1, 7, 3, 5), (2, 33, 17, 9)]
    small, flag = (1, *CARD_VS_CPU_CELLS), (1, n, n, n)
    small_mg = (1, *MG_CARD_VS_CPU_CELLS)
    # phase 4b's other cube, in both dtypes (f32 solves, f64 lifting,
    # refreshes and power iterations)
    cube = [(1, c, c, c) for c in sorted({c for c, _ in PRECOND_SOLVES})
            if c != n]
    edge_only = [s for s in dict.fromkeys(V5_EDGE_SHAPES + V9_EDGE_SHAPES
                                          + V1_EDGE_SHAPES)
                 if s not in V6_EDGE_SHAPES]
    return {"float32": ragged + edge_only + [small, small_mg] + cube
            + [flag],
            "float64": ragged + [small, small_mg, (1, *DIRECT_F64_CELLS)]
            + cube + [flag]}


def phase_kernels(torch, np, rates):
    """Each kernel against the plain version at every shape of
    kernel_shapes(); returns the flagship record per (variant, dtype)."""
    from pcg_mpi_solver_tpu_torch.models.element import unit_element_library
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        GATHER, V1_BLOCKS_PER_SM, V1_NODES, V1_THREADS, VARIANTS, _library,
        pallas_planes, structured_matvec, structured_matvec_plain,
        v1_geometry, v1_runs, v5_geometry, v6_geometry, v9_geometry)

    v1_lib = _library("v1")
    v1_per_sm = v1_lib.structured_matvec_v1_blocks_per_sm(0)
    v1_regs = v1_lib.structured_matvec_v1_registers(0)
    say(f"kernel v1: {v1_regs} registers, {v1_per_sm} blocks of "
        f"{V1_THREADS} threads an SM ({V1_BLOCKS_PER_SM} by its launch "
        f"bounds and v1_geometry)")
    if v1_per_sm != V1_BLOCKS_PER_SM:
        raise AssertionError(f"v1 holds {v1_per_sm} blocks an SM; "
                             f"v1_geometry launches {V1_BLOCKS_PER_SM}")
    rng = np.random.default_rng(2024)
    Ke = unit_element_library(FLAGSHIP["nu"])["Ke"]
    shapes = kernel_shapes()
    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        tol = KERNEL_TOL[name]
        for shape in shapes[name]:
            P, nx, ny, nz = shape
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            geo = v6_geometry(P, nx, ny, nz, dtype, sms=sms)
            edge = any(shape in e for e in EDGE_SHAPES.values())
            if edge:
                variants = tuple(
                    v for v, edges in EDGE_SHAPES.items()
                    if shape in edges and (v == "v6"
                                           or dtype == torch.float32))
            else:
                variants = F32_VARIANTS if dtype == torch.float32 \
                    else ("v6",)
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
            bound_ms, bound_by, terms = matvec_bound_ms(
                shape, x.element_size(), rates)
            smem = _library("v6").structured_matvec_smem_bytes(
                x.element_size())
            say(f"kernel {name} P={P} cells=({nx},{ny},{nz}): plain "
                f"{plain_ms:.4f} ms, bound {bound_ms * 1e3:.4g} us "
                f"({bound_by}; bytes {terms['bytes'] * 1e3:.4g} us, CUDA "
                f"cores {terms['cuda_cores'] * 1e3:.4g} us, tensor cores "
                f"{terms['tensor_cores'] * 1e3:.4g} us); v6 tiles "
                f"{geo.n_ty}x{geo.n_tz} of {geo.tile_nodes[0]}x"
                f"{geo.tile_nodes[1]} nodes, {geo.n_seg} segments of "
                f"{geo.seg_len} planes, {geo.blocks} blocks, {smem} B "
                f"shared")
            if shape in V6_EDGE_SHAPES and shape != (1, 1, 1, 1) \
                    and min(geo.n_ty, geo.n_tz, geo.n_seg) < 2:
                raise AssertionError(f"{shape} {name} crosses no v6 tile "
                                     f"or segment edge: {geo}")
            for tv in ("v4", "v2", "v8"):
                if tv not in variants:
                    continue
                # v4, v2 and v8 launch v6 float's tiles from libraries of
                # their own
                tv_smem = getattr(_library(tv),
                                  f"{VARIANTS[tv][0]}_smem_bytes")(
                    x.element_size())
                if tv_smem != smem:
                    raise AssertionError(f"{tv} shared memory {tv_smem} B, "
                                         f"v6 float's {smem} B")
            plane_runs = [(v, None) for v in variants]
            if shape == RAGGED_PLANES[0] and dtype == torch.float32:
                plane_runs += [(v, RAGGED_PLANES[1]) for v in variants
                               if VARIANTS[v][1]]
            for gv in [v for v in variants if v in GATHER]:
                if edge:
                    plane_runs = [r for r in plane_runs if r[0] != gv] \
                        + [(gv, pl) for pl in V5_EDGE_PLANES]
                for pl in sorted({pl or pallas_planes() for v, pl in plane_runs
                                  if v == gv}):
                    g5 = v5_geometry(P, nx, ny, nz, pl, sms=sms)
                    lib_smem = getattr(_library(gv),
                                       f"{VARIANTS[gv][0]}_smem_bytes")(
                        pl, g5.rows)
                    if lib_smem != g5.smem_bytes:
                        raise AssertionError(f"{gv} shared memory "
                                             f"{lib_smem} B, v5_geometry "
                                             f"says {g5}")
                    say(f"  {gv} planes={pl}: tiles {g5.n_ty}x{g5.n_tz} of "
                        f"{g5.rows}x32 nodes, {g5.n_seg} segments of "
                        f"{g5.seg_len} planes, {g5.blocks} blocks of "
                        f"{g5.threads} threads, {g5.smem_bytes} B shared")
            if "v9" in variants:
                g9 = v9_geometry(P, nx, ny, nz, sms=sms)
                lib_smem = _library("v9").structured_matvec_v9_smem_bytes()
                if lib_smem != g9.smem_bytes:
                    raise AssertionError(f"v9 shared memory {lib_smem} B, "
                                         f"v9_geometry says {g9}")
                exact = (ny + 1) % g9.tile_nodes[0] == 0 \
                    and (nz + 1) % g9.tile_nodes[1] == 0
                if shape in V9_EDGE_SHAPES and shape != (1, 1, 1, 1) and (
                        g9.n_seg < 2 or (g9.n_ty * g9.n_tz < 2
                                         and not exact)):
                    raise AssertionError(f"{shape} crosses no v9 tile or "
                                         f"segment edge: {g9}")
                say(f"  v9: tiles {g9.n_ty}x{g9.n_tz} of {g9.tile_nodes[0]}x"
                    f"{g9.tile_nodes[1]} nodes (strips of {g9.rows} cell "
                    f"rows), {g9.n_seg} segments of {g9.seg_len} planes, "
                    f"{g9.blocks} blocks of {g9.threads} threads, "
                    f"{g9.smem_bytes} B shared")
            if "v1" in variants:
                g1 = v1_geometry(P, nx, ny, nz, sms=sms)
                runs = [v1_runs(g1, k) for k in range(g1.blocks)]
                crossing = sum(len(r) > 1 for r in runs)
                ragged = g1.cols % V1_THREADS
                if shape in V1_EDGE_SHAPES and shape != (1, 1, 1, 1) and (
                        not crossing or not ragged):
                    raise AssertionError(f"{shape}: no v1 run crosses a "
                                         f"column tile or the last tile is "
                                         f"whole: {g1}")
                say(f"  v1: {g1.blocks} blocks of {V1_THREADS} threads "
                    f"({V1_NODES} node columns a thread), {g1.tiles} "
                    f"column tiles ({g1.cols} thread columns, the last "
                    f"tile {ragged or V1_THREADS}) x {g1.planes} planes, "
                    f"{g1.per}-{g1.per + (g1.more > 0)} planes a block, "
                    f"{crossing} blocks crossing a tile, "
                    f"{sum(r[0][1] > 0 for r in runs)} recomputing a "
                    f"carry")
            ys = {}
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
                    if v == "v1":
                        out[(v, name)].update(registers=v1_regs,
                                              blocks_per_sm=v1_per_sm)
                ys[(v, (planes or pallas_planes()) if VARIANTS[v][1]
                    else None)] = y
                del y2
            for a, b in SAME_BITS:
                pairs = [(k, (b, k[1])) for k in ys
                         if k[0] == a and (b, k[1]) in ys]
                if a in variants and b in variants and not pairs:
                    raise AssertionError(f"{a} and {b} ran at {shape} but "
                                         f"were not compared")
                for ka, kb in pairs:
                    same = torch.equal(ys[ka], ys[kb])
                    at = "" if ka[1] is None else f" planes={ka[1]}"
                    say(f"  {a} against {b}{at}: "
                        f"{'the same bits' if same else 'DIFFERENT bits'}")
                    if not same:
                        raise AssertionError(f"{a}{at} {name} {shape} does "
                                             f"not give {b}'s bits")
            del x, ck, y_plain, ys
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
    {variant: launch counts of its solve}, the flagship model and v6's
    iterations and inner-loop profile.  Ends with v4's, v7's, v8's and
    v9's inner cycles beside v6's: the stagnation exits that end the
    cycles move with the round-off of the cell product (v4 and v8 run v6
    float's FFMA product and node sums; a DMMA product moved the second
    exit by 200 iterations, PERF.md, Findings; v7 runs v5's gather, v9
    sums in another order than v6)."""
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
    launches_by, cycles_by, classic = {}, {}, {}
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
            classic = dict(iters=res.iters, profile=profile_inner(torch,
                                                                  solver))
        launches_by[variant] = launches
        cycles_by[variant] = (cycles, res.iters)
        del solver, u
        torch.cuda.empty_cache()
    for v in ("v4", "v7", "v8", "v9", "v6"):
        say(f"main: inner cycles (flag, iterations) {v} {cycles_by[v][0]}, "
            f"{cycles_by[v][1]} in all")
    return launches_by, model, classic


def profile_inner(torch, solver, iters: int = 100, tag: str = "profile"):
    """Device time by kernel over a window of f32 inner iterations of a
    mixed solver (the body of the mixed solve) under its preconditioner
    and PCG variant, and the device-busy share of the window's wall time.
    Returns {"wall", "busy" (ms/iter), "idle" (share), "kernels" (an
    iteration), "per_trip" (kernels a trip: a trip launches one float32
    matvec)}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pcg_mpi_solver_tpu_torch.ops.precond import make_prec
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import LAUNCHES
    from pcg_mpi_solver_tpu_torch.solver.pcg import pcg

    ops, data = solver.ops32, solver.data32
    rhs = (data["eff"] * data["F"])
    rhs = rhs / rhs.norm()
    inv = make_prec(ops, data, solver.config.solver.precond)
    f32 = (solver.kernel_variant, "float32")
    torch.cuda.synchronize()
    before = LAUNCHES[f32]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _res, carry = pcg(ops, data, rhs, torch.zeros_like(rhs), inv,
                          tol=1e-30, max_iter=iters,
                          glob_n_dof_eff=solver.pm.glob_n_dof_eff,
                          return_carry=True,
                          variant=solver.config.solver.pcg_variant)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    matvecs = LAUNCHES[f32] - before
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
    kernels = sum(r[2] for r in rows)
    # a trip's matvecs: one, and the smoothing's under mg (whose check
    # trips have one), so trips are counted only without mg
    trips = None if solver.config.solver.precond == "mg" else matvecs
    out = dict(wall=wall * 1e3 / n, busy=busy * 1e3 / n,
               idle=1 - busy / wall, kernels=kernels / n,
               per_trip=kernels / trips if trips else None)
    say(f"{tag}: {n} inner f32 iterations"
        + (f" ({trips} trips)" if trips else "")
        + f", wall {out['wall']:.4f} ms/iter, device busy {out['busy']:.4f} "
        f"ms/iter ({busy / wall:.1%} of wall; idle {out['idle']:.1%}); "
        f"{out['kernels']:.1f} device kernels an iteration"
        + (f", {out['per_trip']:.1f} a trip" if trips else ""))
    for dev_us, key, count in rows[:12]:
        say(f"{tag}:   {dev_us / n / 1e3:9.4f} ms/iter  {count:6d} calls"
            f"  {key[:90]}")
    return out


def phase_preconditioners(torch, np, flagship_model):
    """Phase 4b: the mixed solves of ``PRECOND_SOLVES`` through ``Solver``
    (tol 1e-7, v6), each with the launch counts set to 0 just before the
    Solver is built and read just after its solve; two V-cycle applies at 128^3 held bitwise equal;
    a profiled window of mg inner iterations at each size.  Returns
    {"<cells> <precond>": launch counts of that solve}, {(cells, precond):
    iterations} and the models by cells."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.ops.precond import make_prec
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    kw = dict(FLAGSHIP)
    models = {kw.pop("nx"): flagship_model}
    launches_by, iters_by = {}, {}
    for cells, precond in PRECOND_SOLVES:
        if cells not in models:
            t0 = time.perf_counter()
            models[cells] = make_cube_model(cells, **kw)
            say(f"precond: cube {cells}^3, {models[cells].n_dof} dofs; "
                f"model build {time.perf_counter() - t0:.2f} s")
        model = models[cells]
        cfg = RunConfig(solver=SolverConfig(tol=1e-7, precision_mode="mixed",
                                            precond=precond))
        tag = f"precond {cells}^3 {precond}"
        # the path is the Solver's construction (mg: the power-iteration
        # matvecs) and its solve
        torch.cuda.synchronize()
        reset_launch_counts()
        solver = Solver(model, cfg)
        if solver.kernel_variant != "v6":
            raise AssertionError(f"{tag}: Solver chose "
                                 f"{solver.kernel_variant}, not v6")
        if precond == "mg":
            meta = solver.mg_setup.meta
            say(f"{tag}: {meta['levels']} coarse levels "
                f"{[tuple(lv['ck'].shape) for lv in solver.data['mg']['levels']]}"
                f" cells, {sum(3 * lv['idiag'].shape[0] for lv in solver.data['mg']['levels'])}"
                f" coarse dofs, degree {meta['degree']}; lam "
                f"{[float(v) for v in solver.mg_lam]}; hierarchy setup "
                f"{solver.mg_setup_s:.3f} s, lam setup {solver.mg_lam_s:.3f} s")
        with inner_cycles() as cycles:
            results = solver.solve()
        launches = dict(LAUNCHES)
        res = results[-1]
        wall = sum(r.wall_s for r in results)
        iters = sum(r.iters for r in results)
        shown = {f"{v} {d}": n for (v, d), n in launches.items() if n}
        say(f"{tag}: partition {solver.partition_build_s:.2f} s, setup "
            f"{solver.setup_s:.2f} s; flag {res.flag}, iterations "
            f"{res.iters}, relres {res.relres:.4e}, solve wall {wall:.3f} s "
            f"= time to tol ({solver.setup_s + wall:.3f} s with setup), "
            f"{wall / iters * 1e3:.4f} ms/iter, "
            f"{model.n_dof * iters / wall:.4e} dof*iter/s; inner cycles "
            f"(flag, iterations) {cycles}; launches {shown}")
        if res.flag != 0 or not res.relres <= 1e-7:
            raise AssertionError(f"{tag} did not converge: {res}")
        f32, f64 = launches[("v6", "float32")], launches[("v6", "float64")]
        others = {k: n for k, n in launches.items()
                  if n and k not in (("v6", "float32"), ("v6", "float64"))}
        need = 2 * solver.ops32.mg_degree + 1 if precond == "mg" else 1
        if f32 < need * res.iters or others or f64 < (
                16 if precond == "mg" else 2):
            raise AssertionError(f"{tag} did not go through v6 as its "
                                 f"preconditioner needs: {shown} for "
                                 f"{res.iters} iterations")
        u = solver.displacement_global()
        if u.shape != (model.n_dof,) or not np.isfinite(u).all():
            raise AssertionError(f"{tag}: displacement not finite or "
                                 f"misshapen")
        sigma = FLAGSHIP["load_value"] * (cells + 1) ** 2 / cells ** 2
        bar = sigma * cells / FLAGSHIP["E"]
        tip = float(u[0::3].max())
        say(f"{tag}: tip ux {tip:.4e} m vs bar estimate {bar:.4e} m (ratio "
            f"{tip / bar:.3f}, window [1/3, 3])")
        if not bar / 3 <= tip <= 3 * bar:
            raise AssertionError(f"{tag}: tip displacement outside the "
                                 f"physics window")
        if precond == "mg":
            if cells == MG_BITS_CELLS:
                # the preconditioner must be one fixed operator: two
                # applies, same bits (not counted: the path's counts are
                # read above)
                m = make_prec(solver.ops32, solver.data32, "mg")
                r = solver.data32["eff"] * solver.data32["F"]
                r = r / r.norm()
                z1 = solver.ops32.apply_prec(m, r, solver.data32)
                z2 = solver.ops32.apply_prec(m, r, solver.data32)
                torch.cuda.synchronize()
                same = torch.equal(z1, z2)
                say(f"{tag}: two V-cycle applies "
                    f"{'bitwise equal' if same else 'DIFFERENT'}")
                if not same or not torch.isfinite(z1).all():
                    raise AssertionError(f"{tag}: the V-cycle is not one "
                                         f"fixed operator")
                del m, r, z1, z2
            profile_inner(torch, solver, iters=20, tag=f"{tag} profile")
        launches_by[f"{cells} {precond}"] = launches
        iters_by[(cells, precond)] = res.iters
        del solver, u
        torch.cuda.empty_cache()
    for cells in sorted({c for c, _ in PRECOND_SOLVES}):
        if (cells, "jacobi") in iters_by and (cells, "mg") in iters_by:
            ij, im = iters_by[(cells, "jacobi")], iters_by[(cells, "mg")]
            say(f"precond: {cells}^3 jacobi/mg iterations {ij}/{im} = "
                f"{ij / im:.2f}x against RUNBOOK's >= {MG_ITER_RATIO}x: "
                f"{'held' if ij >= MG_ITER_RATIO * im else 'missed'}")
    return launches_by, iters_by, models


def phase_variants(torch, np, models, classic_iters, classic_profile):
    """Phase 4c: the solves of ``VARIANT_SOLVES`` through ``Solver`` (tol
    1e-7, v6), each with the launch counts set to 0 just before the Solver
    is built and read just after its solve; then 100 inner f32 iterations
    of each 150^3 mixed variant under the profiler beside classic's (phase
    4), and two 12x6x5 pipelined mixed solves held bitwise equal.
    ``classic_iters`` maps (cells, precond) to the classic mixed solve's
    iterations (phases 4 and 4b).  Returns {"<cells> <precond> <variant>
    <mode>": launch counts of that solve}."""
    from pcg_mpi_solver_tpu_torch import (
        RunConfig, SolverConfig, TimeHistoryConfig)
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    kw = dict(FLAGSHIP)
    kw.pop("nx")
    launches_by, profiled = {}, {}
    for cells, precond, variant, mode in VARIANT_SOLVES:
        if cells not in models:
            models[cells] = make_cube_model(cells, **kw)
        model = models[cells]
        cfg = RunConfig(solver=SolverConfig(
            tol=1e-7, precision_mode=mode, precond=precond,
            pcg_variant=variant))
        tag = f"variant {cells}^3 {precond} {variant} {mode}"
        torch.cuda.synchronize()
        reset_launch_counts()
        solver = Solver(model, cfg)
        if solver.kernel_variant != "v6":
            raise AssertionError(f"{tag}: Solver chose "
                                 f"{solver.kernel_variant}, not v6")
        with inner_cycles() as cycles:
            results = solver.solve()
        launches = dict(LAUNCHES)
        res = results[-1]
        wall = sum(r.wall_s for r in results)
        iters = sum(r.iters for r in results)
        f32, f64 = launches[("v6", "float32")], launches[("v6", "float64")]
        base = classic_iters.get((cells, precond)) if mode == "mixed" \
            else None
        ratio = (f"{iters / base:.3f}x classic's {base} (same cells, "
                 f"preconditioner, mixed)" if base else
                 "no classic solve of this size and precision in this run")
        say(f"{tag}: setup {solver.setup_s:.2f} s; flag {res.flag}, "
            f"iterations {res.iters}, relres {res.relres:.4e}, solve wall "
            f"{wall:.3f} s = time to tol ({solver.setup_s + wall:.3f} s "
            f"with setup), {wall / iters * 1e3:.4f} ms/iter, "
            f"{model.n_dof * iters / wall:.4e} dof*iter/s; inner cycles "
            f"(flag, iterations) {cycles}; launches f32 {f32}, f64 {f64} "
            f"({(f32 or f64) / iters:.3f} a {'f32' if f32 else 'f64'} "
            f"iteration); iterations {ratio}")
        if (cells, precond, variant, mode) in STALLS:
            # the reference's outcome on this input (STALLS): a refresh
            # that fails to halve the f64 residual after f32 cycles that
            # each end on a breakdown
            stalled = res.flag == 3 and cycles and all(
                f == 4 for f, _ in cycles)
            say(f"{tag}: NOT CONVERGED, as the JAX package's pipelined "
                f"mixed solve is not on this model family from 48^3 up "
                f"(flag 3 after f32 cycles that end on flag 4): "
                f"{'the same outcome' if stalled else 'ANOTHER outcome'}")
            if not stalled:
                raise AssertionError(f"{tag}: {res} with inner cycles "
                                     f"{cycles}, not the reference's stall")
        elif res.flag != 0 or not res.relres <= 1e-7:
            raise AssertionError(f"{tag} did not converge: {res}")
        need = (2 * solver.ops32.mg_degree + 1 if precond == "mg" else 1)
        others = {k: n for k, n in launches.items()
                  if n and k not in (("v6", "float32"), ("v6", "float64"))}
        if (mode == "mixed" and (f32 < need * res.iters or f64 < 2)) \
                or (mode == "direct" and (f32 != 0 or f64 < res.iters)) \
                or others:
            raise AssertionError(f"{tag} did not go through v6: "
                                 f"{launches} for {res.iters} iterations")
        u = solver.displacement_global()
        if u.shape != (model.n_dof,) or not np.isfinite(u).all():
            raise AssertionError(f"{tag}: displacement not finite or "
                                 f"misshapen")
        if res.flag == 0:
            sigma = FLAGSHIP["load_value"] * (cells + 1) ** 2 / cells ** 2
            bar = sigma * cells / FLAGSHIP["E"]
            tip = float(u[0::3].max())
            say(f"{tag}: tip ux {tip:.4e} m vs bar estimate {bar:.4e} m "
                f"(ratio {tip / bar:.3f}, window [1/3, 3])")
            if not bar / 3 <= tip <= 3 * bar:
                raise AssertionError(f"{tag}: tip displacement outside the "
                                     f"physics window")
        launches_by[f"{cells} {precond} {variant} {mode}"] = launches
        if cells == FLAGSHIP["nx"] and mode == "mixed":
            profiled[variant] = solver
        else:
            del solver
        del u
        torch.cuda.empty_cache()
    # the profiles after every solve: a profiler window slows the solves
    # run after it
    p = classic_profile
    say(f"variant profile classic (phase 4): busy {p['busy']:.4f} ms/iter, "
        f"idle {p['idle']:.1%}, {p['kernels']:.1f} kernels an iteration, "
        f"{p['per_trip']:.1f} a trip")
    for variant in list(profiled):
        solver = profiled.pop(variant)
        p = profile_inner(torch, solver, tag=f"variant profile {variant}")
        say(f"variant profile {variant}: busy {p['busy']:.4f} ms/iter, "
            f"idle {p['idle']:.1%}, {p['kernels']:.1f} kernels an "
            f"iteration, {p['per_trip']:.1f} a trip (classic: "
            f"{classic_profile['busy']:.4f}, {classic_profile['idle']:.1%}, "
            f"{classic_profile['kernels']:.1f}, "
            f"{classic_profile['per_trip']:.1f})")
        del solver
    torch.cuda.empty_cache()

    # the early read of the pipelined reduction changes no value: two
    # solves, the same bits
    small = make_cube_model(*CARD_VS_CPU_CELLS, seed=4,
                            **dict(kw, load="dirichlet", load_value=1e-3))
    cfg = RunConfig(solver=SolverConfig(tol=1e-9, precision_mode="mixed",
                                        pcg_variant="pipelined"),
                    time_history=TimeHistoryConfig(
                        time_step_delta=(0.0, 0.5, 1.0)))
    runs = []
    for _ in range(2):
        s = Solver(small, cfg)
        rs = s.solve()
        runs.append(([(r.flag, r.iters, r.relres) for r in rs], s.un.clone()))
    same = runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    say(f"variant bits: two pipelined mixed "
        f"{'x'.join(map(str, CARD_VS_CPU_CELLS))} solves {runs[0][0]}: "
        f"{'bitwise equal' if same else 'DIFFERENT'}")
    if not same or any(f != 0 for f, _, _ in runs[0][0]):
        raise AssertionError("two pipelined solves on the card differ or "
                             "did not converge")
    return launches_by


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

    # the whole path on the card against the same solve on the CPU, under
    # each preconditioner (mg on an even cube: 12x6x5 cannot coarsen), the
    # classic body under each, the fused and pipelined under jacobi and mg
    th = TimeHistoryConfig(time_step_delta=(0.0, 0.5, 1.0))
    for variant, precond, cells_cpu in CARD_VS_CPU_SOLVES:
        small = make_cube_model(*cells_cpu, seed=4,
                                **dict(kw, load="dirichlet",
                                       load_value=1e-3))
        for mode, rtol in (("direct", 1e-8), ("mixed", 1e-5)):
            cfg = RunConfig(solver=SolverConfig(tol=1e-9,
                                                precision_mode=mode,
                                                precond=precond,
                                                pcg_variant=variant),
                            time_history=th)
            out = {}
            for dev in ("cuda", "cpu"):
                s = Solver(small, cfg, device=dev)
                with inner_cycles() as cycles:
                    rs = s.solve()
                out[dev] = ([(r.flag, r.iters) for r in rs],
                            s.displacement_global(), cycles)
            (steps_g, u_g, cyc_g), (steps_c, u_c, cyc_c) = (out["cuda"],
                                                            out["cpu"])
            rel = float(np.abs(u_g - u_c).max() / np.abs(u_c).max())
            say(f"card vs cpu, {variant}, {precond}, {mode}, dirichlet "
                f"{'x'.join(map(str, cells_cpu))}, 2 steps: "
                f"(flag, iters) card {steps_g} cpu {steps_c}, max rel diff "
                f"{rel:.3e} (tol {rtol:g})"
                + (f"; inner cycles card {cyc_g} cpu {cyc_c}"
                   if mode == "mixed" else ""))
            if any(f != 0 for f, _ in steps_g) or not rel <= rtol \
                    or [f for f, _ in steps_g] != [f for f, _ in steps_c]:
                raise AssertionError(f"{variant} {precond} {mode} solve on "
                                     f"the card disagrees with the CPU")
            if (precond != "jacobi" or variant != "classic") \
                    and mode == "direct":
                # reduction order alone moves a direct count by at most
                # one; a mixed total moves further wherever an f32 cycle
                # ends on a stagnation exit, whose iteration is round-off
                # (the inner cycles printed above show which)
                for (fg, ig), (fc, ic) in zip(steps_g, steps_c):
                    if fg != fc or abs(ig - ic) > 1:
                        raise AssertionError(
                            f"{variant} {precond} {mode} on the card took "
                            f"(flag, iterations) {steps_g}, on the CPU "
                            f"{steps_c}")


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
    say(f"device: H100 SXM data-sheet rates: {rates['bw'] / 1e12:g} "
        f"TB/s; CUDA cores {rates['fp32'] / 1e12:g} TFLOP/s fp32, "
        f"{rates['fp64'] / 1e12:g} fp64; tensor cores "
        f"{rates['tf32_tc'] / 1e12:g} TFLOP/s tf32, "
        f"{rates['fp64_tc'] / 1e12:g} fp64")

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
    launches_by, flagship_model, classic = phase_main(torch, np)
    # 4b. the block3 and mg preconditioners at full size
    precond_launches, precond_iters, models = phase_preconditioners(
        torch, np, flagship_model)
    del flagship_model
    # 4c. the fused and pipelined PCG variants at full size
    classic_iters = dict(precond_iters)
    classic_iters[(FLAGSHIP["nx"], "jacobi")] = classic["iters"]
    variant_launches = phase_variants(torch, np, models, classic_iters,
                                      classic["profile"])
    del models
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
            if variant == "v6":
                records[-1]["launches_preconditioners"] = {
                    path: counts[("v6", dtype)]
                    for path, counts in precond_launches.items()}
                records[-1]["launches_variants"] = {
                    path: counts[("v6", dtype)]
                    for path, counts in variant_launches.items()}
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
