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
                and v7 v5's at every shape both run; v5, v3 and v7 also at
                56 and 64 planes (``BIG_PLANES``: staged in groups of 19)
                on the flagship and their edge shapes, each giving v5's
                bits at 8 planes, with their times and ring;
  4. main     — the flagship structured cube (150^3 cells, 10,328,853
                dofs) solved in mixed precision through ``Solver`` once
                under each of the nine float32 variants
                (``PCG_TPU_PALLAS_V``), v6 last, on the chunked path at
                the JAX package's auto cap (every solve of 4 M dofs or
                more in phases 4-4e takes it: its cap, dispatches,
                refinement cycles and iterations a dispatch are printed),
                with the kernel launch counts and inner cycles of each
                solve (v4's, v7's, v8's and v9's beside v6's at the end);
                then v6 once more on the one-shot path
                (``iters_per_dispatch=0``: the chunked path's overhead in
                ms/iter) and once with a NaN poisoned into the carry
                (``nan@0``: one min-residual restart, its cost beside
                the clean solve); then a profiled window of inner f32
                iterations under v6;
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
  4d. many    — blocked right-hand sides through ``Solver.solve_many``
                (mixed, tol 1e-7, v6; ``MANY_SOLVES``): the 150^3 flagship
                as the width-1 block [F] and the width-4 block [F, 2F,
                F_y, F_z] under jacobi (F_y, F_z: F's face forces on y and
                z), and [F, F_y] at 128^3 under mg; per-column flag,
                iterations, relres and tip against its bar or shear
                estimate, lockstep trips, ms a trip, dof*iter*rhs/s
                against the width-1 rate, launches (float32 >= trips);
                x(2F) = 2 x(F) bit for bit; one blocked float32 matvec at
                R = 4 against four single launches (time, bits); 100
                profiled lockstep trips at R = 4 beside classic's phase-4
                window, 20 of the mg block; two 12x6x5 blocks bitwise
                equal;
  4m. serve   — right after phase 4d, on its flagship Solver: the solve
                service (``serve/``), ``ServeDaemon(widths=(1, 2, 4),
                queue_max=8)`` over a spool of nine jobs
                (``SERVE_JOBS``: scales 1, 2, 0.5 and -1 packed as one
                width-4 block; a ``nan@job:`` poisoned job beside the
                F_y ``rhs`` job; an ``exc@job:`` job; a deadline the cost
                model cannot meet; a spec with neither scale nor rhs):
                each block's width, lockstep trips, ms a trip, wall
                against the admission price and its v6 launches (float32
                >= trips, every other float32 counter 0); each job's
                verdict, one result file and one terminal journal record
                each; x(2F) = 2 x(F) bit for bit; the scale-1 job against
                4d's width-1 [F] block (equal iterations, 1e-12 of
                max|u|, bitwise printed); the kill drill: a ``cli serve
                --synthetic 48,32,32`` child held in its first block by
                ``sleep@job:0``, SIGKILLed once its journal shows the
                block packed, a daemon restarted in this process over the
                same spool on a Solver that ran ``warmup()`` (its
                seconds): both jobs end exactly once with their ordinals;
  4e. general — the general (pattern-type) backend (mixed, jacobi,
                classic, tol 1e-7), run right after phase 4g, before any
                profiler window (one slows every solve after it): the
                150^3 flagship cube through Solver(backend="general")
                (iterations within 5 % of the JAX package's 3334, no
                structured kernel launched); the 22^3/L4 octree flagship
                (5,670,981 dofs, auto backend) with build, partition and
                upload seconds, its bucket layout, flag, relres,
                iterations, inner cycles, time to tol and ms/iter; its
                operator on the card against the CPU's float64 (float64
                1e-12, float32 2e-5 of max|y|; two card matvecs bitwise
                equal; times) and the same at two parts on a 3^3 octree;
                the default bucket grouping's float32 matvec timed
                (``BUCKET_VALUES_CHOICES``);
                the 6^3 octree within max(3, 5 %) of the JAX package's
                1144 iterations; then the 6^3 octree under mg within
                max(3, 5 %) of the JAX package's 28 (the 22^3 octree's mg
                solve, whose hierarchy took ~62 s of host, went to make
                room for the lint phase).  The octree
                models (22^3 and 6^3) are built in child processes
                started with the run, beside phases 3 and 4e's cube, and
                shared by phases 4e to 4k.  The octree's
                jacobi Solver and the 6^3 mg Solver start the scratch
                partition cache (``CACHE_DIR``).  After phase 4d: the
                cube's ms/iter beside phase 4's v6, kernels and launches a
                float32 octree matvec, 100 profiled inner iterations, and
                20 of the 6^3 octree's mg solve;
  4h. hybrid  — run right after phase 4e, on its 22^3/L4 octree model
                object: Solver(backend="hybrid") (mixed, jacobi, classic,
                tol 1e-7) with the seconds of ``partition_hybrid``, of
                the float64 refresh's general partition and of the upload,
                the level table (size, nb, dims, bricks, grid cells), the
                transition cells and combine maps; flag, relres,
                iterations, inner cycles, dispatches, time to tol and
                ms/iter beside 4e's general solve, the solution within
                1e-6 of max|u| of 4e's, the selected float32 kernel
                launched at least levels x iterations times; the float32
                and float64 hybrid operators on the card against the CPU's
                float64 (2e-5, 1e-12 of max|y|; two card matvecs bitwise
                equal; times) and the bucketed refresh (1e-12, bitwise
                twice); every kernel against its plain version on the
                flagship's level batches (one launch a level), timed
                beside the batches' bound (v6 and v1 among them); the 6^3
                octree's level batches (1x1x1, 12^3 and 22x24x24 dense
                levels) likewise, and its solve within max(3, 5 %) of the
                JAX package's 1145 iterations.  After phase 4d: kernels
                and launches a float32 hybrid matvec, 100 profiled inner
                iterations;
  4j. time   — run right after phase 4h: ``NewmarkSolver`` (mixed,
                jacobi, classic, tol 1e-7, dt = 50 x ``stable_dt``, load
                factors 0.5, 1, 1) on the 6^3 octree on the general
                backend and on backend="hybrid", chunked at
                ``TIME_NEWMARK_CAP`` (cut from 22^3 to keep the script
                near 1000 s; 4h measures the 22^3 hybrid path, 4e the
                22^3 general one): each step's flag,
                relres, iterations, ms/iter and seconds, partition and
                upload seconds, cap and dispatches; the hybrid's
                iterations within max(3, 5 %) of the general's a step,
                its u within 1e-6 of max|u|, its selected float32 kernel
                launched at least levels x inner iterations times and
                v6's float64 kernel at least once; ``DynamicsSolver``
                (dt = stable_dt, 500 steps, damping 0.1, two probes, a
                frame every 250) on the 6^3 octree in float64 on the
                general and the hybrid backends (the 22^3 float64 run
                was cut to make room for phase 4n) (within 1e-9 of max|u|, v6's
                double kernel exactly levels x steps times) and in
                float32 on the hybrid one (its selected kernel exactly
                levels x steps times, its probes against the float64
                general ones): finite, two frames, seconds a step,
                chunks and their host reads (torch's sync debug mode
                counts every synchronising call: one a chunk, one a frame
                and the final fetch);
  4k. graph cache — run right after phase 4j, on 4e's octree model and
                Solvers: the octree at ``GRAPH_PARTS`` (8) parts under
                partition_method="graph" (the native partitioner, built
                with g++ at first use), general backend, mixed, cold into
                the scratch cache: the seconds of ``part_mesh_dual`` and
                of the partition beside the one-part RCB's, part sizes
                (none empty, within 10 % of the ideal), the dual graph's
                edge cut and the interface dofs beside RCB's at 8 parts,
                the element map's sha256, flag, iterations (within max(3,
                5 %) of 4e's one-part solve), ms/iter; the same Solver
                warm (``setup_cache`` cold then warm, the partition equal
                array for array, load seconds, the solve bitwise the
                cold one's); the 6^3 octree on the hybrid backend at 8
                parts under "graph" (iterations within max(3, 5 %) of the
                one-part hybrid's 1149, v6 launched at least levels x
                iterations times); 4e's 6^3 mg Solver built again, warm
                from 4e's entry (hierarchy and bounds equal array for
                array, the solve bitwise the cold one's; the 22^3 mg
                Solver warm was cut to make room for phase 4n); then
                the scratch cache is removed;
  4g. many chunked — run right after phase 3, before 4e (it needs no
                octree, so it runs while the octree flagship's child
                builds): the chunked blocked path
                of ``Solver.solve_many`` on the 150^3 flagship, direct
                float64, classic, jacobi, [F, F_y] at the auto cap: cap,
                dispatches, per-column flag, iterations and tip, ms a
                trip, dof*iter*rhs/s, float64 v6 launches (>= trips);
                then on the 48x32x32 cube's [F, F_y] at cap 100: the
                same block one-shot (iterations equal, max|dx| <= 1e-12
                max|x|, bitwise printed); ``nan@col:1`` (one restart of
                column 1, column 0 bitwise the clean block's) and at
                ``max_recoveries=0`` (column 1 quarantined, flag 5); a
                block of 3 killed at boundary 2 and resumed with
                ``solve_many(resume=True)``, bitwise;
  4i. export — run right after phase 4, on the solvers phases 4, 4e and
                4h hold: the nodal fields D, ES, PS1-3 and PE1-3 of phase
                4's v6 flagship solution on the card against the host
                float64 oracle (``elem_strain_host``, ``elem_stress_host``,
                ``nodal_average_host``), two exports bitwise equal, their
                card seconds, a Boundary .vtu of U and PS1 written and
                read back; the 22^3/L4 octree's fields on the general and
                the hybrid operators from the general solve's solution
                against the same oracle and each other; NS on a 24^3 cut
                through ``Solver.solve(store=)`` on the card against the
                CPU, and the NS operator's device apply against its CSR;
                the mixed flagship under ``WINDOW_SOLVES`` (iterations,
                inner cycles, time to tol beside 3334); the CLI in
                subprocesses: the cube (48^3) and octree demos beside
                ingest -> partition -> solve -> export of a 48x32x32 cube
                written by ``write_mdf`` and zipped, and ``newmark`` (3
                steps, every one flag 0) and ``dynamics`` (100 steps) on
                the ingested bundle;
  4f. resilience — on the 48x32x32 cube at cap 100: direct float64
                chunked against one-shot (classic, fused, pipelined: x
                bitwise); mixed ``inf@0,inf@1`` escalating to f64 (the
                float64 v6 counter covers the escalated iterations);
                block3 ``rho0@1,rho0@2`` taking the fallback
                preconditioner; ``exc@3`` re-dispatched from a snapshot
                (bitwise the clean solve); ``kill@2`` on two steps,
                resumed in a new Solver (bitwise the whole run); on the
                12x6x5 cube, Newmark killed by ``kill@s:2`` and resumed
                in a new solver, explicit dynamics with ``nan@s:3``
                rolled back, each bitwise its uninterrupted run;
  5. checks   — a direct float64 solve (48x32x32) to flag 0, and small
                mixed and direct solves on the card against the same
                solves on the CPU (the plain path): classic under jacobi,
                block3 and mg, fused and pipelined under jacobi and mg;
                then blocks [F, F_y, F_z] (12x6x5, mg 12x8x8) under
                classic, fused and pipelined with jacobi and mg; then the
                mixed shell's plateau and progress windows, each set so
                that it fires, on the card against the CPU
                (``WINDOW_CARD_VS_CPU``); then Newmark (direct block3,
                mixed jacobi; tol 1e-12) and float64 explicit dynamics on
                the 12x6x5 cube, the card against the CPU (1e-10 of
                max|u|; Newmark iterations +-1 a step direct, the mixed
                totals printed with their inner cycles);
  4n. multi-process — after phase 5, before 4l: two ranks of a
                ``torch.distributed`` gloo group on the one card
                (``PCG_TPU_COORDINATOR`` / ``PCG_TPU_NUM_PROCS`` /
                ``PCG_TPU_PROC_ID``, children of this script): the 150^3
                flagship (structured, v6, mixed, jacobi, classic, the
                chunked path) at ``MP_PARTS`` parts over the two ranks,
                its flag, iterations (within one of this process's
                ``MP_PARTS``-part solve on the card and within 5 % of the
                JAX package's 3334), the same result line on both ranks,
                u against the one-process solution (``MP_U_TOL`` of
                max|u|), ms/iter, the collectives an iteration and halo
                bytes a matvec, and v6's launches on each rank; then, in
                the same ranks, a general cube solve, a hybrid solve of
                the 6^3 octree and a block3 Newmark run, each against one
                process on the card; then the kill drill: ``kill@rank:1``
                under a ``MP_DEADLINE_S`` deadline, rank 0 raising
                ``DeadPeerError`` naming rank 1 within it and leaving a
                committed snapshot epoch, which ``resume_elastic`` takes
                onto this one process to the uninterrupted flag;
  4l. telemetry — last, after every timed solve a profiler window could
                slow: the flagship (mixed, classic, jacobi, v6, chunked at
                the auto cap) through two Solvers, the ring off and
                ``trace_resid`` = ``TELEMETRY_RING`` with the JSONL sink
                and a flight file: ms/iter of each (the pieces apart:
                ``tools/telemetry_overhead.py``), then each solve again
                under torch's sync debug mode (the same number of
                synchronising calls), flag, iterations and u bitwise
                equal, the ring holding every iteration with each inner
                cycle's exit flag where the cycle ends; the JSONL stream
                valid and ending with the run summary (printed), the
                flight file clean, a child SIGKILLed inside a 48x32x32
                dispatch leaving a died verdict with the dispatch in
                flight; the cost model's prediction beside the phase
                probe and the measured ms/iter; ``capture_solve_profile``
                over ``TELEMETRY_WINDOW`` inner iterations in a fresh
                child process (its flagship Solver built at the start;
                a long process's trace can miss device events) read back
                by ``obs/profview.py``: the phase split, every v6 launch
                of the window in the trace and in matvec, the phase sum
                plus ``other`` within 2 % of the window's device time;
  4o. lint    — after 4l (its recordings run under torch.profiler): the
                contract lint (``analysis/``, ``run_lint(fast=True,
                device="cuda")``) with its trip rules recorded by two gloo
                ranks on ``cuda:(rank % device_count)``, exit 0 required;
                each program's per-trip counts (all-reduces, plane
                exchanges, host reads, aten ops, launches) on their own
                lines, v6 launched once a matvec on the structured
                programs; then one seeded violation on the card: an extra
                ``_read`` a trip injected through the recorder's probe
                hook, which the hot-loop-purity rule must report.
The line before the last is the per-kernel JSON record (one per variant
and dtype, launch counts from the solve under that variant; v6's also by
preconditioner solve of phase 4b, by variant solve of phase 4c, by
block of phase 4d, float32 of phase 4's one-shot solve and of phase 4f's
escalating solve, float64 of phase 4g's chunked block; every record's
``launches_hybrid`` from phase 4h's flagship solve and ``hybrid_levels``
from its level batches, ``launches_newmark`` and ``launches_dynamics``
from phase 4j's Newmark runs and explicit runs, ``launches_graph`` from
phase 4k's 8-part hybrid solve, ``launches_serve`` from phase 4m's
flagship blocks; v6's ``launches_multiprocess`` by rank from phase 4n's
two-rank flagship solve, and v6 float32's ``launches_lint``, phase 4o's
structured float32 trips by kind on rank 0), the last line
{"ok": true, "device": {...}}.  Without a CUDA device the script exits 1
and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import shutil
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
# every f32 GV cycle ends on a flag-4 breakdown; on the one-shot path a
# refresh fails to halve the f64 residual, both packages on the CPU at
# 48^3, 64^3 and 96^3; on the chunked path, which the flagship takes,
# two refreshes in a row fail to cut it by 10 %, both packages on the CPU
# at 48^3 with the flagship's cap; PERF.md, Findings).  Phase 4c holds
# the port to that outcome.
STALLS = {(150, "jacobi", "pipelined", "mixed")}
# phase 4d: (cells a side, preconditioner, columns) of each blocked mixed
# solve through Solver.solve_many; F is the flagship's traction load, 2F
# twice it, F_y and F_z its +x face forces moved onto y and z (shear load
# cases).  The two 150^3 blocks share one Solver.
MANY_SOLVES = ((150, "jacobi", ("F",)),
               (150, "jacobi", ("F", "2F", "F_y", "F_z")),
               (128, "mg", ("F", "F_y")))
# phase 5's blocked card-against-CPU solves, [F, F_y, F_z] on the traction
# cube, in direct and mixed precision
MANY_CARD_VS_CPU = tuple(
    (v, pc, MG_CARD_VS_CPU_CELLS if pc == "mg" else CARD_VS_CPU_CELLS)
    for v in ("classic", "fused", "pipelined") for pc in ("jacobi", "mg"))
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
# the chunks the JAX package's pallas_planes accepts above the 54 whose
# ring of two whole chunks fits a block's shared memory: the gather stages
# them in groups (v5_group, 19 on the 8-row tile); v5, v3 and v7 run them
# on the flagship slab too, and every run at them must give v5's bits at
# 8 planes
BIG_PLANES = (56, 64)
V5_EDGE_PLANES = (8, 16) + BIG_PLANES
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
# phase 4e: the octree flagship, bench.py's BENCH_MODEL=octree model at
# its first rung (pcg_mpi_solver_tpu/bench.py:288-293, ladder "22,18,12"):
# 5,670,981 dofs
OCTREE_FLAGSHIP = dict(n=22, max_level=4, n_incl=6, seed=2, E=30e9, nu=0.2,
                       load="traction", load_value=1e6)
# phase 4n: the parts over the two ranks (6, three slabs a rank: the
# structured slab needs a part count that divides nx = 150, which 8 does
# not; at 8 the flagship routes to the general backend), u's tolerance
# against the one-process solution (of max|u|), the kill drill's
# collective deadline, and each spawn's bound
MP_PARTS = 6
MP_U_TOL = 1e-4
MP_DEADLINE_S = 10.0
MP_SPAWN_TIMEOUT_S = 400.0
# its two-part operator check on a small octree of the same arguments
OCTREE_P2 = dict(n=3, max_level=3)
# the octree whose iterations are held to the JAX package's count
OCTREE_PARITY_N = 6
# phase 4g: the chunked blocked flagship's tolerance, and the terminal
# flag of a quarantined column (solver/pcg.QUARANTINE_FLAG)
MANY_CHUNKED_TOL = 1e-7
QUARANTINE = 5
# The JAX package's count for that octree (385,056 dofs; mixed, jacobi,
# classic, tol 1e-7, one part, iters_per_dispatch=0): flag 0 in 1144
# iterations, relres 4.9305e-08 (tools/octree_jax_count.py, the JAX
# Solver on the CPU)
JAX_OCTREE6_ITERS = 1144
# ... and under mg (the hierarchy from the 96^3 octree lattice, levels 48
# ... 3): flag 0 in 28 iterations, relres 2.4393e-08
# (``python tools/octree_jax_count.py 6 --precond mg``, the JAX Solver on
# the CPU)
JAX_OCTREE6_MG_ITERS = 28
# ... and on the hybrid backend (the 1x1x1, 12^3 and 22x24x24 levels
# beside the tiled 8^3 ones): flag 0 in 1145 iterations, relres 4.8499e-08
# (``PCG_TPU_ENABLE_HYBRID=1 python tools/octree_jax_count.py 6``, or
# ``--backend hybrid``; the JAX Solver on the CPU, one-shot; its chunked
# path, which both packages take on this backend, counts 1149)
JAX_OCTREE6_HYBRID_ITERS = 1145
# the general matvec on the card against the CPU's float64, x max|y|
OPERATOR_TOL = {"float64": 1e-12, "float32": 2e-5}
# bucket groupings (plan_buckets' cost of a bucket, in element values)
# timed on the octree's operator: the default alone (500,000 and 8,000,000
# went to make room for the telemetry phase, 0 = one bucket a sign
# sub-type for the lint phase)
BUCKET_VALUES_CHOICES = (2_000_000,)
# phase 4i: the nodal export fields (the export variables D ES PS PE) and
# their tolerance against the host float64 oracle, x max|field| (both
# float64; the card sums in another order)
EXPORT_VARS = ("D", "ES", "PS", "PE")
EXPORT_FIELDS = ("D", "ES", "PS1", "PS2", "PS3", "PE1", "PE2", "PE3")
EXPORT_TOL = 1e-10
# the nonlocal (NS) field on a cut: its operator holds ~13^3 neighbours an
# element (the box of half-width 3.2 x 2 x median h), ~7e9 nonzeros at the
# flagship's 3.375 M cells, so it runs on a 24^3 heterogeneous cube
NS_CUT_CELLS = 24
NS_TOL = 1e-8           # card against CPU solves at tol 1e-10
# the mixed shell's windows at the flagship: (name, options, dispatch cap,
# the flags it may end on): the progress exit at the JAX package's
# BENCH_PROGRESS=150 target, and a plateau window of 200 on the chunked
# path (the auto cap) and on the one-shot shell (``pcg_mixed``).  The
# plateau window stalls the refinement here (flag 3; PERF.md PR 19): its
# early exits leave a residual the next cycles cannot cut by 0.1 % within
# 200 iterations, the false trigger the JAX package's config documents for
# the knob (pcg_mpi_solver_tpu/config.py:61-68; its own A/B diverged with
# flag 3 at 48^3, window 30, docs/BENCH_LOG.md), so a stall is an outcome
# of the algorithm and is printed, not refused
WINDOW_SOLVES = (("progress", dict(mixed_progress_window=150), -1, (0,)),
                 ("plateau", dict(mixed_plateau_window=200), -1, (0, 3)),
                 ("plateau one-shot", dict(mixed_plateau_window=200), 0,
                  (0, 3)))
# phase 5's windowed mixed solves: the CPU tests' model and settings
# (tests/test_torch_pcg.py), each window set so that it fires, and the
# JAX package's flag there (the plateau window stalls the refinement)
WINDOW_CUBE = ((16, 6, 6), dict(E=30e9, heterogeneous=True, seed=5,
                                load_value=1e6))
WINDOW_CARD_VS_CPU = (("plateau", dict(mixed_plateau_window=25), 3),
                      ("progress", dict(mixed_progress_window=10), 0))
# phase 4i's CLI run: the cube written as an MDF bundle, and the time
# integrators' steps on it
CLI_CELLS = (48, 32, 32)
CLI_NEWMARK_STEPS = 3
CLI_EXPLICIT_STEPS = 100
# phases 4f and 5: the time integrators on the 12x6x5 cube: Newmark's load
# factors, and the explicit steps
TIME_CHECK_DELTAS = (0.5, 1.0, 1.0, 0.7, 0.3)
TIME_CHECK_STEPS = 100
# phase 4j: the time integrators on the octree flagship and its 6^3 cut.
# Newmark's dt is 50 x the explicit CFL bound (tests/test_newmark.py::
# test_newmark_unconditional_stability's factor) over three load factors;
# the explicit runs take the CFL dt over 500 steps with a frame every 250
TIME_NEWMARK_DT_FACTOR = 50.0
TIME_NEWMARK_DELTAS = (0.5, 1.0, 1.0)
# the 6^3 Newmark's chunk cap: each step (176-193 iterations) runs on
# the chunked path, which the 22^3 run drove at the auto cap before it
# was cut to keep the script near 1000 s
TIME_NEWMARK_CAP = 100
TIME_EXPLICIT_STEPS = 500
TIME_EXPLICIT_EXPORT = 250
# phase 4k: the native graph partition and the partition cache.  The
# octree flagship at 8 parts (BASELINE config 3's 8-way METIS split) under
# partition_method="graph", beside the one-part RCB partition's 21.42 s
# (PERF.md §5); the 6^3 octree on the hybrid backend at 8 parts, beside
# the one-part hybrid's 1149 iterations (PERF.md §5); phase 4e's octree
# Solvers and 4k's share one scratch cache directory under build/,
# removed after 4k
GRAPH_PARTS = 8
ONE_PART_RCB_PARTITION_S = 21.42
HYBRID6_ONE_PART_ITERS = 1149
CACHE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_cache")


# The octree models several phases use (the flagship and its 6^3 cut) are
# built once, in child processes started with the run: the flagship's
# host build (over a minute) overlaps phases 3 and 4e's cube instead of
# holding the card idle.  Every phase shares the one object of each (a
# Solver reads a model and never writes it).
_OCTREE_CHILD = r"""
import json, os, pickle, sys, time
from pcg_mpi_solver_tpu_torch.models.octree import make_octree_model
n, path, kw = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
t0 = time.perf_counter()
model = make_octree_model(n, n, n, **kw)
seconds = time.perf_counter() - t0
with open(path + ".tmp", "wb") as f:
    pickle.dump((model, seconds), f, protocol=pickle.HIGHEST_PROTOCOL)
os.replace(path + ".tmp", path)
"""


class OctreeModels:
    """``make_octree_model(n, n, n, **OCTREE_FLAGSHIP-but-n)`` for each n,
    built in a child process started at construction; :meth:`get` waits
    for it, loads the model and returns (model, child build seconds,
    seconds waited)."""

    def __init__(self, sizes):
        root = os.path.dirname(os.path.abspath(__file__))
        os.makedirs(os.path.join(root, "build"), exist_ok=True)
        kw = dict(OCTREE_FLAGSHIP)
        kw.pop("n")
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.models, self.procs = {}, {}
        for n in sizes:
            path = os.path.join(root, "build", f"chip_smoke_octree{n}.pkl")
            proc = subprocess.Popen(
                [sys.executable, "-c", _OCTREE_CHILD, str(n), path,
                 json.dumps(kw)], cwd=root, env=env)
            self.procs[n] = (proc, path)

    def get(self, n):
        import pickle

        if n not in self.models:
            proc, path = self.procs.pop(n)
            t0 = time.perf_counter()
            if proc.wait() != 0:
                raise RuntimeError(f"the octree {n}^3 build failed "
                                   f"({proc.returncode})")
            with open(path, "rb") as f:
                model, seconds = pickle.load(f)
            os.remove(path)
            self.models[n] = (model, seconds, time.perf_counter() - t0)
        return self.models[n]

    def close(self):
        for proc, path in self.procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            for p in (path, path + ".tmp"):
                if os.path.exists(p):
                    os.remove(p)
        self.procs = {}


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
                elif shape == shapes[name][-1] and dtype == torch.float32:
                    plane_runs += [(gv, pl) for pl in BIG_PLANES]
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
                        f"{g5.threads} threads, {g5.smem_bytes} B shared: "
                        f"a ring of {2 * g5.group + 2} slots, staged in "
                        f"groups of {g5.group} planes")
                    if pl in BIG_PLANES and not (
                            g5.group < pl
                            and g5.smem_bytes <= 232448):
                        raise AssertionError(f"{gv} planes={pl}: {g5}")
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
            # every chunk staged in groups gives v5's bits at 8 planes
            for k in [k for k in ys if k[0] in GATHER
                      and k[1] in BIG_PLANES]:
                if ("v5", 8) not in ys:
                    raise AssertionError(f"{k} ran at {shape} without v5 "
                                         f"at 8 planes")
                same = torch.equal(ys[k], ys[("v5", 8)])
                say(f"  {k[0]} planes={k[1]} against v5 planes=8: "
                    f"{'the same bits' if same else 'DIFFERENT bits'}")
                if not same:
                    raise AssertionError(f"{k[0]} planes={k[1]} {name} "
                                         f"{shape} does not give v5's bits "
                                         f"at 8 planes")
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
def inner_cycles(solver):
    """Records (flag, iterations) of every f32 inner cycle of ``solver``'s
    solve inside the block: on the chunked path (dispatch cap > 0) its
    refinement cycles from the solver's dispatch log (the last step's),
    else each ``pcg`` call of the one-shot ``pcg_mixed``.  The flagship's
    cycles end on stagnation exits (flag 3), whose iteration depends on
    round-off, so this is where the variants' totals part."""
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
        if solver._dispatch_cap > 0:
            cycles[:] = [(f, n) for k, f, n in solver.dispatch_log
                         if k == "refine"]


def dispatches(solver) -> str:
    """The chunked path's record of ``solver``'s last step: the cap, the
    capped calls, the refinement cycles and the iterations of each
    call; "one-shot" at cap 0."""
    cap = solver._dispatch_cap
    if cap <= 0:
        return "one-shot (cap 0)"
    calls = [n for k, n, _f in solver.dispatch_log if k != "refine"]
    cycles = sum(k == "refine" for k, _n, _f in solver.dispatch_log)
    return (f"cap {cap}: {len(calls)} dispatches, {cycles} refinement "
            f"cycles, iterations a dispatch {calls}")


def phase_main(torch, np, model):
    """The flagship mixed solve of ``model`` once under each float32
    variant; returns {variant: launch counts of its solve} and v6's
    iterations, ms/iter and inner-loop profile.  Ends with v4's, v7's, v8's and
    v9's inner cycles beside v6's: the stagnation exits that end the
    cycles move with the round-off of the cell product (v4 and v8 run v6
    float's FFMA product and node sums; a DMMA product moved the second
    exit by 200 iterations, PERF.md, Findings; v7 runs v5's gather, v9
    sums in another order than v6)."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    from pcg_mpi_solver_tpu_torch.solver.chunked import auto_dispatch_cap

    nx = FLAGSHIP["nx"]
    say(f"main: the JAX package recorded flag 0 and {JAX_FLAGSHIP_ITERS} "
        f"iterations for this configuration")
    cfg = RunConfig(solver=SolverConfig(tol=1e-7, precision_mode="mixed"))
    # the JAX package's rule: chunked above 4 M dofs, one device holding
    # every row
    auto_cap = auto_dispatch_cap(cfg.solver, model.n_dof, model.n_dof)
    say(f"main: {model.n_dof} dofs >= 4,000,000: the chunked path at the "
        f"auto cap max(200, int(45 / (4e-9 x {model.n_dof}))) = "
        f"{auto_cap} iterations a dispatch")
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
        with inner_cycles(solver) as cycles:
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
            f"(flag, iterations) {cycles}; launches {shown}; "
            f"{dispatches(solver)}")
        if res.flag != 0 or not res.relres <= 1e-7:
            raise AssertionError(f"flagship solve under {variant} did not "
                                 f"converge: {res}")
        if solver._dispatch_cap != auto_cap:
            raise AssertionError(f"flagship solve under {variant}: cap "
                                 f"{solver._dispatch_cap}, not the JAX "
                                 f"package's auto cap {auto_cap}")
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
            classic = dict(iters=res.iters, ms_iter=wall / iters * 1e3,
                           wall=wall)
            # the chunked path's cost and its resilience, on the card,
            # before the profiler window (one slows every solve after it)
            classic["oneshot"] = oneshot_flagship(torch, np, model, cfg,
                                                  classic)
            classic["faulted"] = faulted_flagship(torch, np, model, cfg,
                                                  classic)
            classic["profile"] = profile_inner(torch, solver)
            # phase 4i exports this solution
            classic["solver"] = solver
        launches_by[variant] = launches
        cycles_by[variant] = (cycles, res.iters)
        del solver, u
        torch.cuda.empty_cache()
    for v in ("v4", "v7", "v8", "v9", "v6"):
        say(f"main: inner cycles (flag, iterations) {v} {cycles_by[v][0]}, "
            f"{cycles_by[v][1]} in all")
    return launches_by, classic


def oneshot_flagship(torch, np, model, cfg, chunked):
    """The v6 flagship solve of phase 4 once more on the one-shot path
    (``iters_per_dispatch=0``: one ``pcg_mixed`` call), right after the
    chunked one and before any profiler window: the chunked path's
    overhead is the gap between the two solves' ms/iter (predicted under
    1 %).  Returns {"ms_iter", "wall", "iters"}."""
    import dataclasses

    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    cfg0 = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, iters_per_dispatch=0))
    solver = Solver(model, cfg0)
    torch.cuda.synchronize()
    reset_launch_counts()
    with inner_cycles(solver) as cycles:
        res = solver.solve()[-1]
    f32 = LAUNCHES[("v6", "float32")]
    ms = res.wall_s / res.iters * 1e3
    gap = chunked["ms_iter"] / ms - 1
    say(f"main v6 one-shot: flag {res.flag}, iterations {res.iters}, relres "
        f"{res.relres:.4e}, time to tol {res.wall_s:.3f} s, {ms:.4f} "
        f"ms/iter; inner cycles (flag, iterations) {cycles}; launches f32 "
        f"{f32}; {dispatches(solver)}")
    say(f"main v6 chunked against one-shot: {chunked['ms_iter']:.4f} "
        f"against {ms:.4f} ms/iter (chunked {gap * 100:+.2f} %), time to "
        f"tol {chunked['wall']:.3f} against {res.wall_s:.3f} s, iterations "
        f"{chunked['iters']} against {res.iters}")
    if res.flag != 0 or not res.relres <= 1e-7 or f32 < res.iters or abs(
            res.iters - JAX_FLAGSHIP_ITERS) > ITERS_TOL * JAX_FLAGSHIP_ITERS:
        raise AssertionError(f"one-shot flagship solve: {res}, {f32} "
                             f"float32 launches")
    del solver
    torch.cuda.empty_cache()
    return dict(ms_iter=ms, wall=res.wall_s, iters=res.iters, f32=f32)


class _Events:
    """Metrics sink collecting the recorder's events."""

    def __init__(self):
        self.events = []

    def emit(self, ev):
        self.events.append(ev)

    def rungs(self):
        return [(e["action"], e["trigger"]) for e in self.events
                if e["kind"] == "recovery"]

    def cache_wall(self, label):
        """Seconds the partition cache spent on its ``label`` entries: the
        load when warm, the build and store when cold."""
        return sum(e["wall_s"] for e in self.events
                   if e["kind"] == "cache"
                   and e["name"] == f"partition.{label}")


def faulted_flagship(torch, np, model, cfg, clean):
    """Phase 4f's flagship case, run in phase 4 beside the clean chunked
    solve (before the profiler window): the v6 flagship with a NaN
    poisoned into the carry at the first chunk boundary
    (``FaultPlan("nan@0")``) recovers through one min-residual restart to
    flag 0 and relres <= 1e-7.  Returns {"iters", "wall"}."""
    from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
    from pcg_mpi_solver_tpu_torch.resilience import FaultPlan
    from pcg_mpi_solver_tpu_torch.solver import Solver

    ev = _Events()
    solver = Solver(model, cfg, recorder=MetricsRecorder(sinks=[ev]))
    solver.fault_plan = FaultPlan("nan@0", recorder=solver.recorder)
    res = solver.solve()[-1]
    say(f"resilience flagship nan@0: flag {res.flag}, iterations "
        f"{res.iters}, relres {res.relres:.4e}, wall {res.wall_s:.3f} s "
        f"(clean chunked: {clean['iters']} iterations, {clean['wall']:.3f} "
        f"s; {res.wall_s - clean['wall']:+.3f} s); recovery "
        f"{ev.rungs()}; {dispatches(solver)}")
    if res.flag != 0 or not res.relres <= 1e-7 \
            or ev.rungs() != [("restart_minres", "nan_carry")]:
        raise AssertionError(f"faulted flagship: {res}, rungs {ev.rungs()}")
    del solver
    torch.cuda.empty_cache()
    return dict(iters=res.iters, wall=res.wall_s)


def phase_resilience(torch, np):
    """Phase 4f: the chunked path and its recovery ladder on the 48x32x32
    cube (``DIRECT_F64_CELLS``, cap 100), each check raising: direct f64
    chunked against one-shot under classic, fused and pipelined (flag,
    iterations, x bitwise); mixed with ``inf@0,inf@1`` at 3 recoveries
    escalating to f64 (tol 1e-9, inner_tol 0.1; the float64 v6 counter
    grows by at least the escalated iterations); direct block3 with ``rho0@1,rho0@2`` taking the
    fallback preconditioner; ``exc@3`` re-dispatched from a snapshot,
    bitwise the clean solve; a two-step solve killed at boundary 2 and
    resumed in a new Solver, bitwise the uninterrupted run.  Checkpoints
    go under ``build/`` of the checkout.  Returns the v6 launch counts of
    the escalating solve."""
    import dataclasses
    import shutil

    from pcg_mpi_solver_tpu_torch import (
        RunConfig, SolverConfig, TimeHistoryConfig)
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.resilience import (
        FaultPlan, SimulatedKill)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    kw = dict(FLAGSHIP)
    kw.pop("nx")
    model = make_cube_model(*DIRECT_F64_CELLS, **kw)
    cells = "x".join(map(str, DIRECT_F64_CELLS))
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_checkpoints")
    shutil.rmtree(scratch, ignore_errors=True)

    def run(cap, fault=None, deltas=(0.0, 1.0), run_id="1", **solver_kw):
        solver_kw = dict(dict(tol=1e-7, dtype="float64"), **solver_kw)
        rkw = {k: solver_kw.pop(k) for k in ("snapshot_every",
                                             "checkpoint_every")
               if k in solver_kw}
        cfg = RunConfig(scratch_path=scratch, run_id=run_id,
                        solver=SolverConfig(iters_per_dispatch=cap,
                                            **solver_kw),
                        time_history=TimeHistoryConfig(
                            time_step_delta=deltas), **rkw)
        ev = _Events()
        s = Solver(model, cfg, recorder=MetricsRecorder(sinks=[ev]))
        if fault is not None:
            s.fault_plan = FaultPlan(fault, recorder=s.recorder)
        return s, ev

    # 1. chunked against one-shot, bitwise, under each variant
    clean = {}
    for variant in ("classic", "fused", "pipelined"):
        out = []
        for cap in (100, 0):
            s, _ = run(cap, pcg_variant=variant)
            r = s.solve()[-1]
            out.append((r, s.un.clone(), dispatches(s)))
        (rc, uc, dc), (ro, uo, _) = out
        same = (rc.flag, rc.iters, rc.relres) == (ro.flag, ro.iters,
                                                   ro.relres) \
            and torch.equal(uc, uo)
        say(f"resilience {cells} direct f64 {variant}: cap 100 flag "
            f"{rc.flag}, {rc.iters} iterations, {rc.wall_s:.3f} s; cap 0 "
            f"flag {ro.flag}, {ro.iters} iterations, {ro.wall_s:.3f} s; x "
            f"{'bitwise equal' if same else 'DIFFERENT'}; {dc}")
        if not same or rc.flag != 0:
            raise AssertionError(f"{cells} {variant}: chunked is not the "
                                 f"one-shot solve")
        clean[variant] = (rc, uc)
    clean_r, clean_u = clean["classic"]

    # 3. mixed, inf twice: restart, then f64 escalation
    torch.cuda.synchronize()
    reset_launch_counts()
    # (tol 1e-9, inner_tol 0.1, as the JAX package's test of the rung: a
    # short cycle, so the second inf lands after the restart)
    s, ev = run(100, "inf@0,inf@1", precision_mode="mixed",
                max_recoveries=3, tol=1e-9, inner_tol=0.1)
    r = s.solve()[-1]
    f64 = LAUNCHES[("v6", "float64")]
    escalated = sum(n for k, n, _f in s.dispatch_log if k == "cycle")
    launches = dict(LAUNCHES)
    say(f"resilience {cells} mixed inf@0,inf@1: flag {r.flag}, "
        f"{r.iters} iterations ({escalated} escalated to f64), relres "
        f"{r.relres:.4e}; recovery {ev.rungs()}; float64 v6 launches {f64}")
    if r.flag != 0 or ("escalate_f64", "nan_carry") not in ev.rungs() \
            or escalated == 0 or f64 < escalated:
        raise AssertionError(f"mixed escalation: {r}, {ev.rungs()}, "
                             f"{f64} float64 launches")

    # 4. block3, rho = 0 twice: restart, then the fallback preconditioner
    s, ev = run(100, "rho0@1,rho0@2", precond="block3")
    r = s.solve()[-1]
    say(f"resilience {cells} direct block3 rho0@1,rho0@2: flag {r.flag}, "
        f"{r.iters} iterations, relres {r.relres:.4e}; recovery "
        f"{ev.rungs()}")
    if r.flag != 0 or ev.rungs() != [("restart_minres", "flag4"),
                                     ("fallback_prec", "flag4")]:
        raise AssertionError(f"block3 fallback: {r}, {ev.rungs()}")

    # 5. device loss before dispatch 3, re-dispatched from the snapshot
    s, ev = run(100, "exc@3", snapshot_every=1, run_id="exc")
    r = s.solve()[-1]
    same = (r.flag, r.iters, r.relres) == (clean_r.flag, clean_r.iters,
                                           clean_r.relres) \
        and torch.equal(s.un, clean_u)
    say(f"resilience {cells} exc@3 with snapshots: flag {r.flag}, "
        f"{r.iters} iterations; recovery {ev.rungs()}; against the clean "
        f"solve {'bitwise equal' if same else 'DIFFERENT'}")
    if not same or ev.rungs() != [("redispatch", "device_loss")]:
        raise AssertionError(f"re-dispatch: {r}, {ev.rungs()}")

    # 6. kill at boundary 2 of a two-step solve, resume in a new Solver
    two = dict(deltas=(0.0, 0.5, 1.0), snapshot_every=1, checkpoint_every=1)
    sa, _ = run(100, run_id="whole", **two)
    sa.solve()
    sk, _ = run(100, "kill@2", run_id="killed", **two)
    try:
        sk.solve()
        killed = False
    except SimulatedKill:
        killed = True
    sr, ev = run(100, run_id="killed", **two)
    sr.solve(resume=True)
    same = (sr.flags, sr.iters, sr.relres) == (sa.flags, sa.iters,
                                               sa.relres) \
        and torch.equal(sr.un, sa.un)
    ops = [e["op"] for e in ev.events if e["kind"] == "snapshot"]
    say(f"resilience {cells} kill@2 and resume: killed {killed}, resumed "
        f"(flags, iterations) {list(zip(sr.flags, sr.iters))} against "
        f"{list(zip(sa.flags, sa.iters))}, snapshot ops {ops[:1]}...; "
        f"{'bitwise equal' if same else 'DIFFERENT'}")
    if not (killed and same and ops[:1] == ["restore"]):
        raise AssertionError("kill and resume is not the uninterrupted run")
    phase_time_resilience(torch, np, scratch)
    shutil.rmtree(scratch, ignore_errors=True)
    return launches


def phase_time_resilience(torch, np, scratch):
    """Phase 4f, the time integrators on the 12x6x5 cube (general
    backend, step snapshots under ``scratch``): Newmark (direct, jacobi,
    tol 1e-10, dt 0.2, ``TIME_CHECK_DELTAS``) killed by ``kill@s:2`` at
    snapshot_every=1 and resumed in a new solver, and explicit dynamics
    (float64, half the CFL dt, ``TIME_CHECK_STEPS`` steps) with
    ``nan@s:3`` rolled back at snapshot_every=3: each bitwise its
    uninterrupted run."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
    from pcg_mpi_solver_tpu_torch.resilience import (
        FaultPlan, SimulatedKill)
    from pcg_mpi_solver_tpu_torch.solver import (
        DynamicsSolver, NewmarkSolver, stable_dt)

    kw = dict(FLAGSHIP)
    kw.pop("nx")
    model = make_cube_model(*CARD_VS_CPU_CELLS, **kw)
    cells = "x".join(map(str, CARD_VS_CPU_CELLS))

    def cfg(run_id, snap=0, **solver_kw):
        c = RunConfig(scratch_path=scratch, run_id=run_id,
                      solver=SolverConfig(**solver_kw))
        c.snapshot_every = snap
        return c

    def newmark(run_id, snap=0):
        return NewmarkSolver(model, cfg(run_id, snap, tol=1e-10), dt=0.2)

    whole = newmark("nm-whole")
    whole.run(TIME_CHECK_DELTAS)
    killed = newmark("nm-killed", 1)
    killed.fault_plan = FaultPlan("kill@s:2")
    try:
        killed.run(TIME_CHECK_DELTAS)
        died = False
    except SimulatedKill:
        died = True
    ev = _Events()
    resumed = NewmarkSolver(model, cfg("nm-killed", 1, tol=1e-10), dt=0.2,
                            recorder=MetricsRecorder(sinks=[ev]))
    rest = resumed.run(TIME_CHECK_DELTAS, resume=True)
    same = ((resumed.flags, resumed.iters, resumed.relres)
            == (whole.flags, whole.iters, whole.relres)
            and all(torch.equal(a, b) for a, b in zip(
                (resumed.u, resumed.v, resumed.w),
                (whole.u, whole.v, whole.w))))
    say(f"resilience {cells} newmark kill@s:2 and resume: killed {died}, "
        f"resumed steps {len(rest)}, iterations {resumed.iters} against "
        f"{whole.iters}; u, v, w "
        f"{'bitwise equal' if same else 'DIFFERENT'}")
    if not (died and same and len(rest) == len(TIME_CHECK_DELTAS) - 2):
        raise AssertionError("newmark kill and resume is not the "
                             "uninterrupted run")

    def explicit(run_id, snap=0, recorder=None):
        return DynamicsSolver(model, cfg(run_id, snap),
                              dt=0.5 * stable_dt(model), damping=0.1,
                              probe_dofs=(int(np.argmax(model.F)),),
                              recorder=recorder)

    clean = explicit("dyn-clean").run(TIME_CHECK_STEPS)
    ev = _Events()
    d = explicit("dyn-nan", 3, MetricsRecorder(sinks=[ev]))
    d.fault_plan = FaultPlan("nan@s:3", recorder=d.recorder)
    res = d.run(TIME_CHECK_STEPS)
    same = (np.array_equal(res.u, clean.u)
            and np.array_equal(res.probe_u, clean.probe_u))
    rolls = [(e["step"], e["to_step"]) for e in ev.events
             if e["kind"] == "recovery"]
    say(f"resilience {cells} explicit nan@s:3 at snapshot_every 3: "
        f"rollbacks (step, to step) {rolls}; u and probes "
        f"{'bitwise equal' if same else 'DIFFERENT'} to the clean run")
    if not same or rolls != [(6, 3)]:
        raise AssertionError("explicit NaN rollback is not the clean run")


def _device_rows(prof):
    """(device us, kernel name, calls) of every device-side event of a
    torch.profiler window (kernels, copies; the aten ops that launched
    them carry the same time again, and the device lanes' copies of the
    solver's phase ranges span them again), longest first."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or getattr(
                ev, "is_user_annotation", False):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    return rows


def profile_inner(torch, solver, iters: int = 100, tag: str = "profile",
                  nrhs: int = 0):
    """Device time by kernel over a window of f32 inner iterations of a
    mixed solver (the body of the mixed solve) under its preconditioner
    and PCG variant, and the device-busy share of the window's wall time.
    ``nrhs`` > 0 profiles ``iters`` lockstep trips of ``pcg_many`` on a
    block of that many columns (the normalised F repeated, each scaled by
    a power of two) instead, counted a trip.  Returns {"wall", "busy"
    (ms/iter, ms/trip for a block), "idle" (share), "kernels" (an
    iteration or a trip), "per_trip" (kernels a trip: a trip launches one
    float32 matvec)}."""
    from torch.profiler import ProfilerActivity, profile

    from pcg_mpi_solver_tpu_torch.ops.precond import make_prec
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import LAUNCHES
    from pcg_mpi_solver_tpu_torch.parallel.structured import block_data
    from pcg_mpi_solver_tpu_torch.solver.pcg import pcg, pcg_many

    ops, data = solver.ops32, solver.data32
    rhs = (data["eff"] * data["F"])
    rhs = rhs / rhs.norm()
    inv = make_prec(ops, data, solver.config.solver.precond)
    variant = solver.config.solver.pcg_variant
    kw = dict(tol=1e-30, max_iter=iters,
              glob_n_dof_eff=solver.pm.glob_n_dof_eff, return_carry=True,
              variant=variant)
    if nrhs:
        rhs = torch.stack([rhs * 2.0 ** -j for j in range(nrhs)])
        data = block_data(data, nrhs)
    f32 = (solver.kernel_variant, "float32")
    torch.cuda.synchronize()
    before = LAUNCHES[f32]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run = pcg_many if nrhs else pcg
        res, carry = run(ops, data, rhs, torch.zeros_like(rhs), inv, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    matvecs = LAUNCHES[f32] - before
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows) / 1e6
    n = res.trips if nrhs else carry["exec"]
    kernels = sum(r[2] for r in rows)
    # a trip's matvecs: one, and the smoothing's under mg (whose check
    # trips have one), so trips are counted only without mg
    trips = None if solver.config.solver.precond == "mg" else matvecs
    unit = "trip" if nrhs else "iter"
    out = dict(wall=wall * 1e3 / n, busy=busy * 1e3 / n,
               idle=1 - busy / wall, kernels=kernels / n,
               per_trip=kernels / trips if trips else None)
    say(f"{tag}: {n} " + (f"lockstep trips of {nrhs} columns"
                          if nrhs else "inner f32 iterations")
        + (f" ({trips} trips)" if trips and not nrhs else "")
        + f", wall {out['wall']:.4f} ms/{unit}, device busy "
        f"{out['busy']:.4f} ms/{unit} ({busy / wall:.1%} of wall; idle "
        f"{out['idle']:.1%}); {out['kernels']:.1f} device kernels an "
        f"{'trip' if nrhs else 'iteration'}"
        + (f", {out['per_trip']:.1f} a trip" if trips and not nrhs else ""))
    for dev_us, key, count in rows[:12]:
        say(f"{tag}:   {dev_us / n / 1e3:9.4f} ms/{unit}  {count:6d} calls"
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
        with inner_cycles(solver) as cycles:
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
            f"(flag, iterations) {cycles}; launches {shown}; "
            f"{dispatches(solver)}")
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
        with inner_cycles(solver) as cycles:
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
            f"iteration); iterations {ratio}; {dispatches(solver)}")
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


def shear_loads(np, model):
    """F_y and F_z: the flagship's +x face forces moved onto the y and z
    components (two shear load cases of the same magnitude)."""
    F = np.asarray(model.F)
    out = []
    for comp in (1, 2):
        g = np.zeros_like(F)
        g[comp::3] = F[0::3]
        out.append(g)
    return out


def tip_estimate(cells: int, shear: bool) -> float:
    """The traction cube's tip estimate: the 1-D bar sigma*L/E along x,
    or, under a shear load, a Timoshenko cantilever's bending plus shear
    deflection (square section of side L: P L^3 / (3 E I) + P L / (kappa
    G A) = sigma L / E * (4 + 2 (1 + nu) / kappa), kappa = 5/6)."""
    sigma = FLAGSHIP["load_value"] * (cells + 1) ** 2 / cells ** 2
    base = sigma * cells / FLAGSHIP["E"]
    if not shear:
        return base
    return base * (4 + 2 * (1 + FLAGSHIP["nu"]) / (5 / 6))


def phase_many(torch, np, models, classic_iters, classic_profile):
    """Phase 4d: blocked right-hand sides through ``Solver.solve_many``
    (mixed, tol 1e-7, v6; ``MANY_SOLVES``), each with the launch counts
    set to 0 just before its Solver is built (or, for a second block on
    one Solver, just before the solve) and read just after; one blocked
    float32 matvec at R = 4 against four single launches at 150^3; 100
    lockstep trips at R = 4 under the profiler beside classic's phase-4
    window, and 20 of the mg block; two 12x6x5 blocks on the card
    bitwise equal.  Returns ({"<cells> <precond> R=<width>": launch
    counts of that solve}, phase 4m's inputs: the flagship jacobi Solver,
    its model, F_y, and the width-1 [F] block's u and iterations)."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts, structured_matvec)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    kw = dict(FLAGSHIP)
    kw.pop("nx")
    launches_by, solvers, width1, serve = {}, {}, {}, {}
    for cells, precond, cols in MANY_SOLVES:
        if cells not in models:
            models[cells] = make_cube_model(cells, **kw)
        model = models[cells]
        F = np.asarray(model.F)
        Fy, Fz = shear_loads(np, model)
        named = {"F": F, "2F": 2 * F, "F_y": Fy, "F_z": Fz}
        torch.cuda.synchronize()
        reset_launch_counts()
        if (cells, precond) not in solvers:
            solvers[(cells, precond)] = Solver(model, RunConfig(
                solver=SolverConfig(tol=1e-7, precision_mode="mixed",
                                    precond=precond)))
        solver = solvers[(cells, precond)]
        if solver.kernel_variant != "v6":
            raise AssertionError(f"many: Solver chose "
                                 f"{solver.kernel_variant}, not v6")
        R = len(cols)
        tag = f"many {cells}^3 {precond} R={R} [{', '.join(cols)}]"
        res = solver.solve_many(np.stack([named[c] for c in cols], -1))
        launches = dict(LAUNCHES)
        f32, f64 = launches[("v6", "float32")], launches[("v6", "float64")]
        u = solver.displacement_global_many(res.x)
        n_it = int(res.iters.max())
        rate = model.n_dof * n_it * R / res.solve_wall_s
        for j, c in enumerate(cols):
            shear = c in ("F_y", "F_z")
            comp = {"F_y": 1, "F_z": 2}.get(c, 0)
            est = tip_estimate(cells, shear) * (2 if c == "2F" else 1)
            tip = float(u[comp::3, j].max())
            say(f"{tag}: column {c}: flag {res.flags[j]}, iterations "
                f"{res.iters[j]}, relres {res.relres[j]:.4e}, tip "
                f"u{'xyz'[comp]} {tip:.4e} m vs "
                f"{'shear' if shear else 'bar'} estimate {est:.4e} m "
                f"(ratio {tip / est:.3f}, window [1/3, 3])")
            if res.flags[j] != 0 or not res.relres[j] <= 1e-7:
                raise AssertionError(f"{tag}: column {c} did not converge")
            if not est / 3 <= tip <= 3 * est:
                raise AssertionError(f"{tag}: column {c} tip outside the "
                                     f"physics window")
        if not np.isfinite(u).all() or u.shape != (model.n_dof, R):
            raise AssertionError(f"{tag}: displacement not finite or "
                                 f"misshapen")
        if R == 1:
            width1[(cells, precond)] = rate
        if (cells, precond, cols) == MANY_SOLVES[0]:
            # phase 4m's reference: the flagship's width-1 [F] block
            serve.update(model=model, F_y=Fy, u_F=u[:, 0].copy(),
                         iters_F=int(res.iters[0]))
        base = width1.get((cells, precond))
        base_txt = (f"{rate / base:.3f}x the width-1 block's "
                    f"{base:.4e} dof*iter/s" if base and R > 1 else
                    "the width-1 rate" if R == 1 else
                    "no width-1 block of this cell in this run")
        classic = classic_iters.get((cells, precond))
        say(f"{tag}: wall {res.wall_s:.3f} s, solve wall "
            f"{res.solve_wall_s:.3f} s, {res.trips} lockstep trips, "
            f"{res.solve_wall_s / res.trips * 1e3:.4f} ms a trip, "
            f"{rate:.4e} dof*iter*rhs/s ({base_txt}); launches f32 {f32}, "
            f"f64 {f64}"
            + (f"; classic step of phase 4/4b: {classic} iterations"
               if classic else ""))
        if f32 < res.trips or f64 < 1 or {
                k: n for k, n in launches.items()
                if n and k not in (("v6", "float32"), ("v6", "float64"))}:
            raise AssertionError(f"{tag}: did not go through v6, one "
                                 f"launch a trip: {launches} for "
                                 f"{res.trips} trips")
        if "2F" in cols:
            jF, j2 = cols.index("F"), cols.index("2F")
            exact = (res.iters[j2] == res.iters[jF]
                     and torch.equal(res.x[..., j2], 2 * res.x[..., jF]))
            say(f"{tag}: column 2F {'takes' if exact else 'DOES NOT take'}"
                f" F's iterations with x = 2 x(F) bit for bit")
            if not exact:
                raise AssertionError(f"{tag}: 2F is not exactly 2 x(F)")
        launches_by[f"{cells} {precond} R={R}"] = launches
        del res, u

    # one blocked float32 launch over R * P slabs against R single ones
    n, R = FLAGSHIP["nx"], 4
    solver = solvers.pop((n, "jacobi"))
    blk = solver.data32["blocks"][0]
    ck4 = blk["ck"].repeat(R, 1, 1, 1)
    g = torch.Generator("cuda").manual_seed(4)
    x = torch.randn((R, 3, n + 1, n + 1, n + 1), generator=g,
                    device="cuda", dtype=torch.float32)

    def blocked():
        return structured_matvec(x.reshape(-1, 3, n + 1, n + 1, n + 1),
                                 ck4, blk["Ke"])

    singles = [lambda j=j: structured_matvec(x[j:j + 1], blk["ck"],
                                             blk["Ke"]) for j in range(R)]
    yb = blocked()
    ys = [fn() for fn in singles]
    torch.cuda.synchronize()
    same = all(torch.equal(yb[j], ys[j][0]) for j in range(R))
    err = max((yb[j] - ys[j][0]).abs().max().item() for j in range(R))
    scale = max(y.abs().max().item() for y in ys)
    ms_b = time_ms(torch, blocked)
    ms_s = time_ms(torch, lambda: [fn() for fn in singles])
    say(f"many matvec {n}^3 float32 R={R}: one launch over {R} slabs "
        f"{ms_b:.4f} ms, {R} single launches {ms_s:.4f} ms "
        f"({ms_s / ms_b:.3f}x); columns "
        + ("bit for bit the single launches" if same else
           f"DIFFER from the single launches by {err:.3e} (v6's geometry "
           f"changes its order with the slab count; phase 3's tolerance "
           f"{KERNEL_TOL['float32']:g} x max|y| {scale:.3e})"))
    if not same and not err <= KERNEL_TOL["float32"] * scale:
        raise AssertionError("the blocked matvec disagrees with its single "
                             "launches")
    del x, ck4, yb, ys

    prof = profile_inner(torch, solver, tag=f"many profile R={R}", nrhs=R)
    p = classic_profile
    say(f"many profile R={R}: busy {prof['busy']:.4f} ms a trip "
        f"({prof['busy'] / R:.4f} a column), idle {prof['idle']:.1%}, "
        f"{prof['kernels']:.1f} kernels a trip (classic R=1, phase 4: "
        f"{p['busy']:.4f} ms/iter, idle {p['idle']:.1%}, "
        f"{p['per_trip']:.1f} kernels a trip)")
    # phase 4m serves jobs on this Solver
    serve["solver"] = solver
    del solver
    # the mg block's trip: the V-cycle's ops carry both columns, so its
    # kernels a trip are the width-1 iteration's (phase 4b's mg profile)
    mg_cells, _, mg_cols = MANY_SOLVES[-1]
    profile_inner(torch, solvers.pop((mg_cells, "mg")), iters=20,
                  tag=f"many profile {mg_cells}^3 mg R={len(mg_cols)}",
                  nrhs=len(mg_cols))
    solvers.clear()
    torch.cuda.empty_cache()

    # two blocks on the card, the same bits
    small = make_cube_model(*CARD_VS_CPU_CELLS, seed=4, **kw)
    F = np.asarray(small.F)
    runs = []
    for _ in range(2):
        s = Solver(small, RunConfig(solver=SolverConfig(
            tol=1e-9, precision_mode="mixed")))
        r = s.solve_many(np.stack([F, 2 * F] + shear_loads(np, small), -1))
        runs.append(((r.flags.tolist(), r.iters.tolist(),
                      r.relres.tolist()), r.x.clone()))
    same = runs[0][0] == runs[1][0] and torch.equal(runs[0][1], runs[1][1])
    say(f"many bits: two {'x'.join(map(str, CARD_VS_CPU_CELLS))} blocks "
        f"(flags, iterations) {runs[0][0][:2]}: "
        f"{'bitwise equal' if same else 'DIFFERENT'}")
    if not same or any(runs[0][0][0]):
        raise AssertionError("two blocked solves on the card differ or did "
                             "not converge")
    return launches_by, serve


# phase 4m: the solve service on 4d's flagship Solver.  Jobs in
# submission order (the admission ordinals 0-6; the last two are
# rejected and take none): four load scales packed into one width-4
# block, a NaN-poisoned job beside the F_y rhs job, a job failed by an
# injected exception, one whose deadline the cost model cannot meet and
# one spec with neither scale nor rhs.
SERVE_WIDTHS = (1, 2, 4)
SERVE_QUEUE_MAX = 8
SERVE_JOBS = (("s1", {"scale": 1.0}), ("s2", {"scale": 2.0}),
              ("s05", {"scale": 0.5}), ("sm1", {"scale": -1.0}),
              ("poison", {"scale": 1.0}), ("fy", {"rhs": "F_y.npy"}),
              ("boom", {"scale": 1.0}),
              ("rush", {"scale": 1.0, "deadline_s": 1e-3}),
              ("nospec", {"deadline_s": 60.0}))
SERVE_FAULTS = "nan@job:4,exc@job:6"
# the verdict each job must end with (a prefix for the named failures)
SERVE_VERDICTS = {"s1": "converged", "s2": "converged",
                  "s05": "converged", "sm1": "converged",
                  "poison": "rhs_nonfinite", "fy": "converged",
                  "boom": "injected:",
                  "rush": "rejected: deadline_infeasible",
                  "nospec": "rejected: bad_spec"}
# the kill drill: the JAX package's SIGKILL test's daemon on a 48x32x32
# cube, held inside its first block by a sleep at job ordinal 0
SERVE_DRILL_CELLS = (48, 32, 32)
SERVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_serve")


def _terminal_counts(journal_file):
    """{job: terminal journal records} over a whole journal."""
    from pcg_mpi_solver_tpu_torch.serve.journal import (
        TERMINAL_OPS, read_journal)

    counts = {}
    for ev in read_journal(journal_file)[0]:
        if ev.get("op") in TERMINAL_OPS and isinstance(ev.get("job"), str):
            counts[ev["job"]] = counts.get(ev["job"], 0) + 1
    return counts


def _serve_child(spool):
    """Start the kill drill's daemon: ``cli serve --synthetic 48,32,32
    --widths 1,2`` on the card, held inside its first block by
    ``sleep@job:0`` (600 s).  Returns (process, its log file)."""
    root = os.path.dirname(os.path.abspath(__file__))
    log = open(os.path.join(SERVE_DIR, "drill_child.log"), "w")
    env = dict(os.environ, PYTHONPATH=root, PCG_TPU_FAULTS="sleep@job:0",
               PCG_TPU_FAULT_SLEEP_S="600")
    proc = subprocess.Popen(
        [sys.executable, "-m", "pcg_mpi_solver_tpu_torch.cli", "serve",
         "--spool", spool, "--synthetic",
         ",".join(map(str, SERVE_DRILL_CELLS)), "--widths", "1,2",
         "--poll-s", "0.01"],
        cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def phase_serve(torch, np, inputs):
    """Phase 4m: the solve service (``serve/``) on phase 4d's flagship
    Solver (mixed, classic, jacobi, tol 1e-7, v6): ``ServeDaemon(widths=
    SERVE_WIDTHS, queue_max=SERVE_QUEUE_MAX)`` over a spool fed with
    ``SERVE_JOBS`` under ``SERVE_FAULTS``, driven through its own steps
    (``poll_once``, ``serve_block`` a block with the launch counts set to
    0 just before and read just after, ``run`` to drain).  Each block's
    width, lockstep trips, ms a trip, wall against the admission price
    (the cost model at the widest width x the JAX flagship's 3334
    iterations) and launches (v6 float32 >= trips, every other float32
    counter 0); each job's verdict (``SERVE_VERDICTS``), one result file
    and one terminal journal record each; x(2F) = 2 x(F) bit for bit;
    the scale-1 job against 4d's width-1 [F] block (equal iterations,
    max|du| <= 1e-12 max|u|, bitwise printed).  Then the kill drill: a
    ``cli serve`` child on the 48x32x32 cube (started first, so its
    start overlaps the flagship blocks) SIGKILLed once its journal shows
    the block packed, and a daemon started in this process over the same
    spool on a Solver that ran ``warmup()``: both jobs end exactly once,
    with their original ordinals.  Returns the flagship blocks' launch
    counts {(variant, dtype): n}."""
    import signal

    from pcg_mpi_solver_tpu_torch.serve import jobs as sjobs

    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    os.makedirs(SERVE_DIR)
    drill = os.path.join(SERVE_DIR, "drill")
    for t, (job, sc) in enumerate((("k0", 1.0), ("k1", 2.0))):
        sjobs.submit(drill, {"job": job, "scale": sc}, submit_t=float(t))
    child, log = _serve_child(drill)
    try:
        counts = _serve_flagship(torch, np, inputs)
        _serve_drill(torch, np, drill, child)
    finally:
        if child.poll() is None:
            child.send_signal(signal.SIGKILL)
            child.wait()
        log.close()
        shutil.rmtree(SERVE_DIR, ignore_errors=True)
    return counts


def _serve_flagship(torch, np, inputs):
    """Phase 4m's flagship daemon (see :func:`phase_serve`)."""
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.resilience import FaultPlan
    from pcg_mpi_solver_tpu_torch.serve import jobs as sjobs
    from pcg_mpi_solver_tpu_torch.serve.admission import price_admission
    from pcg_mpi_solver_tpu_torch.serve.daemon import ServeDaemon

    solver, model = inputs["solver"], inputs["model"]
    spool = os.path.join(SERVE_DIR, "flagship")
    sjobs.ensure_spool(spool)
    np.save(os.path.join(SERVE_DIR, "F_y.npy"), inputs["F_y"])
    for t, (job, spec) in enumerate(SERVE_JOBS):
        spec = dict(spec, job=job, submit_t=float(t))
        if "rhs" in spec:
            spec["rhs"] = os.path.join(SERVE_DIR, spec["rhs"])
        spec.setdefault("deadline_s", sjobs.DEFAULT_DEADLINE_S)
        # written as a client would, check_spec's rejections included
        sjobs.write_json_atomic(
            os.path.join(sjobs.incoming_dir(spool), f"{job}.json"), spec)
    d = ServeDaemon(solver, spool, queue_max=SERVE_QUEUE_MAX,
                    widths=SERVE_WIDTHS, expected_iters=JAX_FLAGSHIP_ITERS,
                    fault_plan=FaultPlan(SERVE_FAULTS,
                                         recorder=solver.recorder))
    price = price_admission(solver.predicted_ms_per_iter(max(SERVE_WIDTHS)),
                            JAX_FLAGSHIP_ITERS)
    admitted = d.poll_once()
    say(f"serve {FLAGSHIP['nx']}^3: {len(SERVE_JOBS)} jobs submitted, "
        f"{admitted} admitted; admission price {price:.3f} s a block (cost "
        f"model {solver.predicted_ms_per_iter(max(SERVE_WIDTHS)):.4f} "
        f"ms/iter at width {max(SERVE_WIDTHS)} x {JAX_FLAGSHIP_ITERS} "
        f"expected iterations); faults {SERVE_FAULTS}")
    seen = []
    solve_many = solver.solve_many

    def observed(fb, **kw):
        seen.append(solve_many(fb, **kw))
        return seen[-1]

    solver.solve_many = observed
    total = {}
    try:
        while d.admission.queue:
            blk, n_seen = d.blocks, len(seen)
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            taken = d.serve_block()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(LAUNCHES)
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
            f32, f64 = counts[("v6", "float32")], counts[("v6", "float64")]
            others = {k: v for k, v in counts.items() if v and k not in (
                ("v6", "float32"), ("v6", "float64"))}
            if len(seen) == n_seen:
                say(f"serve block {blk}: packed {taken}, dispatched 0 (every "
                    f"job failed at the service boundary), wall "
                    f"{wall:.3f} s; launches f32 {f32}, f64 {f64}")
                if f32 or f64 or others:
                    raise AssertionError(f"serve block {blk}: launches "
                                         f"without a dispatch: {counts}")
                continue
            res = seen[-1]
            ms_trip = res.solve_wall_s / max(res.trips, 1) * 1e3
            model_s = solver.predicted_ms_per_iter(res.nrhs) * res.trips / 1e3
            say(f"serve block {blk}: packed {taken}, width {res.nrhs}, "
                f"{res.trips} lockstep trips, {ms_trip:.4f} ms a trip, wall "
                f"{wall:.3f} s against the admission price {price:.3f} s "
                f"({wall / price:.2f}x; the cost model at width {res.nrhs} x "
                f"these trips {model_s:.3f} s, {wall / model_s:.2f}x); of "
                f"the wall: Krylov {res.solve_wall_s:.3f} s, the rest of "
                f"solve_many {res.wall_s - res.solve_wall_s:.3f} s, the "
                f"daemon's host work (load columns, fetch, .npy and result "
                f"files, journal) {wall - res.wall_s:.3f} s; launches v6 "
                f"f32 {f32}, f64 {f64}, other f32 {sum(others.values())}")
            if f32 < res.trips or others:
                raise AssertionError(f"serve block {blk}: not one v6 launch "
                                     f"a trip: {counts}, {res.trips} trips")
        reason = d.run(idle_exit_s=0.0, install_signals=False)
    finally:
        del solver.solve_many
    results = {job: sjobs.read_result(spool, job) for job, _ in SERVE_JOBS}
    for job, _spec in SERVE_JOBS:
        r = results[job] or {}
        extra = (f", flag {r['flag']}, iterations {r['iters']}, relres "
                 f"{r['relres']:.4e}, block {r['block']} of width "
                 f"{r['width']}, deadline met {r['deadline_met']}"
                 if "flag" in r else "")
        say(f"serve job {job}: verdict {r.get('verdict')!r}{extra}")
    counts = _terminal_counts(sjobs.journal_path(spool))
    say(f"serve {FLAGSHIP['nx']}^3: drained ({reason}), "
        f"{d.jobs_done} done, {d.jobs_failed} failed, {d.blocks} blocks; "
        f"terminal journal records a job {sorted(set(counts.values()))}")
    bad = [job for job, want in SERVE_VERDICTS.items()
           if not str((results[job] or {}).get("verdict")).startswith(want)]
    if bad or counts != {job: 1 for job, _ in SERVE_JOBS}:
        raise AssertionError(f"serve: verdicts of {bad} wrong, or not one "
                             f"terminal record a job: {counts}")
    u = {job: np.load(sjobs.solution_path(spool, job))
         for job in ("s1", "s2", "s05", "sm1", "fy")}
    exact = {name: bool(np.array_equal(u[job], k * u["s1"]))
             for name, job, k in (("2F", "s2", 2.0), ("0.5F", "s05", 0.5),
                                  ("-F", "sm1", -1.0))}
    say(f"serve {FLAGSHIP['nx']}^3: x(2F) = 2 x(F) bit for bit: "
        f"{exact['2F']}; x(0.5F) = 0.5 x(F): {exact['0.5F']}; x(-F) = "
        f"-x(F): {exact['-F']}")
    if not exact["2F"]:
        raise AssertionError("serve: x(2F) is not exactly 2 x(F)")
    u_ref, it_ref = inputs["u_F"], inputs["iters_F"]
    du = float(np.abs(u["s1"] - u_ref).max() / np.abs(u_ref).max())
    same = bool(np.array_equal(u["s1"], u_ref))
    it = results["s1"]["iters"]
    say(f"serve {FLAGSHIP['nx']}^3: the scale-1 job (width "
        f"{results['s1']['width']}) against 4d's width-1 [F]: iterations "
        f"{it} against {it_ref}, max|du| {du:.3e} of max|u| (tol 1e-12), "
        f"{'bitwise equal' if same else 'NOT bitwise equal'}")
    if it != it_ref or not du <= 1e-12:
        raise AssertionError("serve: the scale-1 job differs from its "
                             "width-1 solve")
    return total


def _serve_drill(torch, np, drill, child):
    """Phase 4m's kill drill (see :func:`phase_serve`)."""
    import signal

    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.resilience import FaultPlan
    from pcg_mpi_solver_tpu_torch.serve import jobs as sjobs
    from pcg_mpi_solver_tpu_torch.serve.daemon import ServeDaemon
    from pcg_mpi_solver_tpu_torch.serve.journal import (
        TERMINAL_OPS, read_journal)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    journal = sjobs.journal_path(drill)
    t0 = time.perf_counter()
    while not (os.path.exists(journal) and any(
            ev.get("op") == "packed" for ev in read_journal(journal)[0])):
        if child.poll() is not None or time.perf_counter() - t0 > 300:
            raise AssertionError(f"serve drill: the child ended "
                                 f"({child.returncode}) before packing")
        time.sleep(0.05)
    child.send_signal(signal.SIGKILL)
    child.wait(timeout=60)
    t_kill = time.perf_counter() - t0
    events = read_journal(journal)[0]
    if any(ev.get("op") in TERMINAL_OPS + ("drain",) for ev in events):
        raise AssertionError("serve drill: a job ended before the kill")
    cells = SERVE_DRILL_CELLS
    # the CLI's --synthetic cube and its default settings
    s = Solver(make_cube_model(*cells, E=30e9, nu=0.2, load="traction",
                               load_value=1e6, heterogeneous=True),
               RunConfig(solver=SolverConfig(tol=1e-7, max_iter=10000)))
    t1 = time.perf_counter()
    s.warmup()
    warm = time.perf_counter() - t1
    plan = FaultPlan("sleep@job:0")
    plan.sleep_s = 0.0      # replay fires it again (never dispatched)
    d = ServeDaemon(s, drill, widths=(1, 2), fault_plan=plan)
    ordinals = [e["ordinal"] for e in d.admission.queue]
    reason = d.run(idle_exit_s=0.0, install_signals=False)
    res = {j: sjobs.read_result(drill, j) for j in ("k0", "k1")}
    counts = _terminal_counts(journal)
    u0, u1 = (np.load(sjobs.solution_path(drill, j)) for j in ("k0", "k1"))
    say(f"serve drill {'x'.join(map(str, cells))}: child SIGKILLed "
        f"inside block 0 (packed, no terminal record; waited "
        f"{t_kill:.1f} s for it); restarted in-process: warmup "
        f"{warm:.3f} s, replayed ordinals {ordinals}, drained ({reason}); "
        f"verdicts {[res[j]['verdict'] for j in ('k0', 'k1')]}, iterations "
        f"{[res[j]['iters'] for j in ('k0', 'k1')]}; terminal records "
        f"{counts}; x(2F) = 2 x(F) bit for bit: "
        f"{bool(np.array_equal(u1, 2 * u0))}")
    if (ordinals != [0, 1] or counts != {"k0": 1, "k1": 1}
            or not all(r and r["ok"] for r in res.values())):
        raise AssertionError("serve drill: not exactly once")


def _matvec_kernels(torch, fn, reps: int = 5):
    """(device kernels, kernel launches) a call of ``fn`` makes: every
    CUDA-side event of a torch.profiler window over ``reps`` calls, and
    its cudaLaunchKernel calls, each divided by ``reps``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    evs = prof.key_averages()
    kernels = sum(ev.count for ev in evs
                  if ev.device_type == DeviceType.CUDA)
    launches = sum(ev.count for ev in evs if ev.key == "cudaLaunchKernel")
    return kernels / reps, launches / reps


def _general_solve(torch, np, solver, tag, bar):
    """One step of a general-backend mixed Solver with the structured
    kernels' launch counts set to 0 just before it; fails unless flag 0,
    relres <= 1e-7, the tip within [1/3, 3] of ``bar`` and no structured
    kernel launched.  Returns (result, ms/iter, inner cycles)."""
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)

    if solver.backend != "general":
        raise AssertionError(f"{tag}: Solver took the {solver.backend} "
                             f"backend")
    torch.cuda.synchronize()
    reset_launch_counts()
    with inner_cycles(solver) as cycles:
        res = solver.step(1.0)
    used = {f"{v} {d}": n for (v, d), n in LAUNCHES.items() if n}
    ms = res.wall_s / res.iters * 1e3
    u = solver.displacement_global()
    tip = float(u[0::3].max())
    say(f"{tag}: flag {res.flag}, iterations {res.iters}, relres "
        f"{res.relres:.4e}; time to tol {res.wall_s:.3f} s, {ms:.4f} "
        f"ms/iter, {solver.pm.glob_n_dof * res.iters / res.wall_s:.4e} "
        f"dof*iter/s; inner cycles (flag, iterations) {cycles}; tip ux "
        f"{tip:.4e} m vs bar estimate {bar:.4e} m (ratio {tip / bar:.3f}, "
        f"window [1/3, 3]); structured kernel launches {used or 0}; "
        f"{dispatches(solver)}")
    if res.flag != 0 or not res.relres <= 1e-7:
        raise AssertionError(f"{tag}: did not converge: {res}")
    if not np.isfinite(u).all() or not bar / 3 <= tip <= 3 * bar:
        raise AssertionError(f"{tag}: tip displacement outside the "
                             f"physics window")
    if used:
        raise AssertionError(f"{tag}: the general backend launched "
                             f"structured kernels: {used}")
    return res, ms, cycles


def _tree_to(tree, device):
    """A device tree moved to ``device`` (tensors; lists and dicts kept)."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _operator_checks(torch, np, pm, tag, trees=None, timed=False):
    """One seeded x through the card's float64 and float32 general
    matvec and the CPU's float64 one on the same partition (the card's
    float64 tree moved to the CPU): within ``OPERATOR_TOL`` x max|y_cpu|,
    two card matvecs bitwise equal.  ``trees``: the card's (float64,
    float32) trees of ``pm`` at the default grouping (built when None).
    With ``timed``, each dtype's CUDA-event ms a matvec."""
    from pcg_mpi_solver_tpu_torch.ops.matvec import Ops, device_data

    ops = Ops.from_model(pm)
    if trees is None:
        trees = (device_data(pm, torch.float64, "cuda"),
                 device_data(pm, torch.float32, "cuda"))
    x = np.where(pm.dof_gid >= 0, np.random.default_rng(7).standard_normal(
        pm.dof_gid.shape), 0.0)
    t0 = time.perf_counter()
    y_cpu = ops.matvec(_tree_to(trees[0], "cpu"), torch.as_tensor(x))
    cpu_s = time.perf_counter() - t0
    scale = float(y_cpu.abs().max())
    out = {}
    for (name, dtype), data in zip((("float64", torch.float64),
                                    ("float32", torch.float32)), trees):
        xc = torch.as_tensor(x, dtype=dtype, device="cuda")
        y1 = ops.matvec(data, xc)
        y2 = ops.matvec(data, xc)
        err = float((y1.cpu().double() - y_cpu).abs().max()) / scale
        same = bool(torch.equal(y1, y2))
        line = (f"{tag}: {name} matvec on the card vs the CPU's float64: "
                f"max err {err:.3e} x max|y| (tol {OPERATOR_TOL[name]:g}); "
                f"two card matvecs bitwise equal: {same}")
        if timed:
            ms = time_ms(torch, lambda: ops.matvec(data, xc))
            out[name] = ms
            line += f"; {ms:.4f} ms a matvec"
        say(line)
        if not err <= OPERATOR_TOL[name] or not same:
            raise AssertionError(f"{tag}: {name} general matvec on the "
                                 f"card failed its check")
        del xc, y1, y2
    say(f"{tag}: CPU float64 matvec {cpu_s:.2f} s")
    return out


def _bucket_stats(pm, bucket_values):
    """(buckets, sub-types, padded / real product FLOPs, padded / real
    element values, real GFLOP) of the stacked layout at
    ``bucket_values``; real = each element's own d^2 (d) once."""
    from pcg_mpi_solver_tpu_torch.ops.matvec import _layout

    lay = _layout(pm, bucket_values)
    n_el = [int(tb.n_elem.sum()) for tb in pm.type_blocks]
    real = sum(2 * n * tb.d * tb.d for n, tb in zip(n_el, pm.type_blocks))
    vals = sum(n * tb.d for n, tb in zip(n_el, pm.type_blocks))
    pad = sum(2 * T * M * d * d for T, M, _nr, d, _b in lay.shapes)
    pval = sum(T * M * d for T, M, _nr, d, _b in lay.shapes)
    return len(lay.shapes), len(lay.subs), pad / real, pval / vals, \
        real / 1e9


def phase_general(torch, np, cube_model, octrees):
    """Phase 4e: the general (pattern-type) backend on the card, run
    before phase 4 (no profiler window has run yet: one slows every solve
    after it, PERF.md).
    1. the 150^3 flagship cube through Solver(backend="general") (mixed,
       jacobi, classic): iterations within 5 % of the JAX package's 3334;
    2. the 22^3/L4 octree flagship (bench.py's octree model, auto backend
       -> general): build, partition and upload seconds, its bucket
       layout and its solve;
    3. its operator at full size on the card against the CPU, and at two
       parts on a small octree; the bucket groupings of
       ``BUCKET_VALUES_CHOICES`` timed on its float32 matvec;
    4. the 6^3 octree against the JAX package's count.
    Returns what :func:`phase_general_profile` reads after phase 4d: the
    cube's ms/iter and the octree's Solver."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.models.octree import make_octree_model
    from pcg_mpi_solver_tpu_torch.ops.matvec import (
        BUCKET_VALUES, Ops, device_data)
    from pcg_mpi_solver_tpu_torch.parallel.partition import partition_model
    from pcg_mpi_solver_tpu_torch.solver import Solver

    cfg = RunConfig(solver=SolverConfig(tol=1e-7, precision_mode="mixed"))
    smi = nvidia_smi_line()
    # 1. the flagship cube on the general operator
    nx = FLAGSHIP["nx"]
    sigma = FLAGSHIP["load_value"] * (nx + 1) ** 2 / nx ** 2
    solver = Solver(cube_model, cfg, backend="general")
    say(f"general cube {nx}^3: partition {solver.partition_build_s:.2f} s, "
        f"upload {solver.upload_s:.2f} s, setup {solver.setup_s:.2f} s; "
        f"{len(solver.ops.buckets)} bucket(s), {solver.ops.n_vrows} value "
        f"rows, ELL K {solver.ops.ell_k}")
    res, cube_ms, _c = _general_solve(torch, np, solver,
                                      f"general cube {nx}^3",
                                      sigma * nx / FLAGSHIP["E"])
    say(f"general cube {nx}^3: {res.iters} iterations (JAX package "
        f"{JAX_FLAGSHIP_ITERS}, window {ITERS_TOL:.0%}); {smi}")
    if abs(res.iters - JAX_FLAGSHIP_ITERS) > ITERS_TOL * JAX_FLAGSHIP_ITERS:
        raise AssertionError(f"general cube: {res.iters} iterations, not "
                             f"within {ITERS_TOL:.0%} of "
                             f"{JAX_FLAGSHIP_ITERS}")
    del solver
    torch.cuda.empty_cache()

    # 2. the octree flagship
    kw = dict(OCTREE_FLAGSHIP)
    n = kw.pop("n")
    model, build_s, wait_s = octrees.get(n)
    say(f"octree {n}^3/L{kw['max_level']}: {model.n_dof} dofs, "
        f"{model.n_elem} elements, {len(model.elem_lib)} pattern types; "
        f"model build {build_s:.2f} s (in a child process beside phases 3 "
        f"and 4e's cube; {wait_s:.2f} s waited here)")
    # the scratch partition cache (phase 4k builds these Solvers again,
    # warm); the mg Solver below finds this partition in it
    solver = Solver(model, dataclasses.replace(cfg, cache_dir=CACHE_DIR))
    pm = solver.pm
    nb, nsub, pad, pval, real = _bucket_stats(pm, BUCKET_VALUES)
    say(f"octree {n}^3: backend {solver.backend}; partition "
        f"{solver.partition_build_s:.2f} s, upload {solver.upload_s:.2f} s "
        f"(layout + device tree), setup {solver.setup_s:.2f} s; n_loc "
        f"{pm.n_loc}, ELL {pm.ell.shape}; {len(pm.type_blocks)} types, "
        f"{nsub} sign sub-types, in {nb} buckets at BUCKET_VALUES "
        f"{BUCKET_VALUES:g}: padded product {pad:.3f}x of {real:.3f} "
        f"GFLOP, element values {pval:.3f}x")
    say(f"octree {n}^3: partition cache {solver.setup_cache} "
        f"({CACHE_DIR})")
    bar = OCTREE_FLAGSHIP["load_value"] * n / OCTREE_FLAGSHIP["E"]
    res_j, ms_j, _c = _general_solve(torch, np, solver, f"octree {n}^3",
                                     bar)

    # 3. the operator at full size, and the bucket groupings
    _operator_checks(torch, np, pm, f"octree {n}^3 operator",
                     trees=(solver.data, solver.data32), timed=True)
    x = torch.as_tensor(np.where(pm.dof_gid >= 0, 1.0, 0.0),
                        dtype=torch.float32, device="cuda")
    for bv in BUCKET_VALUES_CHOICES:
        if bv == BUCKET_VALUES:
            ops, data = solver.ops32, solver.data32
        else:
            ops = Ops.from_model(pm, bucket_values=bv)
            data = device_data(pm, torch.float32, "cuda", bucket_values=bv)
        nb, _ns, pad, pval, _r = _bucket_stats(pm, bv)
        t_ms = time_ms(torch, lambda: ops.matvec(data, x))
        say(f"octree {n}^3 buckets: BUCKET_VALUES {bv:g}: {nb} buckets, "
            f"padded product {pad:.3f}x, element values {pval:.3f}x; "
            f"float32 matvec {t_ms:.4f} ms"
            + (" (the default)" if bv == BUCKET_VALUES else ""))
        del data
    torch.cuda.empty_cache()
    kw2 = dict(OCTREE_FLAGSHIP, **OCTREE_P2)
    n2 = kw2.pop("n")
    small = make_octree_model(n2, n2, n2, **kw2)
    _operator_checks(torch, np, partition_model(small, 2),
                     f"octree {n2}^3/L{kw2['max_level']} at 2 parts (rcb)")

    # 4. the 6^3 octree against the JAX package's count
    n6 = OCTREE_PARITY_N
    s6 = Solver(octrees.get(n6)[0], cfg)
    res6, _ms6, _cyc6 = _general_solve(
        torch, np, s6, f"octree {n6}^3",
        OCTREE_FLAGSHIP["load_value"] * n6 / OCTREE_FLAGSHIP["E"])
    win = max(3, ITERS_TOL * JAX_OCTREE6_ITERS)
    say(f"octree {n6}^3: {res6.iters} iterations against the JAX "
        f"package's {JAX_OCTREE6_ITERS} (window +-{win:g})")
    if abs(res6.iters - JAX_OCTREE6_ITERS) > win:
        raise AssertionError(f"octree {n6}^3: {res6.iters} iterations, "
                             f"outside max(3, 5 %) of {JAX_OCTREE6_ITERS}")
    del s6
    torch.cuda.empty_cache()

    # 5. mg on the 6^3 octree's lattice
    octree_mg, octree6_mg = phase_general_mg(torch, np, octrees)
    return dict(cube_ms=cube_ms, octree=solver, n=n, octree_mg=octree_mg,
                octree6_mg=octree6_mg, model=model, res=res_j, ms=ms_j)


def phase_general_mg(torch, np, octrees):
    """Phase 4e, its mg part: the 6^3 octree under precond="mg" (mixed,
    classic, auto backend -> general; the hierarchy from the octree
    lattice) within max(3, 5 %) of the JAX package's count.  Returns the
    mg Solver (profiled after phase 4d) and its cold setup (cache state,
    hierarchy, bounds, seconds, flag, iterations and u), which phase 4k
    loads warm."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.solver import Solver

    cfg = RunConfig(cache_dir=CACHE_DIR,
                    solver=SolverConfig(tol=1e-7, precision_mode="mixed",
                                        precond="mg"))
    n6 = OCTREE_PARITY_N
    s6 = Solver(octrees.get(n6)[0], cfg)
    res6, _ms6, _cyc6 = _general_solve(
        torch, np, s6, f"octree {n6}^3 mg",
        OCTREE_FLAGSHIP["load_value"] * n6 / OCTREE_FLAGSHIP["E"])
    win = max(3, ITERS_TOL * JAX_OCTREE6_MG_ITERS)
    say(f"octree {n6}^3 mg: {res6.iters} iterations against the JAX "
        f"package's {JAX_OCTREE6_MG_ITERS} (window +-{win:g}); levels "
        f"{[tuple(lev['ck'].shape) for lev in s6.mg_setup.tree['levels']]}; "
        f"hierarchy host {s6.mg_setup_s:.2f} s, fine bound "
        f"{s6.mg_lam_s:.2f} s")
    if abs(res6.iters - JAX_OCTREE6_MG_ITERS) > win:
        raise AssertionError(f"octree {n6}^3 mg: {res6.iters} iterations, "
                             f"outside max(3, 5 %) of "
                             f"{JAX_OCTREE6_MG_ITERS}")
    mg6 = dict(cfg=cfg, cache=s6.setup_cache, setup=s6.mg_setup,
               lam=s6.mg_lam, setup_s=s6.mg_setup_s, lam_s=s6.mg_lam_s,
               res=res6, u=s6.displacement_global())
    return s6, mg6


def phase_general_profile(torch, general, v6_ms_iter):
    """Phase 4e, after phase 4d (its profiler windows slow the solves
    after them): the general cube's ms/iter beside phase 4's v6, kernels
    and launches a float32 octree matvec, and 100 profiled inner
    iterations on the 22^3 octree."""
    solver, n, ms = general["octree"], general["n"], general["cube_ms"]
    say(f"general cube {FLAGSHIP['nx']}^3: {ms:.4f} ms/iter against phase "
        f"4's v6 {v6_ms_iter:.4f} ({ms / v6_ms_iter:.2f}x)")
    kern, launches = _matvec_kernels(torch, lambda: solver.ops32.matvec(
        solver.data32, solver.data32["F"]))
    say(f"octree {n}^3: {kern:.1f} device kernels and {launches:.1f} "
        f"kernel launches a float32 matvec (torch.profiler over 5); "
        f"{nvidia_smi_line()}")
    profile_inner(torch, solver, tag=f"general profile octree {n}^3")
    profile_inner(torch, general["octree_mg"], iters=20,
                  tag=f"general profile octree {OCTREE_PARITY_N}^3 mg")
    hy = general.get("hybrid")
    if hy is not None:
        kern, launches = _matvec_kernels(torch, lambda: hy.ops32.matvec(
            hy.data32, hy.data32["F"]))
        say(f"hybrid octree {n}^3: {kern:.1f} device kernels and "
            f"{launches:.1f} kernel launches a float32 matvec "
            f"(torch.profiler over 5); {nvidia_smi_line()}")
        profile_inner(torch, hy, tag=f"hybrid profile octree {n}^3")


def _level_batches(torch, np, solver, dtype, seed=11):
    """Each level's kernel inputs of a hybrid Solver at ``dtype``: (xg, ck)
    gathered from a seeded x through the Solver's own level gathers, as
    its matvec gives them to the kernel."""
    data = solver.data32 if dtype == torch.float32 else solver.data
    if data["levels"][0]["ck"].dtype != dtype:
        data = {"levels": [dict(lv, ck=lv["ck"].to(dtype))
                           for lv in data["levels"]]}
    pm = solver.pm
    x = torch.as_tensor(np.where(pm.dof_gid >= 0, np.random.default_rng(
        seed).standard_normal(pm.dof_gid.shape), 0.0), dtype=dtype,
        device="cuda")
    xf = torch.cat([x.reshape(1, -1), x.new_zeros((1, 3))], dim=1)
    out = []
    for lv, (nb, bx, by, bz) in zip(data["levels"], solver.ops.level_dims):
        xg = xf.index_select(1, lv["gx"]).view(
            pm.n_parts * nb, 3, bx + 1, by + 1, bz + 1)
        out.append((xg, lv["ck"]))
    return out


def _hybrid_kernel_checks(torch, np, solver, tag, rates, timed=False):
    """Every float32 variant and v6's float64 kernel against the plain
    version on ``solver``'s level batches (one launch a level; the
    tolerances of phase 3, x max|y| of the level), two launches bitwise
    equal.  With ``timed``, each kernel's CUDA-event ms for all levels
    (one pass: a launch a level, in turn), the plain version's, and the
    level batches' bound (bytes of each level's x, y and ck once).
    Returns {(variant, dtype): {"max_err_of_max_y", "ms", "plain_ms",
    "bound_ms", "bound_by"}}."""
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        structured_matvec, structured_matvec_plain)

    out = {}
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).removeprefix("torch.")
        tol = KERNEL_TOL[name]
        batches = _level_batches(torch, np, solver, dtype)
        K = solver.data["brick_Ke"].to(dtype)
        plains = [structured_matvec_plain(xg, ck, K) for xg, ck in batches]
        shapes = [tuple(ck.shape) for _xg, ck in batches]
        terms = {}
        for (xg, ck) in batches:
            _ms, _by, t = matvec_bound_ms(tuple(ck.shape),
                                          xg.element_size(), rates)
            for k, v in t.items():
                terms[k] = terms.get(k, 0.0) + v
        ops_ms = min(terms["cuda_cores"], terms["tensor_cores"])
        b = ((ops_ms, "operations") if ops_ms >= terms["bytes"]
             else (terms["bytes"], "bytes"))
        plain_ms = (time_ms(torch, lambda: [structured_matvec_plain(
            xg, ck, K) for xg, ck in batches], reps=5) if timed else None)
        for v in (F32_VARIANTS if dtype == torch.float32 else ("v6",)):
            def run(v=v):
                return [structured_matvec(xg, ck, K, variant=v)
                        for xg, ck in batches]
            ys, ys2 = run(), run()
            torch.cuda.synchronize()
            err = max((y - yp).abs().max().item()
                      / max(yp.abs().max().item(), 1e-300)
                      for y, yp in zip(ys, plains))
            same = all(torch.equal(a, c) for a, c in zip(ys, ys2))
            ms = time_ms(torch, run, reps=10) if timed else None
            out[(v, name)] = dict(max_err_of_max_y=err, ms=ms,
                                  plain_ms=plain_ms, bound_ms=b[0],
                                  bound_by=b[1])
            say(f"{tag} levels {shapes} {name} {v}: max err {err:.3e} x "
                f"max|y| (tol {tol:g}), repeat bitwise "
                f"{'equal' if same else 'DIFFERENT'}"
                + (f"; {ms:.4f} ms for the levels (plain {plain_ms:.4f}; "
                   f"bound {b[0] * 1e3:.4g} us, {b[1]}: bytes "
                   f"{terms['bytes'] * 1e3:.4g} us; {b[0] / ms:.2%} of "
                   f"it)" if timed else ""))
            if not err <= tol or not same:
                raise AssertionError(f"{tag}: {v} {name} on the level "
                                     f"batches disagrees with its plain "
                                     f"version or with itself")
            del ys, ys2
        del batches, plains
    torch.cuda.empty_cache()
    return out


def _hybrid_solve(torch, np, solver, tag, bar):
    """One step of a hybrid mixed Solver with the kernel counts set to 0
    just before it; fails unless flag 0, relres <= 1e-7, the tip within
    [1/3, 3] of ``bar`` and the selected float32 kernel launched at least
    levels x iterations times.  Returns (result, ms/iter, inner cycles,
    launch counts)."""
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)

    if solver.backend != "hybrid":
        raise AssertionError(f"{tag}: Solver took the {solver.backend} "
                             f"backend")
    torch.cuda.synchronize()
    reset_launch_counts()
    with inner_cycles(solver) as cycles:
        res = solver.step(1.0)
    counts = dict(LAUNCHES)
    used = {f"{v} {d}": n for (v, d), n in counts.items() if n}
    ms = res.wall_s / res.iters * 1e3
    u = solver.displacement_global()
    tip = float(u[0::3].max())
    n_lv = len(solver.ops.level_dims)
    f32 = counts[(solver.kernel_variant, "float32")]
    say(f"{tag}: flag {res.flag}, iterations {res.iters}, relres "
        f"{res.relres:.4e}; time to tol {res.wall_s:.3f} s, {ms:.4f} "
        f"ms/iter, {solver.pm.glob_n_dof * res.iters / res.wall_s:.4e} "
        f"dof*iter/s; inner cycles (flag, iterations) {cycles}; tip ux "
        f"{tip:.4e} m vs bar estimate {bar:.4e} m (ratio {tip / bar:.3f}); "
        f"kernel launches {used} ({solver.kernel_variant} float32 "
        f"{f32} >= {n_lv} levels x {res.iters} iterations); "
        f"{dispatches(solver)}")
    if res.flag != 0 or not res.relres <= 1e-7:
        raise AssertionError(f"{tag}: did not converge: {res}")
    if not np.isfinite(u).all() or not bar / 3 <= tip <= 3 * bar:
        raise AssertionError(f"{tag}: tip displacement outside the "
                             f"physics window")
    if f32 < n_lv * res.iters:
        raise AssertionError(f"{tag}: {f32} float32 launches, fewer than "
                             f"{n_lv} levels x {res.iters} iterations")
    return res, ms, cycles, counts


def phase_hybrid(torch, np, general, rates, octrees):
    """Phase 4h: the hybrid level-grid backend on 4e's 22^3/L4 octree
    model (mixed, jacobi, classic, tol 1e-7, one part), before any
    profiler window:
    1. Solver(model, cfg, backend="hybrid"): the seconds of
       partition_hybrid, of the refresh's general partition and of the
       upload; the level table (size, nb, dims, bricks, grid cells), the
       transition cells and the combine maps; flag, relres, iterations,
       inner cycles, dispatches, time to tol and ms/iter beside 4e's
       general solve, the solution within 1e-6 of max|u| of 4e's; the
       selected float32 kernel's launches >= levels x iterations;
    2. the operator: float32 and float64 on the card against the CPU's
       float64 (2e-5 and 1e-12 of max|y|), two card matvecs bitwise equal,
       the float32 matvec's time; the bucketed refresh's two matvecs
       bitwise equal;
    3. every kernel against its plain version on the flagship's level
       batches, timed (v6 and v1 among them) beside the batches' bound;
    4. the 6^3 octree (levels of 1^3, 12^3 and 22x24x24 cells beside the
       tiled 8^3 ones) within max(3, 5 %) of the JAX package's 1145
       iterations, every kernel on its level batches.
    Returns the flagship's Solver, its launch counts and the level
    kernel records."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.solver import Solver

    cfg = RunConfig(solver=SolverConfig(tol=1e-7, precision_mode="mixed"))
    model, n = general["model"], general["n"]
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    s = Solver(model, cfg, backend="hybrid")
    build = time.perf_counter() - t0
    hp = s.pm
    say(f"hybrid octree {n}^3: partition_hybrid "
        f"{s.partition_build_s - s.refresh_partition_s:.2f} s")
    say(f"hybrid octree {n}^3: refresh partition ({s.f64_refresh}) "
        f"{s.refresh_partition_s:.2f} s")
    say(f"hybrid octree {n}^3: upload {s.upload_s:.2f} s (Solver "
        f"{build:.2f} s in all); device memory "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    grid = 0
    for lv in hp.levels:
        cells = hp.n_parts * lv.nb * lv.bx * lv.by * lv.bz
        grid += cells
        say(f"hybrid octree {n}^3 level: size {lv.size}, nb {lv.nb}, dims "
            f"({lv.bx}, {lv.by}, {lv.bz}), bricks {int(lv.n_cells.sum())}, "
            f"grid cells {cells}")
    bricks = sum(int(lv.n_cells.sum()) for lv in hp.levels)
    trans = sum(int(tb.n_elem.sum()) for tb in hp.pm.type_blocks)
    cm = hp.combine
    say(f"hybrid octree {n}^3: {bricks} bricks in {grid} grid cells "
        f"({bricks / grid:.1%}); {trans} transition cells over "
        f"{len(hp.pm.type_blocks)} types on the general operator "
        f"({len(s.ops.buckets)} buckets); combine {s.ops.combine}: "
        f"{hp.n_parts * cm.n_slots} slots, KD {cm.gidx.shape[-1]}, "
        f"{int((cm.hnode < hp.n_node_loc).sum())} heavy nodes, KE "
        f"{cm.hgidx.shape[-1]}")
    bar = OCTREE_FLAGSHIP["load_value"] * n / OCTREE_FLAGSHIP["E"]
    res, ms, _cyc, counts = _hybrid_solve(torch, np, s,
                                          f"hybrid octree {n}^3", bar)
    res_g, ms_g = general["res"], general["ms"]
    uh = s.displacement_global()
    ug = general["octree"].displacement_global()
    du = float(np.abs(uh - ug).max() / np.abs(ug).max())
    say(f"hybrid octree {n}^3 against 4e's general: {res.iters} against "
        f"{res_g.iters} iterations, {ms:.4f} against {ms_g:.4f} ms/iter, "
        f"time to tol {res.wall_s:.3f} against {res_g.wall_s:.3f} s; "
        f"solutions differ by {du:.3e} of max|u| (tol 1e-6); {smi}")
    if not du <= 1e-6:
        raise AssertionError(f"hybrid octree: solution differs from the "
                             f"general backend's by {du:.3e} of max|u|")

    # 2. the operator
    pm = hp.pm
    x = np.where(pm.dof_gid >= 0, np.random.default_rng(7).standard_normal(
        pm.dof_gid.shape), 0.0)
    t1 = time.perf_counter()
    y_cpu = s.ops.matvec(_tree_to(s.data, "cpu"), torch.as_tensor(x))
    cpu_s = time.perf_counter() - t1
    scale = float(y_cpu.abs().max())
    for name, ops, data in (("float64", s.ops, s.data),
                            ("float32", s.ops32, s.data32)):
        xc = torch.as_tensor(x, dtype=data["F"].dtype, device="cuda")
        y1, y2 = ops.matvec(data, xc), ops.matvec(data, xc)
        err = float((y1.cpu().double() - y_cpu).abs().max()) / scale
        same = bool(torch.equal(y1, y2))
        t_ms = time_ms(torch, lambda: ops.matvec(data, xc))
        say(f"hybrid octree {n}^3 operator: {name} matvec on the card vs "
            f"the CPU's float64: max err {err:.3e} x max|y| (tol "
            f"{OPERATOR_TOL[name]:g}); two card matvecs bitwise equal: "
            f"{same}; {t_ms:.4f} ms a matvec")
        if not err <= OPERATOR_TOL[name] or not same:
            raise AssertionError(f"hybrid octree: {name} matvec on the card "
                                 f"failed its check")
        del xc, y1, y2
    if s._refresh64 is not None:
        xc = torch.as_tensor(x, dtype=torch.float64, device="cuda")
        r1, r2 = s._k64(xc), s._k64(xc)
        err = float((r1.cpu() - y_cpu).abs().max()) / scale
        same = bool(torch.equal(r1, r2))
        t_ms = time_ms(torch, lambda: s._k64(xc), reps=5)
        say(f"hybrid octree {n}^3 refresh ({s.f64_refresh}): max err "
            f"{err:.3e} x max|y| (tol 1e-12); two card matvecs bitwise "
            f"equal: {same}; {t_ms:.4f} ms a matvec")
        if not err <= 1e-12 or not same:
            raise AssertionError("hybrid octree: the refresh matvec failed "
                                 "its check")
        del xc, r1, r2
    say(f"hybrid octree {n}^3 operator: CPU float64 matvec {cpu_s:.2f} s")
    del y_cpu
    torch.cuda.empty_cache()

    # 3. every kernel on the flagship's level batches
    levels = _hybrid_kernel_checks(torch, np, s, f"hybrid octree {n}^3",
                                   rates, timed=True)
    v6, v1 = levels[("v6", "float32")], levels[("v1", "float32")]
    say(f"hybrid octree {n}^3 level passes: v6 {v6['ms']:.4f} ms, v1 "
        f"{v1['ms']:.4f} ms against the bound {v6['bound_ms'] * 1e3:.4g} "
        f"us ({v6['bound_by']}); {smi}")

    # 4. the 6^3 octree
    n6 = OCTREE_PARITY_N
    s6 = Solver(octrees.get(n6)[0], cfg, backend="hybrid")
    say(f"hybrid octree {n6}^3 levels: "
        f"{[(lv.size, lv.nb, (lv.bx, lv.by, lv.bz)) for lv in s6.pm.levels]}")
    _hybrid_kernel_checks(torch, np, s6, f"hybrid octree {n6}^3", rates)
    res6, _ms6, _c6, _n6 = _hybrid_solve(
        torch, np, s6, f"hybrid octree {n6}^3",
        OCTREE_FLAGSHIP["load_value"] * n6 / OCTREE_FLAGSHIP["E"])
    win = max(3, ITERS_TOL * JAX_OCTREE6_HYBRID_ITERS)
    say(f"hybrid octree {n6}^3: {res6.iters} iterations against the JAX "
        f"package's {JAX_OCTREE6_HYBRID_ITERS} (window +-{win:g})")
    if abs(res6.iters - JAX_OCTREE6_HYBRID_ITERS) > win:
        raise AssertionError(f"hybrid octree {n6}^3: {res6.iters} "
                             f"iterations, outside max(3, 5 %) of "
                             f"{JAX_OCTREE6_HYBRID_ITERS}")
    del s6
    torch.cuda.empty_cache()
    return dict(solver=s, launches=counts, levels=levels)


def _time_launches(torch, run):
    """``run()`` with the slab kernels' launch counts set to 0 just before
    it and read just after: (its result, the counts)."""
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)

    torch.cuda.synchronize()
    reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    return out, dict(LAUNCHES)


def _newmark_steps(torch, np, solver, tag, tol):
    """``TIME_NEWMARK_DELTAS`` through ``NewmarkSolver.run`` with the
    launch counts read around it: every step's flag, iterations, relres,
    ms/iter and seconds printed; fails unless flag 0 and relres <= tol at
    every step.  Returns (results, launch counts)."""
    res, counts = _time_launches(
        torch, lambda: solver.run(TIME_NEWMARK_DELTAS))
    for t, r in enumerate(res, 1):
        say(f"{tag} step {t}: flag {r.flag}, iterations {r.iters}, relres "
            f"{r.relres:.4e}, {r.wall_s:.3f} s, "
            f"{r.wall_s / max(r.iters, 1) * 1e3:.4f} ms/iter")
        if r.flag != 0 or not r.relres <= tol:
            raise AssertionError(f"{tag} step {t}: did not converge: {r}")
    used = {f"{v} {d}": n for (v, d), n in counts.items() if n}
    say(f"{tag}: partition {solver.partition_build_s:.2f} s, upload "
        f"{solver.upload_s:.2f} s; {dispatches(solver)} (last step); "
        f"kernel launches {used or 0}")
    return res, counts


def _explicit_run(torch, np, solver, tag, n_steps, export_every):
    """``DynamicsSolver.run`` with the launch counts read around it and
    torch's CUDA sync debug mode reporting every synchronising call (each
    host read) with its Python stack: seconds a step, chunks and reads
    printed; fails unless the state and probes are finite, the frames are
    the schedule's and exactly one read happens inside each chunk
    (``DynamicsSolver._chunk``; the frames and the final fetch come
    between chunks).  Returns (result, launch counts, seconds)."""
    import collections
    import traceback
    import warnings

    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)

    syncs = []

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" in str(message):
            syncs.append(traceback.extract_stack()[:-1])

    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            res = solver.run(n_steps, export_every=export_every)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(LAUNCHES)

    def site(stack):
        # the innermost frame of the port (or of this script)
        for fr in reversed(stack):
            if "pcg_mpi_solver_tpu_torch" in fr.filename \
                    or fr.filename.endswith("chip_smoke.py"):
                return (f"{os.path.basename(fr.filename)}:{fr.lineno} "
                        f"{fr.name}")
        return f"{os.path.basename(stack[-1].filename)}:{stack[-1].lineno}"

    where = collections.Counter(site(st) for st in syncs)
    reads = sum(any(fr.name == "_chunk" and fr.filename.endswith(
        "dynamics.py") for fr in st) for st in syncs)
    frames = n_steps // export_every
    used = {f"{v} {d}": n for (v, d), n in counts.items() if n}
    say(f"{tag}: {n_steps} steps in {wall:.3f} s, "
        f"{wall / n_steps * 1e3:.4f} ms a step; {solver.chunks} chunks, "
        f"{reads} host reads in them ({reads / max(solver.chunks, 1):g} a "
        f"chunk); synchronising calls by site {dict(where)}; partition "
        f"{solver.partition_build_s:.2f} s, upload {solver.upload_s:.2f} s; "
        f"kernel launches {used or 0}")
    if not (np.isfinite(res.u).all() and np.isfinite(res.probe_u).all()):
        raise AssertionError(f"{tag}: non-finite state")
    if len(res.frames) != frames:
        raise AssertionError(f"{tag}: {len(res.frames)} frames, not "
                             f"{frames}")
    if reads != solver.chunks:
        raise AssertionError(f"{tag}: {reads} host reads over "
                             f"{solver.chunks} chunks, not one a chunk")
    return res, counts, wall


def _newmark_pair(torch, np, model, n, cfg, tol, add_to):
    """Newmark on ``model`` (the n^3 octree) on the general backend and on
    backend="hybrid", both at ``TIME_NEWMARK_DT_FACTOR`` x stable_dt: the
    hybrid's iterations a step within max(3, 5 %) of the general's, its u
    within 1e-6 of max|u|, its selected float32 kernel launched at least
    levels x inner iterations times and v6's float64 kernel at least
    once.  Launch counts are added into ``add_to``."""
    import warnings

    from pcg_mpi_solver_tpu_torch.solver import NewmarkSolver, stable_dt

    dt = TIME_NEWMARK_DT_FACTOR * stable_dt(model)
    runs = {}
    for backend in ("general", "hybrid"):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the auto gate's note
            s = NewmarkSolver(model, cfg, dt=dt, backend=backend)
        tag = f"time octree {n}^3 newmark {s.backend}"
        res, counts = _newmark_steps(torch, np, s, tag, tol)
        add_to(counts)
        calls = [k for k, _n, _f in s.dispatch_log if k != "refine"]
        if cfg.solver.iters_per_dispatch > 0 and len(calls) < 2:
            raise AssertionError(f"{tag}: the last step ran "
                                 f"{len(calls)} capped dispatch(es)")
        runs[s.backend] = (res, s.displacement_global())
        if backend == "hybrid":
            n_lv = len(s.ops.level_dims)
            f32 = counts[(s.kernel_variant, "float32")]
            f64 = counts[("v6", "float64")]
            inner = sum(r.iters for r in res)
            say(f"{tag}: {s.kernel_variant} float32 launches {f32} >= "
                f"{n_lv} levels x {inner} inner iterations; v6 float64 "
                f"launches {f64} (the refresh on the level grids, "
                f"f64_refresh {s.f64_refresh})")
            if f32 < n_lv * inner or f64 <= 0:
                raise AssertionError(f"{tag}: launches {f32} float32, "
                                     f"{f64} float64")
        del s
        torch.cuda.empty_cache()
    (res_g, u_g), (res_h, u_h) = runs["general"], runs["hybrid"]
    du = float(np.abs(u_h - u_g).max() / np.abs(u_g).max())
    its_g, its_h = [r.iters for r in res_g], [r.iters for r in res_h]
    say(f"time octree {n}^3 newmark hybrid against general: iterations "
        f"{its_h} against {its_g}, seconds "
        f"{[round(r.wall_s, 3) for r in res_h]} against "
        f"{[round(r.wall_s, 3) for r in res_g]}; u differs by {du:.3e} of "
        f"max|u| (tol 1e-6)")
    if any(abs(a - b) > max(3, ITERS_TOL * b) for a, b in zip(its_h, its_g)):
        raise AssertionError("time newmark: hybrid iterations outside "
                             "max(3, 5 %) of the general backend's")
    if not du <= 1e-6:
        raise AssertionError(f"time newmark: hybrid u differs by {du:.3e}")


def _explicit_probes(np, model):
    """Two probe dofs: the largest load and the middle effective dof."""
    return (int(np.argmax(np.abs(model.F))),
            int(model.dof_eff[len(model.dof_eff) // 2]))


def phase_time(torch, np, octrees):
    """Phase 4j: the time integrators, right after phase 4h, before any
    profiler window, on the 6^3 octree (cut from 22^3 to make room for
    phases 4m and 4n; 4h and 4e measure the 22^3 hybrid and general
    paths):
    1. Newmark (mixed, jacobi, classic, tol 1e-7, dt = 50 x stable_dt,
       steps ``TIME_NEWMARK_DELTAS``, chunked at ``TIME_NEWMARK_CAP``)
       on the general backend and on backend="hybrid"
       (:func:`_newmark_pair`); flag 0 and relres <= tol every step;
    2. explicit dynamics (dt = stable_dt, ``TIME_EXPLICIT_STEPS`` steps,
       damping 0.1, two probes, a frame every ``TIME_EXPLICIT_EXPORT``,
       one host read a chunk): on the 6^3 octree float64 general and
       hybrid (within
       1e-9 of max|u|; v6's double kernel exactly levels x steps times)
       and float32 hybrid (its selected kernel exactly levels x steps
       times; its probes against the float64 general ones printed).
    Returns the launch counts {(variant, dtype): n} of the Newmark runs
    and of the explicit runs."""
    import warnings

    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.solver import (
        DynamicsSolver, stable_dt)

    tol = 1e-7
    cfg = RunConfig(solver=SolverConfig(
        tol=tol, precision_mode="mixed",
        iters_per_dispatch=TIME_NEWMARK_CAP))
    newmark, explicit = {}, {}

    def adder(into):
        def add(counts):
            for k, v in counts.items():
                into[k] = into.get(k, 0) + v
        return add

    # 1. Newmark: the 6^3 octree's hybrid against its general, chunked
    n6 = OCTREE_PARITY_N
    m6 = octrees.get(n6)[0]
    say(f"time octree {n6}^3: {m6.n_dof} dofs, stable_dt "
        f"{stable_dt(m6):.4e} s; Newmark dt = {TIME_NEWMARK_DT_FACTOR:g} x "
        f"stable_dt, chunk cap {TIME_NEWMARK_CAP}; {nvidia_smi_line()}")
    _newmark_pair(torch, np, m6, n6, cfg, tol, adder(newmark))

    # 2. explicit dynamics: the 6^3 octree's float64 general and hybrid
    # and float32 hybrid (the 22^3 general float64 run, and its 22.6 s
    # partition, went to make room for phase 4n)
    out = {}
    for mdl, k, backend, dtype in ((m6, n6, "general", "float64"),
                                   (m6, n6, "hybrid", "float64"),
                                   (m6, n6, "hybrid", "float32")):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            s = DynamicsSolver(mdl, RunConfig(solver=SolverConfig(
                dtype=dtype)), dt=stable_dt(mdl), damping=0.1,
                probe_dofs=_explicit_probes(np, mdl), backend=backend)
        tag = f"time octree {k}^3 explicit {s.backend} {dtype}"
        res, counts, _w = _explicit_run(torch, np, s, tag,
                                        TIME_EXPLICIT_STEPS,
                                        TIME_EXPLICIT_EXPORT)
        adder(explicit)(counts)
        if s.backend == "hybrid":
            n_lv = len(s.ops.level_dims)
            got = counts[(s.kernel_variant if dtype == "float32" else "v6",
                          dtype)]
            say(f"{tag}: {got} launches == {n_lv} levels x "
                f"{TIME_EXPLICIT_STEPS} steps")
            if got != n_lv * TIME_EXPLICIT_STEPS:
                raise AssertionError(f"{tag}: {got} launches, not "
                                     f"{n_lv * TIME_EXPLICIT_STEPS}")
        out[(k, s.backend, dtype)] = res
        del s
        torch.cuda.empty_cache()
    g64 = out[(n6, "general", "float64")]
    h64 = out[(n6, "hybrid", "float64")]
    d6 = float(np.abs(h64.u - g64.u).max() / np.abs(g64.u).max())
    p64, p32 = g64.probe_u, out[(n6, "hybrid", "float32")].probe_u
    dp = float(np.abs(p32 - p64).max() / np.abs(p64).max())
    say(f"time octree {n6}^3 explicit: float64 hybrid against general over "
        f"{TIME_EXPLICIT_STEPS} steps: {d6:.3e} of max|u| (tol 1e-9); "
        f"float32 hybrid probes against float64 general: max difference "
        f"{dp:.3e} of max|probe| ({np.abs(p64).max():.4e} m)")
    if not d6 <= 1e-9:
        raise AssertionError(f"time octree {n6}^3: hybrid differs by "
                             f"{d6:.3e}")
    return newmark, explicit


def _edge_cuts(np, model, maps):
    """The dual graph's edge cut under each element map of ``maps``
    ({name: (n_elem,) part map}): elements are adjacent when they share a
    node (``part_mesh_dual``'s graph at ncommon = 1), an edge counted
    once.  Vectorised: the elements of each node sorted together, pairs at
    every offset within a node's run; only the pairs a map cuts are
    deduplicated."""
    eptr = np.asarray(model.elem_nodes_offset, dtype=np.int64)
    eind = np.asarray(model.elem_nodes_flat, dtype=np.int64)
    src = np.repeat(np.arange(model.n_elem, dtype=np.int64), np.diff(eptr))
    order = np.argsort(eind, kind="stable")
    nodes, elems = eind[order], src[order]
    cut = {name: [] for name in maps}
    d = 1
    while True:
        same = nodes[:-d] == nodes[d:]
        if not same.any():
            break
        a, b = elems[:-d][same], elems[d:][same]
        for name, m in maps.items():
            x = m[a] != m[b]
            cut[name].append(np.minimum(a[x], b[x]) * model.n_elem
                             + np.maximum(a[x], b[x]))
        d += 1
    return {name: len(np.unique(np.concatenate(keys)))
            for name, keys in cut.items()}


def _interface_dofs(np, model, part, n_parts):
    """Dofs that live in two or more parts under the element map
    ``part``."""
    dofs = np.asarray(model.elem_dofs_flat, dtype=np.int64)
    owner = np.repeat(part, np.diff(np.asarray(model.elem_dofs_offset)))
    count = np.zeros(model.n_dof, dtype=np.int8)
    for p in range(n_parts):
        seen = np.zeros(model.n_dof, dtype=bool)
        seen[dofs[owner == p]] = True
        count += seen
    return int((count >= 2).sum())


def _same_arrays(np, a, b, where):
    """Fail unless two partitions (dataclasses, dicts, lists of numpy
    arrays and scalars) are equal, array for array."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _same_arrays(np, getattr(a, f.name), getattr(b, f.name),
                         f"{where}.{f.name}")
    elif isinstance(a, dict):
        if a.keys() != b.keys():
            raise AssertionError(f"{where}: keys differ")
        for k in a:
            _same_arrays(np, a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{where}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            _same_arrays(np, x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        if a.dtype != b.dtype or not np.array_equal(a, b):
            raise AssertionError(f"{where}: arrays differ")
    elif a != b:
        raise AssertionError(f"{where}: {a!r} != {b!r}")


def phase_graph_cache(torch, np, general, octrees):
    """Phase 4k, the native graph partitioner and the partition cache, on
    4e's 22^3/L4 octree model object:
    1. a general mixed Solver (jacobi, classic, tol 1e-7) at
       ``GRAPH_PARTS`` parts under partition_method="graph", cold into
       ``CACHE_DIR``: the seconds of ``part_mesh_dual`` and of the whole
       partition (beside the one-part RCB's, recorded and 4e's), the part sizes
       (none empty, within the JAX package's 10 % balance), the dual
       graph's edge cut and the interface dofs beside RCB's at the same
       parts, the sha256 of the element map; its solve within max(3, 5 %)
       of 4e's one-part iterations;
    2. the same Solver again, warm: ``setup_cache`` cold then warm, the
       partition equal array for array, the load seconds, the solve's
       flag, iterations and u bitwise the cold one's;
    3. the 6^3 octree on the hybrid backend at ``GRAPH_PARTS`` parts under
       "graph": flag, iterations beside the one-part hybrid's, v6 launched
       at least levels x iterations times;
    4. 4e's 6^3 mg Solver built again, warm from the entry 4e stored:
       ``setup_cache`` cold then warm, the hierarchy and the bounds equal
       array for array, their seconds cold and warm, the solve's flag,
       iterations and u bitwise the cold one's.  (The 22^3 mg Solver
       warm, 13.2 s, went to make room for phase 4n.)
    Returns the slab kernels' launch counts over step 3 (the only step
    that launches them)."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig, native
    from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
    from pcg_mpi_solver_tpu_torch.parallel.partition import rcb_partition
    from pcg_mpi_solver_tpu_torch.solver import Solver

    model, n, P = general["model"], general["n"], GRAPH_PARTS
    one = general["octree"]
    smi = nvidia_smi_line()
    cfg = RunConfig(partition_method="graph", cache_dir=CACHE_DIR,
                    solver=SolverConfig(tol=1e-7, precision_mode="mixed"))
    # 1. cold: part_mesh_dual timed inside the Solver's own partition
    t0 = time.perf_counter()
    native.load()
    say(f"graph: native library {native.library_path().name} loaded (built "
        f"with g++ if new) in {time.perf_counter() - t0:.2f} s")
    pmd_s = []
    part_mesh_dual = native.part_mesh_dual

    def timed_pmd(*a, **k):
        t = time.perf_counter()
        out = part_mesh_dual(*a, **k)
        pmd_s.append(time.perf_counter() - t)
        return out

    native.part_mesh_dual = timed_pmd
    try:
        t0 = time.perf_counter()
        ev_c = _Events()
        cold = Solver(model, cfg, n_parts=P,
                      recorder=MetricsRecorder(sinks=[ev_c]))
        cold_s = time.perf_counter() - t0
    finally:
        native.part_mesh_dual = part_mesh_dual
    ep = np.asarray(cold.pm.elem_part)
    counts = np.bincount(ep, minlength=P)
    digest = hashlib.sha256(np.ascontiguousarray(ep).tobytes()).hexdigest()
    say(f"graph octree {n}^3 at {P} parts: part_mesh_dual {pmd_s[0]:.2f} s, "
        f"partition_model {cold.partition_build_s:.2f} s (one-part RCB "
        f"{ONE_PART_RCB_PARTITION_S} s recorded, {one.partition_build_s:.2f} "
        f"s in 4e), "
        f"upload {cold.upload_s:.2f} s, cold Solver (build + store) "
        f"{cold_s:.2f} s; part sizes {counts.tolist()} (ideal "
        f"{model.n_elem / P:.1f}); element map sha256 {digest}")
    if len(pmd_s) != 1 or counts.min() == 0 \
            or counts.max() > 1.10 * model.n_elem / P:
        raise AssertionError(f"graph octree: part_mesh_dual ran "
                             f"{len(pmd_s)} times, part sizes "
                             f"{counts.tolist()}")
    t0 = time.perf_counter()
    maps = {"graph": ep, "rcb": rcb_partition(model.sctrs, P)}
    cut = _edge_cuts(np, model, maps)
    iface = {k: _interface_dofs(np, model, m, P) for k, m in maps.items()}
    say(f"graph octree {n}^3 at {P} parts: dual graph edge cut graph "
        f"{cut['graph']}, rcb {cut['rcb']} "
        f"({cut['graph'] / cut['rcb']:.3f}x); interface dofs graph "
        f"{iface['graph']}, rcb {iface['rcb']} "
        f"({iface['graph'] / iface['rcb']:.3f}x); counted in "
        f"{time.perf_counter() - t0:.2f} s")
    bar = OCTREE_FLAGSHIP["load_value"] * n / OCTREE_FLAGSHIP["E"]
    res_c, ms_c, cyc_c = _general_solve(torch, np, cold,
                                        f"graph octree {n}^3 at {P} parts",
                                        bar)
    res1 = general["res"]
    win = max(3, ITERS_TOL * res1.iters)
    say(f"graph octree {n}^3 at {P} parts: {res_c.iters} iterations against "
        f"the one-part solve's {res1.iters} (window +-{win:g}); {ms_c:.4f} "
        f"against {general['ms']:.4f} ms/iter; {smi}")
    if abs(res_c.iters - res1.iters) > win:
        raise AssertionError(f"graph octree: {res_c.iters} iterations, "
                             f"outside max(3, 5 %) of {res1.iters}")
    u_c = cold.displacement_global()

    # 2. warm
    t0 = time.perf_counter()
    ev_w = _Events()
    warm = Solver(model, cfg, n_parts=P,
                  recorder=MetricsRecorder(sinks=[ev_w]))
    warm_s = time.perf_counter() - t0
    say(f"graph octree {n}^3 at {P} parts: setup cache cold "
        f"{cold.setup_cache}, then {warm.setup_cache}; warm partition load "
        f"{ev_w.cache_wall('general'):.2f} s (cold build + store "
        f"{ev_c.cache_wall('general'):.2f} s), warm Solver {warm_s:.2f} s (cold "
        f"{cold_s:.2f} s)")
    if (cold.setup_cache, warm.setup_cache) != ("cold", "warm") \
            or warm.partition_build_s != 0.0:
        raise AssertionError("graph octree: the cache did not warm")
    _same_arrays(np, warm.pm, cold.pm, "warm partition")
    del cold
    torch.cuda.empty_cache()
    res_w, _ms_w, cyc_w = _general_solve(
        torch, np, warm, f"graph octree {n}^3 at {P} parts, warm", bar)
    same_u = bool(np.array_equal(warm.displacement_global(), u_c))
    say(f"graph octree {n}^3 at {P} parts: warm solve (flag, iterations) "
        f"({res_w.flag}, {res_w.iters}) against cold ({res_c.flag}, "
        f"{res_c.iters}), inner cycles equal: {cyc_w == cyc_c}, u bitwise "
        f"equal: {same_u}")
    if (res_w.flag, res_w.iters) != (res_c.flag, res_c.iters) or not same_u:
        raise AssertionError("graph octree: the warm solve is not the cold "
                             "one's")
    del warm
    torch.cuda.empty_cache()

    # 3. the 6^3 octree on the hybrid backend at 8 parts
    n6 = OCTREE_PARITY_N
    t0 = time.perf_counter()
    s6 = Solver(octrees.get(n6)[0],
                dataclasses.replace(cfg, cache_dir=""), n_parts=P,
                backend="hybrid")
    ep6 = np.ascontiguousarray(s6.pm.elem_part)
    say(f"graph hybrid octree {n6}^3 at {P} parts: Solver "
        f"{time.perf_counter() - t0:.2f} s, levels "
        f"{[(lv.size, lv.nb) for lv in s6.pm.levels]}; element map sha256 "
        f"{hashlib.sha256(ep6.tobytes()).hexdigest()}")
    res6, ms6, _c6, launches = _hybrid_solve(
        torch, np, s6, f"graph hybrid octree {n6}^3 at {P} parts",
        OCTREE_FLAGSHIP["load_value"] * n6 / OCTREE_FLAGSHIP["E"])
    win6 = max(3, ITERS_TOL * HYBRID6_ONE_PART_ITERS)
    say(f"graph hybrid octree {n6}^3 at {P} parts: {res6.iters} iterations "
        f"against the one-part hybrid's {HYBRID6_ONE_PART_ITERS} (window "
        f"+-{win6:g}), {ms6:.4f} ms/iter")
    if abs(res6.iters - HYBRID6_ONE_PART_ITERS) > win6:
        raise AssertionError(f"graph hybrid octree {n6}^3: {res6.iters} "
                             f"iterations, outside max(3, 5 %) of "
                             f"{HYBRID6_ONE_PART_ITERS}")
    del s6
    torch.cuda.empty_cache()

    # 4. 4e's 6^3 mg Solver again, warm
    mg6 = general["octree6_mg"]
    t0 = time.perf_counter()
    wmg = Solver(octrees.get(n6)[0], mg6["cfg"])
    wmg_s = time.perf_counter() - t0
    say(f"octree {n6}^3 mg: setup cache {mg6['cache']}, then "
        f"{wmg.setup_cache}; hierarchy {mg6['setup_s']:.3f} s cold, "
        f"{wmg.mg_setup_s:.3f} s warm; fine bound {mg6['lam_s']:.3f} s "
        f"cold, {wmg.mg_lam_s:.3f} s warm; warm Solver {wmg_s:.2f} s")
    if (mg6["cache"], wmg.setup_cache) != ("cold", "warm"):
        raise AssertionError("octree mg: the cache did not warm")
    _same_arrays(np, wmg.mg_setup, mg6["setup"], "warm mg hierarchy")
    _same_arrays(np, wmg.mg_lam, mg6["lam"], "warm mg bounds")
    res_w, _ms, _cyc = _general_solve(
        torch, np, wmg, f"octree {n6}^3 mg, warm",
        OCTREE_FLAGSHIP["load_value"] * n6 / OCTREE_FLAGSHIP["E"])
    same_u = bool(np.array_equal(wmg.displacement_global(), mg6["u"]))
    say(f"octree {n6}^3 mg, warm: (flag, iterations) ({res_w.flag}, "
        f"{res_w.iters}) against cold ({mg6['res'].flag}, "
        f"{mg6['res'].iters}), u bitwise equal: {same_u}")
    if (res_w.flag, res_w.iters) != (mg6["res"].flag, mg6["res"].iters) \
            or not same_u:
        raise AssertionError("octree mg: the warm solve is not the cold "
                             "one's")
    del wmg
    torch.cuda.empty_cache()
    return launches


def _host_fields(np, torch, model, u):
    """The nodal export fields of the global solution ``u`` on the host
    in float64: element strains and stresses (``elem_strain_host``,
    ``elem_stress_host``), their principal values and equivalent strain,
    averaged onto the nodes (``nodal_average_host``)."""
    from pcg_mpi_solver_tpu_torch.ops.nonlocal_stress import (
        elem_strain_host, elem_stress_host, nodal_average_host)
    from pcg_mpi_solver_tpu_torch.ops.stress import (
        eqv_strain, principal_values)

    eps = torch.from_numpy(elem_strain_host(model, u).T[None])
    sig = torch.from_numpy(elem_stress_host(model, u).T[None])
    pe, ps = principal_values(eps)[0].numpy(), principal_values(sig)[0].numpy()
    out = {"D": nodal_average_host(model, np.zeros(model.n_elem)),
           "ES": nodal_average_host(model, eqv_strain(eps)[0].numpy())}
    for i in range(3):
        out[f"PS{i + 1}"] = nodal_average_host(model, ps[i])
        out[f"PE{i + 1}"] = nodal_average_host(model, pe[i])
    return out


def _card_fields(torch, np, solver, un=None):
    """The solver's nodal export fields on the card from the float64
    solution ``un`` (default its own), as global host arrays, the card
    seconds, and the per-part tensors."""
    from pcg_mpi_solver_tpu_torch.ops.stress import nodal_export_fields

    un = solver.un if un is None else un
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fields = nodal_export_fields(solver.ops, solver.data, un, EXPORT_VARS,
                                 solver._nu)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    mask, nmap = solver.node_owner_mask(), solver.export_node_map()
    glob = {}
    for k, v in fields.items():
        g = np.zeros(solver.pm.glob_n_node)
        g[nmap] = v.cpu().numpy()[mask]
        glob[k] = g
    return glob, sec, fields


def _against(np, tag, got, want, tol=EXPORT_TOL):
    errs = {}
    for k in EXPORT_FIELDS:
        den = max(float(np.abs(want[k]).max()), 1e-300)
        errs[k] = float(np.abs(got[k] - want[k]).max()) / den
    say(f"export {tag}: max rel err "
        f"{ {k: f'{e:.2e}' for k, e in errs.items()} } (tol {tol:g})")
    if not all(e <= tol for e in errs.values()):
        raise AssertionError(f"export {tag} disagrees: {errs}")


def phase_export(torch, np, flagship, general, flagship_model):
    """Phase 4i, the export path on the solvers phases 4, 4e and 4h hold:
    the nodal fields on the card against the host float64 oracle (the
    flagship's two exports bitwise, a Boundary .vtu written and read
    back; the 22^3 octree's on the general and hybrid operators from one
    solution), NS on a 24^3 cut through ``Solver.solve(store=)`` on the
    card against the CPU, the mixed shell's windows at the flagship, and
    the CLI's programs in subprocesses."""
    import shutil

    from pcg_mpi_solver_tpu_torch.utils.io import RunStore
    from pcg_mpi_solver_tpu_torch.vtk.export import export_vtk
    from pcg_mpi_solver_tpu_torch.vtk.writer import read_vtu_arrays

    root = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(root, "build", "chip_smoke_export")
    shutil.rmtree(scratch, ignore_errors=True)
    try:
        # -- the flagship cube: fields, bitwise repeat, a .vtu
        t0 = time.perf_counter()
        u = flagship.displacement_global()
        card, sec, fields = _card_fields(torch, np, flagship)
        _g, sec2, fields2 = _card_fields(torch, np, flagship)
        same = all(torch.equal(fields[k], fields2[k]) for k in fields)
        t1 = time.perf_counter()
        oracle = _host_fields(np, torch, flagship._model, u)
        say(f"export flagship 150^3: fields {sorted(card)} on the card in "
            f"{sec:.3f} s and {sec2:.3f} s (two exports "
            f"{'bitwise equal' if same else 'DIFFERENT'}); host float64 "
            f"oracle {time.perf_counter() - t1:.2f} s")
        if not same:
            raise AssertionError("two flagship exports differ on the card")
        _against(np, "flagship 150^3 vs host oracle", card, oracle)
        store = RunStore(os.path.join(scratch, "flagship"), "flagship")
        store.prepare()
        store.write_map("Dof", flagship.export_dof_map())
        store.write_map("NodeId", flagship.export_node_map())
        store.write_frame("U", 0, flagship.displacement_owned())
        store.write_frame("PS1", 0, fields["PS1"].cpu().numpy()[
            flagship.node_owner_mask()])
        store.write_time_list([0.0])
        t1 = time.perf_counter()
        files = export_vtk(flagship._model, store, ["U", "PS1"], "Boundary")
        arrays = read_vtu_arrays(files[0])
        n_cells = len(arrays["offsets"])
        ok = (np.array_equal(arrays["PS1"], card["PS1"])
              and np.array_equal(arrays["U"], u.reshape(-1, 3)))
        say(f"export flagship: Boundary .vtu of U, PS1 "
            f"({os.path.getsize(files[0]) / 2**20:.1f} MiB, {n_cells} "
            f"faces) written and read back in "
            f"{time.perf_counter() - t1:.2f} s: arrays "
            f"{'equal' if ok else 'DIFFERENT'}")
        if not ok or n_cells != 6 * FLAGSHIP["nx"] ** 2:
            raise AssertionError("the flagship .vtu did not read back")
        shutil.rmtree(os.path.join(scratch, "flagship"))
        say(f"export flagship: {time.perf_counter() - t0:.1f} s")

        # -- the 22^3/L4 octree on the general and hybrid operators, both
        # from the general solve's float64 solution
        t0 = time.perf_counter()
        gs, hs = general["octree"], general["hybrid"]
        if not (gs.pm.n_loc == hs.pm.n_loc
                and np.array_equal(gs.pm.dof_gid, hs.pm.dof_gid)):
            raise AssertionError("general and hybrid octree layouts differ")
        g_fields, g_sec, _f = _card_fields(torch, np, gs)
        h_fields, h_sec, _f = _card_fields(torch, np, hs, un=gs.un)
        t1 = time.perf_counter()
        oracle = _host_fields(np, torch, gs._model, gs.displacement_global())
        say(f"export octree 22^3/L4: general {g_sec:.3f} s, hybrid "
            f"{h_sec:.3f} s on the card; host oracle "
            f"{time.perf_counter() - t1:.2f} s")
        _against(np, "octree general vs host oracle", g_fields, oracle)
        _against(np, "octree hybrid vs host oracle", h_fields, oracle)
        _against(np, "octree hybrid vs general", h_fields, g_fields)
        say(f"export octree: {time.perf_counter() - t0:.1f} s")
        del g_fields, h_fields, oracle

        phase_export_ns(torch, np, scratch)
        phase_export_windows(torch, np, flagship_model)
        phase_export_cli(np, root, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)


def phase_export_ns(torch, np, scratch):
    """NS on the 24^3 cut: ``Solver.solve(store=)`` with U, PS and NS on
    the card and on the CPU (frames within NS_TOL), and the operator's
    device apply on the card against its CSR on the host."""
    from pcg_mpi_solver_tpu_torch import (
        RunConfig, SolverConfig, TimeHistoryConfig)
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.ops.nonlocal_stress import (
        apply_padded, elem_stress_host, von_mises_stress)
    from pcg_mpi_solver_tpu_torch.solver import Solver
    from pcg_mpi_solver_tpu_torch.utils.io import RunStore

    t0 = time.perf_counter()
    kw = dict(FLAGSHIP)
    kw.pop("nx")
    model = make_cube_model(NS_CUT_CELLS, **kw)
    cfg = RunConfig(solver=SolverConfig(tol=1e-10, dtype="float64"),
                    time_history=TimeHistoryConfig(export_vars="U PS NS"))
    frames, solvers = {}, {}
    for dev in ("cuda", "cpu"):
        s = Solver(model, cfg, device=dev)
        if solvers:
            # the host-built NS operator once: both solves smooth with it
            s._nonlocal = solvers["cuda"]._nonlocal
        store = RunStore(os.path.join(scratch, f"ns_{dev}"), "ns")
        t1 = time.perf_counter()
        (res,) = s.solve(store=store)
        say(f"export NS cut {NS_CUT_CELLS}^3 on {dev}: flag {res.flag}, "
            f"iterations {res.iters}; solve + export "
            f"{time.perf_counter() - t1:.2f} s")
        if res.flag != 0:
            raise AssertionError(f"NS cut solve on {dev}: {res}")
        frames[dev] = {v: store.read_frame(v, 1) for v in ("U", "PS1",
                                                           "NS")}
        solvers[dev] = s
    for v in ("U", "PS1", "NS"):
        a, b = frames["cuda"][v], frames["cpu"][v]
        rel = float(np.abs(a - b).max() / np.abs(b).max())
        say(f"export NS cut: {v} card vs cpu max rel diff {rel:.3e} (tol "
            f"{NS_TOL:g})")
        if not rel <= NS_TOL:
            raise AssertionError(f"NS cut {v} on the card disagrees")
    W = solvers["cuda"]._nonlocal
    vm = von_mises_stress(elem_stress_host(model, solvers[
        "cuda"].displacement_global()), axis=1)
    cols, w = W.padded_arrays()
    dev_args = [torch.as_tensor(a, device="cuda") for a in (cols, w, vm)]
    ns_card = apply_padded(*dev_args)
    torch.cuda.synchronize()
    ms = time_ms(torch, lambda: apply_padded(*dev_args), reps=5, warmup=1)
    ref = W.apply(vm)
    rel = float(np.abs(ns_card.cpu().numpy() - ref).max()
                / np.abs(ref).max())
    say(f"export NS cut: {W.csr.nnz} weights ({cols.shape[1]} a row "
        f"padded), apply_padded on the card {ms:.3f} ms, against the host "
        f"CSR max rel diff {rel:.3e} (tol 1e-12); phase "
        f"{time.perf_counter() - t0:.1f} s")
    if not rel <= 1e-12:
        raise AssertionError("apply_padded on the card disagrees with the "
                             "CSR")


def phase_export_windows(torch, np, model):
    """The mixed flagship with each window of WINDOW_SOLVES: one of its
    flags, relres <= 1e-7 at flag 0 (nothing gated on speed), iterations,
    inner cycles and time to tol beside the JAX package's 3334."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.solver import Solver

    for name, opts, cap, flags in WINDOW_SOLVES:
        cfg = RunConfig(solver=SolverConfig(tol=1e-7, precision_mode="mixed",
                                            iters_per_dispatch=cap, **opts))
        t0 = time.perf_counter()
        s = Solver(model, cfg)
        setup = time.perf_counter() - t0
        with inner_cycles(s) as cycles:
            (res,) = s.solve()
        say(f"window {name} {opts}: flag {res.flag}, iterations "
            f"{res.iters} (JAX's default solve {JAX_FLAGSHIP_ITERS}), relres "
            f"{res.relres:.4e}, time to tol {res.wall_s:.3f} s, "
            f"{res.wall_s / max(res.iters, 1) * 1e3:.4f} ms/iter (setup "
            f"{setup:.2f} s); inner cycles (flag, iterations) {cycles}; "
            f"{dispatches(s)}")
        if res.flag not in flags or (res.flag == 0
                                     and not res.relres <= 1e-7) \
                or not np.isfinite(res.relres):
            raise AssertionError(f"flagship with the {name} window: {res}")
        del s
        torch.cuda.empty_cache()


def phase_export_cli(np, root, scratch):
    """The CLI's programs as a user runs them, in subprocesses on the
    card: the cube and octree demos beside ingest -> partition -> solve
    -> export of the CLI_CELLS cube written by ``write_mdf`` and zipped,
    and, once it is ingested, ``newmark`` (``CLI_NEWMARK_STEPS`` steps at
    50 x the CFL dt) and ``dynamics`` (``CLI_EXPLICIT_STEPS`` steps at the
    CFL dt) on it.  Each must exit 0; the solves print flag 0."""
    import shutil

    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.models.mdf import write_mdf
    from pcg_mpi_solver_tpu_torch.solver import stable_dt

    t0 = time.perf_counter()
    kw = dict(FLAGSHIP)
    kw.pop("nx")
    cli = os.path.join(scratch, "cli")
    cube = make_cube_model(*CLI_CELLS, **kw)
    dt = stable_dt(cube)
    write_mdf(cube, os.path.join(cli, "src"))
    del cube
    archive = shutil.make_archive(os.path.join(cli, "cube"), "zip",
                                  os.path.join(cli, "src"))
    settings = os.path.join(cli, "settings.json")
    with open(settings, "w") as f:
        json.dump({"TimeHistoryParam": {"ExportVars": "U PS ES"},
                   "SolverParam": {"Tol": 1e-8}}, f)
    env = dict(os.environ, PYTHONPATH=root)
    base = [sys.executable, "-m", "pcg_mpi_solver_tpu_torch.cli"]
    sc = os.path.join(cli, "scratch")
    demos = {"demo cube": ["demo", "--nx", "48", "--scratch",
                           os.path.join(cli, "d1")],
             "demo octree": ["demo", "--octree", "--nx", "4", "--max-level",
                             "3", "--scratch", os.path.join(cli, "d2")]}
    chain = {"ingest": ["ingest", archive, sc],
             "partition": ["partition", sc, "1"],
             "solve": ["solve", sc, "1", "--settings", settings],
             "export": ["export", sc, "1", "U PS1 ES", "Full"]}
    # on the ingested bundle, beside the rest of the chain
    timed = {"newmark": ["newmark", sc, "2", "--n-steps",
                         str(CLI_NEWMARK_STEPS), "--dt",
                         repr(TIME_NEWMARK_DT_FACTOR * dt)],
             "dynamics": ["dynamics", sc, "3", "--n-steps",
                          str(CLI_EXPLICIT_STEPS), "--dt", repr(dt),
                          "--damping", "0.1", "--export-every",
                          str(CLI_EXPLICIT_STEPS // 2)]}
    procs = {}
    outs = {}

    def start(tag, args):
        log = open(os.path.join(cli, tag.replace(" ", "_") + ".log"), "w+")
        procs[tag] = (subprocess.Popen(base + args, cwd=root, env=env,
                                       stdout=log,
                                       stderr=subprocess.STDOUT), log)

    try:
        for tag, args in demos.items():
            start(tag, args)
        for tag, args in chain.items():
            r = subprocess.run(base + args, cwd=root, env=env,
                               capture_output=True, text=True, timeout=300)
            outs[tag] = (r.returncode, r.stdout + r.stderr)
            if r.returncode:
                break
            if tag == "ingest":
                for ttag, targs in timed.items():
                    start(ttag, targs)
        for tag, (proc, log) in procs.items():
            rc = proc.wait(timeout=300)
            log.seek(0)
            outs[tag] = (rc, log.read())
    finally:
        for proc, log in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
    for tag, (rc, text) in outs.items():
        lines = [ln for ln in text.splitlines() if ln.startswith(">")]
        say(f"cli {tag}: exit {rc}; {' | '.join(lines[-4:])}")
        ok = rc == 0
        if tag in ("solve", "demo cube", "demo octree"):
            ok = ok and "flag=0" in text and ">success!" in text
        elif tag in timed:
            # every Newmark step converged; the explicit run finished
            ok = ok and ">success!" in text and (
                tag != "newmark"
                or text.count("flag=0") == CLI_NEWMARK_STEPS)
        if not ok:
            raise AssertionError(f"cli {tag} failed (exit {rc}):\n{text}")
    if set(outs) != set(demos) | set(chain) | set(timed):
        raise AssertionError(f"cli: not every program ran: {sorted(outs)}")
    say(f"cli: {time.perf_counter() - t0:.1f} s")


def n_disp_of(solver) -> int:
    """The capped ``pcg_many`` calls of a solver's last chunked block."""
    return sum(1 for e in solver.dispatch_log if e[0] == "many")


def phase_many_chunked(torch, np, model):
    """Phase 4g: the chunked blocked path of ``Solver.solve_many``,
    direct float64, classic, jacobi, each check raising:
    1. the 150^3 flagship's block [F, F_y] at the auto cap (cap,
       dispatches, per-column flag, iterations and tip, ms a trip,
       dof*iter*rhs/s; flags 0, relres <= tol, the float64 v6 launches
       cover the trips);
    then on the 48x32x32 cube's [F, F_y] at cap 100 (the flagship ran
    them until the telemetry phase needed its seconds):
    2. the chunked block against the same block one-shot (iterations
       equal, max|dx| <= 1e-12 max|x|, bitwise printed);
    3. ``nan@col:1`` at the default ``max_recoveries``: column 1 takes one
       restart and ends at flag 0, column 0 bit for bit the clean block's;
    4. the same at ``max_recoveries=0``: column 1 quarantined (flag 5),
       one ``rhs_quarantine`` event;
    5. a block of 3 with ``snapshot_every=1`` killed at boundary 2 and
       resumed with ``solve_many(resume=True)`` in a new Solver: bitwise
       the uninterrupted block.
    Returns the launch counts of the chunked flagship block."""
    import shutil

    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.obs.metrics import MetricsRecorder
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.resilience import (
        FaultPlan, SimulatedKill)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    nx, tol = FLAGSHIP["nx"], MANY_CHUNKED_TOL
    f64 = ("v6", "float64")
    smi = nvidia_smi_line()
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "chip_smoke_checkpoints", "many")
    shutil.rmtree(scratch, ignore_errors=True)

    def solver(m, cap=-1, run_id="1", **rkw):
        ev = _Events()
        cfg = RunConfig(scratch_path=scratch, run_id=run_id, solver=(
            SolverConfig(tol=tol, precision_mode="direct", dtype="float64",
                         iters_per_dispatch=cap)), **rkw)
        return Solver(m, cfg, recorder=MetricsRecorder(sinks=[ev])), ev

    fb = np.stack([np.asarray(model.F), shear_loads(np, model)[0]], -1)
    s, ev = solver(model)
    if s._dispatch_cap <= 0:
        raise AssertionError("the flagship block did not take the chunked "
                             "path")
    torch.cuda.synchronize()
    reset_launch_counts()
    r = s.solve_many(fb)
    launches = dict(LAUNCHES)
    n_disp = n_disp_of(s)
    x = s.displacement_global_many(r.x)
    tips = (float(x[0::3, 0].max()), float(x[1::3, 1].max()))
    bars = (tip_estimate(nx, False), tip_estimate(nx, True))
    iters = [int(v) for v in r.iters]
    ms_trip = r.solve_wall_s / r.trips * 1e3
    rate = model.n_dof * sum(iters) / r.solve_wall_s
    say(f"many chunked {nx}^3 direct f64 [F, F_y]: cap {s._dispatch_cap}, "
        f"{n_disp} dispatches; flags {list(map(int, r.flags))}, iterations "
        f"{iters}, relres {[float(f'{v:.4e}') for v in r.relres]}; tips "
        f"{tips[0]:.4e} (bar {bars[0]:.4e}), {tips[1]:.4e} (shear "
        f"{bars[1]:.4e}) m; {r.trips} trips, {r.solve_wall_s:.3f} s, "
        f"{ms_trip:.4f} ms a trip, {rate:.4e} dof*iter*rhs/s; float64 v6 "
        f"launches {launches[f64]}; {smi}")
    if (r.flags != 0).any() or not (r.relres <= tol).all():
        raise AssertionError(f"many chunked: {r.flags}, {r.relres}")
    if launches[f64] < r.trips:
        raise AssertionError(f"many chunked: {launches[f64]} float64 "
                             f"launches for {r.trips} trips")
    for tip, bar in zip(tips, bars):
        if not bar / 3 <= tip <= 3 * bar:
            raise AssertionError(f"many chunked: tip {tip} outside "
                                 f"[1/3, 3] x {bar}")
    del s, r
    torch.cuda.empty_cache()
    # 2.-4. on the 48x32x32 cube at cap 100: the block one-shot, a NaN
    # in column 1, the ladder off
    kw = dict(FLAGSHIP)
    kw.pop("nx")
    small = make_cube_model(*DIRECT_F64_CELLS, **kw)
    cells = "x".join(map(str, DIRECT_F64_CELLS))
    fb = np.stack([np.asarray(small.F), shear_loads(np, small)[0]], -1)
    s, ev = solver(small, 100)
    r = s.solve_many(fb)
    iters = [int(v) for v in r.iters]
    s1, _ = solver(small, cap=0)
    r1 = s1.solve_many(fb)
    dx = float((r1.x - r.x).abs().max() / r.x.abs().max())
    same = torch.equal(r1.x, r.x)
    say(f"many chunked {cells} [F, F_y] at cap 100: {n_disp_of(s)} "
        f"dispatches, flags {list(map(int, r.flags))}, iterations {iters}; "
        f"one-shot: flags {list(map(int, r1.flags))}, "
        f"iterations {list(map(int, r1.iters))}, {r1.trips} trips, "
        f"{r1.solve_wall_s:.3f} s, {r1.solve_wall_s / r1.trips * 1e3:.4f} "
        f"ms a trip; chunked against one-shot max|dx| {dx:.3e} of max|x| "
        f"({'bitwise equal' if same else 'not bitwise'})")
    if list(r1.iters) != iters or not dx <= 1e-12:
        raise AssertionError("many chunked: not the one-shot block")
    del s1, r1
    torch.cuda.empty_cache()
    # 3. a NaN in column 1's carry: one restart of that column
    n0 = len(ev.events)
    s.fault_plan = FaultPlan("nan@col:1", recorder=s.recorder)
    r2 = s.solve_many(fb)
    recs = [(e["action"], e["trigger"], e["rhs"])
            for e in ev.events[n0:] if e["kind"] == "recovery"]
    keep = torch.equal(r2.x[..., 0], r.x[..., 0]) \
        and int(r2.iters[0]) == iters[0]
    say(f"many chunked {cells} nan@col:1: flags "
        f"{list(map(int, r2.flags))}, iterations "
        f"{list(map(int, r2.iters))}, recoveries {r2.recoveries} {recs}, "
        f"{r2.solve_wall_s:.3f} s (+{r2.solve_wall_s - r.solve_wall_s:.3f} "
        f"s); column 0 against the clean block "
        f"{'bitwise equal' if keep else 'DIFFERENT'}")
    if list(r2.flags) != [0, 0] or recs != [("restart_minres", "nan_carry",
                                             1)] or not keep:
        raise AssertionError(f"many chunked nan@col:1: {r2.flags}, {recs}")
    # 4. the ladder off: column 1 quarantined
    s.config.solver.max_recoveries = 0
    n0 = len(ev.events)
    s.fault_plan = FaultPlan("nan@col:1", recorder=s.recorder)
    r3 = s.solve_many(fb)
    quar = [(e["rhs"], e["trigger"]) for e in ev.events[n0:]
            if e["kind"] == "rhs_quarantine"]
    say(f"many chunked {cells} nan@col:1 max_recoveries=0: flags "
        f"{list(map(int, r3.flags))}, quarantined {list(r3.quarantined)}, "
        f"rhs_quarantine events {quar}, relres[1] {r3.relres[1]:.4e}")
    if list(r3.flags) != [0, QUARANTINE] or quar != [(1, "nan_carry")]:
        raise AssertionError(f"many chunked quarantine: {r3.flags}, {quar}")
    del s, r, r2, r3
    torch.cuda.empty_cache()
    # 5. kill at boundary 2 and resume
    fb3 = np.stack([np.asarray(small.F)] + shear_loads(np, small), -1)
    sa, _ = solver(small, 100, run_id="whole", snapshot_every=1)
    ra = sa.solve_many(fb3)
    sk, _ = solver(small, 100, run_id="killed", snapshot_every=1)
    sk.fault_plan = FaultPlan("kill@2", recorder=sk.recorder)
    try:
        sk.solve_many(fb3)
        killed = False
    except SimulatedKill:
        killed = True
    sr, evr = solver(small, 100, run_id="killed", snapshot_every=1)
    rr = sr.solve_many(fb3, resume=True)
    ops = [e["op"] for e in evr.events if e["kind"] == "snapshot"]
    same = torch.equal(rr.x, ra.x) and list(rr.iters) == list(ra.iters)
    say(f"many chunked {cells} kill@2 and resume (R=3, cap 100): killed "
        f"{killed}, resumed flags {list(map(int, rr.flags))}, iterations "
        f"{list(map(int, rr.iters))} against {list(map(int, ra.iters))}, "
        f"snapshot ops {ops[:1]}...; "
        f"{'bitwise equal' if same else 'DIFFERENT'}")
    if not (killed and same and ops[:1] == ["restore"]) \
            or (ra.flags != 0).any():
        raise AssertionError("many chunked: kill and resume is not the "
                             "uninterrupted block")
    shutil.rmtree(scratch, ignore_errors=True)
    return launches


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
                with inner_cycles(s) as cycles:
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


    # blocks of load cases on the card against the same blocks on the CPU
    for variant, precond, cells_cpu in MANY_CARD_VS_CPU:
        small = make_cube_model(*cells_cpu, seed=4, **kw)
        blk = np.stack([np.asarray(small.F)] + shear_loads(np, small), -1)
        for mode, rtol in (("direct", 1e-8), ("mixed", 1e-5)):
            cfg = RunConfig(solver=SolverConfig(tol=1e-9,
                                                precision_mode=mode,
                                                precond=precond,
                                                pcg_variant=variant))
            out = {}
            for dev in ("cuda", "cpu"):
                s = Solver(small, cfg, device=dev)
                r = s.solve_many(blk)
                out[dev] = (r.flags.tolist(), r.iters.tolist(),
                            s.displacement_global_many(r.x))
            (fg, ig, u_g), (fc, ic, u_c) = out["cuda"], out["cpu"]
            rel = float(np.abs(u_g - u_c).max() / np.abs(u_c).max())
            say(f"card vs cpu, blocked R=3 [F, F_y, F_z], {variant}, "
                f"{precond}, {mode}, traction "
                f"{'x'.join(map(str, cells_cpu))}: flags card {fg} cpu "
                f"{fc}, iterations card {ig} cpu {ic}, max rel diff "
                f"{rel:.3e} (tol {rtol:g})")
            if any(fg) or fg != fc or not rel <= rtol or (
                    mode == "direct"
                    and max(abs(a - b) for a, b in zip(ig, ic)) > 1):
                raise AssertionError(f"blocked {variant} {precond} {mode} "
                                     f"on the card disagrees with the CPU")

    # the time integrators on the card against the CPU
    time_card_vs_cpu(torch, np, kw)

    # the mixed shell's windows, each set so that it fires: the card's
    # flag and iterations against the CPU's (the mixed rule, max(3, 5 %))
    wcells, wkw = WINDOW_CUBE
    wmodel = make_cube_model(*wcells, **wkw)
    for name, opts, want in WINDOW_CARD_VS_CPU:
        cfg = RunConfig(solver=SolverConfig(
            tol=1e-8, max_iter=2000, precision_mode="mixed", inner_tol=1e-6,
            **opts))
        out = {}
        for dev in ("cuda", "cpu"):
            s = Solver(wmodel, cfg, device=dev)
            with inner_cycles(s) as cycles:
                (r,) = s.solve()
            out[dev] = (r.flag, r.iters, cycles)
        (fg, ig, cg), (fc, ic, cc) = out["cuda"], out["cpu"]
        say(f"card vs cpu, window {name} {opts}, "
            f"{'x'.join(map(str, wcells))}: flag card {fg} cpu {fc} (the "
            f"JAX package's {want}), iterations card {ig} cpu {ic}; inner "
            f"cycles card {cg} cpu {cc}")
        if fg != fc or fg != want or abs(ig - ic) > max(3, 0.05 * ic) \
                or not any(f == 3 for f, _n in cc):
            raise AssertionError(f"the {name} window on the card disagrees "
                                 f"with the CPU")


# phase 4l: the convergence ring's length (>= the flagship's ~3334
# iterations: the whole trace, not truncated), the window of inner f32
# iterations the profile capture holds (profile_inner's), the 48x32x32
# drill's flight file, and the scratch directory of the phase's files
TELEMETRY_RING = 4000
TELEMETRY_WINDOW = 100
TELEMETRY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_telemetry")
TELEMETRY_CHILD_DIR = os.path.join(os.path.dirname(os.path.abspath(
    __file__)), "build", "chip_smoke_capture")
# the killed child: a 48x32x32 direct float64 solve in one dispatch with
# a flight file, held until the parent's go file appears
_KILL_CHILD = r"""
import os, sys, time
from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
from pcg_mpi_solver_tpu_torch.models import make_cube_model
from pcg_mpi_solver_tpu_torch.solver import Solver
flight, go, cells, kw = sys.argv[1], sys.argv[2], eval(sys.argv[3]), \
    eval(sys.argv[4])
s = Solver(make_cube_model(*cells, **kw), RunConfig(
    flight_path=flight, solver=SolverConfig(
        tol=1e-12, max_iter=20000, precision_mode="direct",
        iters_per_dispatch=20000)))
open(go + ".ready", "w").close()
while not os.path.exists(go):
    time.sleep(0.01)
s.step(1.0)
"""


def _count_syncs(torch, run):
    """``run()`` under torch's CUDA sync debug mode: (its result, the
    number of synchronising calls it made)."""
    import warnings

    n = [0]

    def record(message, *args, **kwargs):
        # one warning a synchronising call (the mode's own notice, once a
        # process, is not one)
        if str(message).startswith("called a synchronizing CUDA"):
            n[0] += 1

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = record
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, n[0]


def _kill_child():
    """Start the kill drill's child: a 48x32x32 direct float64 solve in one
    dispatch with a flight file, held until :func:`_kill_drill` lets it
    go (so its start overlaps the parent's work).  Returns (process,
    flight path, go file)."""
    path = os.path.join(TELEMETRY_DIR, "killed.jsonl")
    go = os.path.join(TELEMETRY_DIR, "go")
    kw = {k: v for k, v in FLAGSHIP.items() if k != "nx"}
    root = os.path.dirname(os.path.abspath(__file__))
    child = subprocess.Popen(
        [sys.executable, "-c", _KILL_CHILD, path, go,
         repr(DIRECT_F64_CELLS), repr(kw)],
        env=dict(os.environ, PYTHONPATH=root), cwd=root)
    return child, path, go


def _kill_drill(child, path, go):
    """Let the child solve and SIGKILL it while its dispatch runs: the
    flight file's verdict is ``died`` with the dispatch in flight.  (An
    injected ``kill@N`` is an exception: unwinding, it closes its
    brackets, and it fires at a chunk boundary, between dispatches; a
    real kill is what the flight file is for.)  Returns the verdict."""
    import signal

    from pcg_mpi_solver_tpu_torch.obs.flight import flight_verdict_path

    try:
        deadline = time.time() + 300
        while not os.path.exists(go + ".ready"):
            if child.poll() is not None or time.time() > deadline:
                raise AssertionError(f"kill drill: the child ended "
                                     f"({child.returncode}) before its solve")
            time.sleep(0.05)
        open(go, "w").close()
        while "dispatch:cycle" not in flight_verdict_path(path)["in_flight"]:
            if child.poll() is not None or time.time() > deadline:
                raise AssertionError("kill drill: no dispatch in flight")
            time.sleep(0.002)
        child.send_signal(signal.SIGKILL)
        child.wait(timeout=60)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    return flight_verdict_path(path)


# the capture's child: the flagship's off Solver built in a fresh process
# (started with the run, beside the octree children, so its host build
# overlaps phase 3 and 4g), held idle until phase 4l's go file (which
# carries the phase probe's times) appears; a fresh process's trace holds
# every device event of the window, a long one's can miss a few
_CAPTURE_CHILD = r"""
import sys
import chip_smoke
sys.exit(chip_smoke.capture_child(*sys.argv[1:]))
"""


def capture_window(torch, solver, out_dir, recorded):
    """``capture_solve_profile`` over ``TELEMETRY_WINDOW`` f32 inner
    iterations of ``solver`` (profile_inner's window) read back by
    ``obs/profview.py``: a JSON-able dict of the report's lines and the
    gate numbers (v6 launches counted in the window, v6 kernels in the
    trace and in matvec, the phase sum plus ``other`` and
    ``key_averages``' device time in us)."""
    from pcg_mpi_solver_tpu_torch.obs import profview
    from pcg_mpi_solver_tpu_torch.ops.precond import make_prec
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import LAUNCHES
    from pcg_mpi_solver_tpu_torch.solver.pcg import pcg

    ops, data = solver.ops32, solver.data32
    rhs = data["eff"] * data["F"]
    rhs = rhs / rhs.norm()
    inv = make_prec(ops, data, "jacobi")
    counts = []

    def window():
        torch.cuda.synchronize()
        before = LAUNCHES[("v6", "float32")]
        t1 = time.perf_counter()
        _res, carry = pcg(ops, data, rhs, torch.zeros_like(rhs), inv,
                          tol=1e-30, max_iter=TELEMETRY_WINDOW,
                          glob_n_dof_eff=solver.pm.glob_n_dof_eff,
                          return_carry=True)
        torch.cuda.synchronize()
        counts.append(LAUNCHES[("v6", "float32")] - before)
        return carry["exec"], time.perf_counter() - t1

    cap = profview.capture_solve_profile(solver, out_dir, fn=window)
    trace_file = profview.find_trace_files(cap["artifact"])[0]
    rep = profview.profile_report(cap["artifact"])
    evs, _p = profview.read_trace_events(trace_file)
    cats = {}
    for e in evs:
        cats[str(e.get("cat"))] = cats.get(str(e.get("cat")), 0) + 1
    v6 = [op for op in profview.device_ops(evs)
          if "structured_matvec_kernel" in op["name"]
          and "FfmaProduct" in op["name"]]
    return dict(
        iters=cap["iters"], trace_bytes=os.path.getsize(trace_file),
        cats=dict(sorted(cats.items())),
        report=profview.format_report(
            rep, predicted=solver._cost_model,
            recorded=recorded).splitlines(),
        launches=counts[-1], v6_trace=len(v6),
        v6_matvec=sum(op["label"] == "pcg/matvec" for op in v6),
        busy_us=sum(r[0] for r in _device_rows(cap["prof"])),
        split_us=(rep["sum_ms"] + rep["other_ms"]) * 1e3)


def capture_child(result, go, out_dir) -> int:
    """The capture child's body (``_CAPTURE_CHILD``): build the flagship
    and its mixed Solver (phase 4l's off one), wait for ``go``, run
    :func:`capture_window` with the probe times ``go`` holds, write the
    result to ``result`` as JSON."""
    import torch

    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.solver import Solver

    kw = dict(FLAGSHIP)
    nx = kw.pop("nx")
    t0 = time.perf_counter()
    s = Solver(make_cube_model(nx, **kw), RunConfig(
        solver=SolverConfig(tol=1e-7, precision_mode="mixed")))
    setup_s = time.perf_counter() - t0
    open(go + ".ready", "w").close()
    while not os.path.exists(go):
        time.sleep(0.01)
    with open(go) as f:
        recorded = json.load(f)
    out = capture_window(torch, s, out_dir, recorded)
    out["setup_s"] = setup_s
    with open(result + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(result + ".tmp", result)
    return 0


class CaptureChild:
    """The capture's child process (``_CAPTURE_CHILD``): :meth:`start`
    launches it, :meth:`run` lets it capture and returns its result,
    :meth:`close` ends it whatever happened."""

    def __init__(self):
        self.proc = None
        self.result = os.path.join(TELEMETRY_CHILD_DIR, "capture.json")
        self.go = os.path.join(TELEMETRY_CHILD_DIR, "go")

    def start(self):
        root = os.path.dirname(os.path.abspath(__file__))
        shutil.rmtree(TELEMETRY_CHILD_DIR, ignore_errors=True)
        os.makedirs(TELEMETRY_CHILD_DIR)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", _CAPTURE_CHILD, self.result, self.go,
             os.path.join(TELEMETRY_CHILD_DIR, "prof")], cwd=root, env=env)

    def run(self, recorded, timeout: float = 600.0):
        """Wait for the child's Solver, hand it the probe times, wait for
        its capture; returns (result, seconds waited for the Solver)."""
        t0 = time.perf_counter()
        deadline = time.time() + timeout
        while not os.path.exists(self.go + ".ready"):
            if self.proc.poll() is not None or time.time() > deadline:
                raise AssertionError(f"telemetry: the capture child ended "
                                     f"({self.proc.returncode}) before "
                                     f"its Solver was built")
            time.sleep(0.05)
        waited = time.perf_counter() - t0
        with open(self.go + ".tmp", "w") as f:
            json.dump(recorded, f)
        os.replace(self.go + ".tmp", self.go)
        try:
            rc = self.proc.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            raise AssertionError("telemetry: the capture child timed out")
        if rc != 0:
            raise AssertionError(f"telemetry: the capture child failed "
                                 f"({rc})")
        with open(self.result) as f:
            return json.load(f), waited

    def close(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        shutil.rmtree(TELEMETRY_CHILD_DIR, ignore_errors=True)


def phase_telemetry(torch, np, model, capture):
    """Phase 4l: observability on the flagship (150^3, mixed, classic,
    jacobi, v6, chunked at the auto cap), after every timed solve a
    profiler window could slow:
    1. one Solver with the ring off, one with ``trace_resid`` =
       ``TELEMETRY_RING``, the JSONL sink and a flight file: each solved
       once timed (ms/iter printed), then once under torch's sync debug
       mode; flag, iterations and u bitwise equal, the same number of
       synchronising calls; the ring holds every iteration, not
       truncated, with flag 1 everywhere but at the inner cycles' exits,
       where it holds each cycle's flag (the last, 0, ends the ring);
    2. the JSONL stream passes the port's validator and ends with the run
       summary (printed, ``summarize_jsonl``); the flight file reads
       clean; a child killed inside a 48x32x32 dispatch leaves a file
       whose verdict is died with the dispatch in flight;
    3. the phase probe and the cost model: predicted, probed and measured
       ms/iter;
    4. ``capture`` (a :class:`CaptureChild`, started with the run)
       runs :func:`capture_window` on its own flagship Solver in a fresh
       process: the phase split, every v6 launch of the window in the
       trace and in ``matvec``, the phase sum plus ``other`` within 2 %
       of the device time of ``key_averages``."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.obs import perf
    from pcg_mpi_solver_tpu_torch.obs.flight import flight_verdict_path
    from pcg_mpi_solver_tpu_torch.obs.metrics import summarize_jsonl
    from pcg_mpi_solver_tpu_torch.obs.phases import run_phase_probe
    from pcg_mpi_solver_tpu_torch.obs.schema import validate_jsonl_text
    from pcg_mpi_solver_tpu_torch.solver import Solver

    shutil.rmtree(TELEMETRY_DIR, ignore_errors=True)
    os.makedirs(TELEMETRY_DIR)
    smi = nvidia_smi_line()
    tel = os.path.join(TELEMETRY_DIR, "run.jsonl")
    fl = os.path.join(TELEMETRY_DIR, "flight.jsonl")
    sc = SolverConfig(tol=1e-7, precision_mode="mixed")
    t0 = time.perf_counter()
    off = Solver(model, RunConfig(solver=sc))
    on = Solver(model, RunConfig(
        telemetry_path=tel, flight_path=fl,
        solver=dataclasses.replace(sc, trace_resid=TELEMETRY_RING)))
    say(f"telemetry: two flagship Solvers in {time.perf_counter() - t0:.2f} "
        f"s; ring {on.trace_len} slots, cap {on._dispatch_cap}")

    # 1. ring off against ring on: timed once each (two Solvers' buffers
    # alone differ by ~1 %: tools/telemetry_overhead.py times the pieces
    # apart, in turns, on one Solver), then counted
    runs = {}
    for name, s in (("off", off), ("on", on)):
        with inner_cycles(s) as cycles:
            (r,) = s.solve()
        runs[name] = dict(res=r, u=s.un.clone(), cycles=list(cycles),
                          trace=s.last_trace)
        s.reset_state()
    # the kill drill's child starts while the counted solves run
    child = _kill_child()
    for name, s in (("off", off), ("on", on)):
        (r,), n = _count_syncs(torch, lambda: s.solve())
        runs[name]["syncs"] = n
        runs[name]["res2"] = r
        s.reset_state()
    a, b = runs["off"], runs["on"]
    for name in ("off", "on"):
        r = runs[name]["res"]
        say(f"telemetry ring {name}: flag {r.flag}, iterations {r.iters}, "
            f"{r.wall_s:.3f} s, {r.wall_s / r.iters * 1e3:.4f} ms/iter; "
            f"synchronising calls in a second solve "
            f"{runs[name]['syncs']} ({runs[name]['res2'].iters} "
            f"iterations); inner cycles {runs[name]['cycles']}; {smi}")
    same = (a["res"].flag == b["res"].flag and a["res"].iters ==
            b["res"].iters and torch.equal(a["u"], b["u"]))
    if not same or a["res"].flag != 0:
        raise AssertionError("telemetry: the traced solve is not the "
                             "untraced one bit for bit")
    if a["syncs"] != b["syncs"]:
        raise AssertionError(f"telemetry: {b['syncs']} synchronising calls "
                             f"traced against {a['syncs']} untraced")
    tr = b["trace"]
    ends = np.cumsum([n for _f, n in b["cycles"]]) - 1
    exits = np.flatnonzero(tr.flag != 1)
    say(f"telemetry ring: {tr.n_recorded} records, truncated "
        f"{tr.truncated}, flags other than 1 at {exits.tolist()} "
        f"{tr.flag[exits].tolist()} (inner cycles end at {ends.tolist()}); "
        f"normr {tr.normr[0]:.4e} -> {tr.normr[-1]:.4e}")
    # the ring's last record is the last cycle's exit: 0 when the last
    # inner cycle converged (the flagship's does)
    if (tr.n_recorded != b["res"].iters or tr.truncated
            or exits.tolist() != ends.tolist()
            or tr.flag[exits].tolist() != [f for f, _n in b["cycles"]]):
        raise AssertionError("telemetry: the ring is not the solve's")

    # 2. the streams
    on.recorder.close()
    text = open(tel).read()
    errs = validate_jsonl_text(text)
    last = json.loads(text.splitlines()[-1])["kind"]
    say(f"telemetry stream: {len(text.splitlines())} events, "
        f"{os.path.getsize(tel)} bytes, schema errors {errs[:3]}, last "
        f"event {last}")
    for line in summarize_jsonl(tel).splitlines():
        say(f"telemetry summary: {line}")
    if errs or last != "run_summary":
        raise AssertionError("telemetry: the JSONL stream is not valid")
    v = flight_verdict_path(fl)
    say(f"telemetry flight: verdict {v['verdict']}, {v['records']} records")
    if v["verdict"] != "clean":
        raise AssertionError(f"telemetry: flight verdict {v}")
    t0 = time.perf_counter()
    v = _kill_drill(*child)
    say(f"telemetry kill drill ({'x'.join(map(str, DIRECT_F64_CELLS))}, "
        f"SIGKILL in the solve's dispatch): verdict {v['verdict']}, in "
        f"flight {v['in_flight']}, {v['records']} records, "
        f"{time.perf_counter() - t0:.1f} s")
    if v["verdict"] != "died" or "dispatch:cycle" not in v["in_flight"]:
        raise AssertionError(f"telemetry: killed flight verdict {v}")

    # 3. the phase probe and the cost model
    cm = on._cost_model
    probe = run_phase_probe(off, reps=3, whole=False)
    meas = a["res"].wall_s / a["res"].iters * 1e3
    say(f"telemetry cost model ({cm['profile']}): predicted "
        f"{cm['predicted_ms_per_iter']:.4f} ms/iter "
        + " ".join(f"{ph} {cm['phases'][ph]['model_ms']:.4f}"
                   for ph in perf.PHASES)
        + f"; probed (float32 inner operator, CUDA events) "
        f"{probe['sum_ms_per_iter']:.4f} ms/iter "
        + " ".join(f"{ph} {probe['phases'][ph]:.4f}" for ph in perf.PHASES)
        + f"; measured {meas:.4f} ms/iter ({meas / cm['predicted_ms_per_iter']:.2f}x "
        f"the prediction)")

    # 4. the capture, in its fresh child process (its Solver was built
    # at the start of the run)
    out, waited = capture.run(probe["phases"])
    say(f"telemetry capture (a fresh process; its flagship Solver built "
        f"in {out['setup_s']:.1f} s, {waited:.1f} s waited here): "
        f"{out['iters']} iterations, {out['trace_bytes']} bytes gzipped, "
        f"event categories {out['cats']}")
    for line in out["report"]:
        say(f"telemetry profile: {line}")
    busy_us, split_us = out["busy_us"], out["split_us"]
    if busy_us <= 0:
        raise AssertionError("telemetry: the capture holds no device time")
    say(f"telemetry capture gates: v6 launches in the window "
        f"{out['launches']}, v6 kernels in the trace {out['v6_trace']}, in "
        f"matvec {out['v6_matvec']}; phase sum + other "
        f"{split_us / 1e3:.4f} ms against key_averages' device time "
        f"{busy_us / 1e3:.4f} ms ({split_us / busy_us - 1:+.2%})")
    # every v6 launch the window counted is in the trace and in matvec
    if not (out["launches"] > 0 and out["v6_trace"] == out["v6_matvec"]
            == out["launches"]):
        raise AssertionError("telemetry: the v6 launches are not all in "
                             "the matvec phase")
    if abs(split_us / busy_us - 1) > 0.02:
        raise AssertionError("telemetry: the phase split is not the "
                             "window's device time")
    del off, on
    torch.cuda.empty_cache()
    shutil.rmtree(TELEMETRY_DIR, ignore_errors=True)


def time_card_vs_cpu(torch, np, kw):
    """Phase 5, the time integrators on the 12x6x5 cube, the card against
    the CPU: Newmark direct under block3 and mixed under jacobi (tol
    1e-12, dt 0.2, damping 0.1, ``TIME_CHECK_DELTAS``) and float64
    explicit dynamics (half the CFL dt, ``TIME_CHECK_STEPS`` steps): u
    within 1e-10 of max|u|; Newmark's iterations within +-1 a step
    (direct).  The mixed totals are printed with their inner cycles, not
    held, as for the quasi-static mixed solves above: this cube's f32
    cycles end on stagnation exits whose iteration is round-off."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.solver import (
        DynamicsSolver, NewmarkSolver, stable_dt)

    model = make_cube_model(*CARD_VS_CPU_CELLS, seed=4, **kw)
    cells = "x".join(map(str, CARD_VS_CPU_CELLS))
    for name, sc in (("direct block3", dict(precond="block3")),
                     ("mixed jacobi", dict(precision_mode="mixed"))):
        cfg = RunConfig(solver=SolverConfig(tol=1e-12, **sc))
        out = {}
        for dev in ("cuda", "cpu"):
            s = NewmarkSolver(model, cfg, dt=0.2, damping=0.1, device=dev)
            with inner_cycles(s) as cycles:
                rs = s.run(TIME_CHECK_DELTAS)
            out[dev] = ([(r.flag, r.iters) for r in rs],
                        s.displacement_global(), cycles)
        (st_g, u_g, cyc_g), (st_c, u_c, cyc_c) = out["cuda"], out["cpu"]
        rel = float(np.abs(u_g - u_c).max() / np.abs(u_c).max())
        mixed = "mixed" in name
        say(f"card vs cpu, newmark {name} {cells}: (flag, iters) card "
            f"{st_g} cpu {st_c}, max rel diff {rel:.3e} (tol 1e-10)"
            + (f"; inner cycles card {cyc_g} cpu {cyc_c}" if mixed else ""))
        it_g, it_c = [i for _f, i in st_g], [i for _f, i in st_c]
        iters_ok = mixed or all(abs(a - b) <= 1 for a, b in zip(it_g, it_c))
        if any(f for f, _i in st_g + st_c) or not rel <= 1e-10 \
                or not iters_ok:
            raise AssertionError(f"newmark {name} on the card disagrees "
                                 f"with the CPU")
    out = {}
    for dev in ("cuda", "cpu"):
        s = DynamicsSolver(model, RunConfig(), dt=0.5 * stable_dt(model),
                           damping=0.1, probe_dofs=(int(np.argmax(model.F)),),
                           device=dev)
        out[dev] = s.run(TIME_CHECK_STEPS, export_every=50)
    g, c = out["cuda"], out["cpu"]
    rel = float(np.abs(g.u - c.u).max() / np.abs(c.u).max())
    relp = float(np.abs(g.probe_u - c.probe_u).max()
                 / np.abs(c.probe_u).max())
    say(f"card vs cpu, explicit float64 {cells}, {TIME_CHECK_STEPS} steps: "
        f"u max rel diff {rel:.3e}, probe {relp:.3e} (tol 1e-10)")
    if not (rel <= 1e-10 and relp <= 1e-10):
        raise AssertionError("explicit dynamics on the card disagrees with "
                             "the CPU")


MP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "chip_smoke_mp")

# a rank of phase 4n: joins the group from the PCG_TPU_* variables
_MP_CHILD = r"""
import sys
import chip_smoke
sys.exit(chip_smoke.multiprocess_child(*sys.argv[1:]))
"""


def _mp_spawn(mode: str, env_extra=None):
    """Start phase 4n's two ranks in ``mode``; their output goes to files
    under ``MP_DIR``.  Returns (processes, log paths)."""
    import socket

    root = os.path.dirname(os.path.abspath(__file__))
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs, logs = [], []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
            PCG_TPU_COORDINATOR=f"127.0.0.1:{port}", PCG_TPU_NUM_PROCS="2",
            PCG_TPU_PROC_ID=str(rank), **(env_extra or {}))
        log = os.path.join(MP_DIR, f"{mode}{rank}.log")
        logs.append(log)
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _MP_CHILD, MP_DIR, mode], cwd=root,
                env=env, stdout=f, stderr=subprocess.STDOUT))
    return procs, logs


def _mp_wait(procs, logs, tag: str, expect_rc=(0, 0)):
    """Wait for phase 4n's ranks (killing them at ``MP_SPAWN_TIMEOUT_S``);
    returns each rank's ``MP`` JSON records."""
    deadline = time.time() + MP_SPAWN_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for rank, (p, log) in enumerate(zip(procs, logs)):
        text = open(log).read()
        if p.returncode != expect_rc[rank]:
            raise AssertionError(f"multi-process {tag}: rank {rank} exited "
                                 f"{p.returncode}:\n{text[-6000:]}")
        out.append([json.loads(ln[3:]) for ln in text.splitlines()
                    if ln.startswith("MP ")])
    return out


def _mp_configs():
    """Phase 4n's Solver configurations by run, the same in the ranks
    and in this process."""
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig

    return {
        "flagship": RunConfig(solver=SolverConfig(
            tol=1e-7, precision_mode="mixed")),
        "general": RunConfig(solver=SolverConfig(tol=1e-8, max_iter=500)),
        "hybrid": RunConfig(solver=SolverConfig(
            tol=1e-7, precision_mode="mixed")),
    }


def _mp_small_models():
    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.models.octree import make_octree_model

    kw = dict(OCTREE_FLAGSHIP)
    kw.pop("n")
    n = OCTREE_PARITY_N
    return {"general": make_cube_model(6, 4, 4, heterogeneous=True),
            "hybrid": make_octree_model(n, n, n, **kw)}


def _mp_newmark(model, mesh=None, device=None):
    from pcg_mpi_solver_tpu_torch import RunConfig, SolverConfig
    from pcg_mpi_solver_tpu_torch.solver import NewmarkSolver

    nm = NewmarkSolver(model, RunConfig(solver=SolverConfig(
        tol=1e-10, max_iter=1000, precond="block3")), n_parts=MP_PARTS,
        dt=0.2, damping=0.1, mesh=mesh, device=device)
    res = nm.run([0.5, 1.0, 1.0])
    return ([r.flag for r in res], [r.iters for r in res],
            float(abs(nm.state_global()[0]).sum()))


def _mp_kill_config(scratch):
    from pcg_mpi_solver_tpu_torch import (
        RunConfig, SolverConfig, TimeHistoryConfig)

    return RunConfig(scratch_path=scratch, run_id="kill", snapshot_every=1,
                     flight_path=os.path.join(scratch, "flight.jsonl"),
                     solver=SolverConfig(tol=1e-8, max_iter=2000,
                                         iters_per_dispatch=25),
                     time_history=TimeHistoryConfig(
                         time_step_delta=[0.0, 1.0]))


def multiprocess_child(out_dir: str, mode: str) -> int:
    """One rank of phase 4n (``_MP_CHILD``).  ``main``: the flagship over
    the group, then the small parity runs; ``kill``: the kill drill.
    Each result is a line ``MP {json}``."""
    import numpy as np
    import torch

    from pcg_mpi_solver_tpu_torch.models import make_cube_model
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.parallel.distributed import (
        init_distributed, make_global_mesh)
    from pcg_mpi_solver_tpu_torch.resilience import (
        DeadPeerError, SimulatedKill)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    torch.backends.cuda.matmul.allow_tf32 = False
    rank = init_distributed()
    mesh = make_global_mesh()
    grp = mesh.group

    def emit(**kw):
        print("MP " + json.dumps(dict(rank=rank, **kw)), flush=True)

    if mode == "kill":
        model = make_cube_model(16, 8, 8, heterogeneous=True)
        cfg = _mp_kill_config(os.path.join(out_dir, "kill"))
        s = Solver(model, cfg, n_parts=MP_PARTS, mesh=mesh,
                   backend="general")
        t0 = time.perf_counter()
        try:
            res = s.solve()[-1]
            emit(outcome="done", flag=res.flag)
            return 0
        except SimulatedKill:
            # the wall clock, shared by both ranks on this host: rank 0's
            # detection is its own raise less this instant
            emit(outcome="killed", ckpt=cfg.checkpoint_path, t=time.time())
            sys.stdout.flush()
            os._exit(0)
        except DeadPeerError as e:
            emit(outcome="deadpeer", waited=time.perf_counter() - t0,
                 t=time.time(), msg=str(e))
            sys.stdout.flush()
            os._exit(0)

    cfgs = _mp_configs()
    kw = dict(FLAGSHIP)
    nx = kw.pop("nx")
    t0 = time.perf_counter()
    model = make_cube_model(nx, **kw)
    t1 = time.perf_counter()
    s = Solver(model, cfgs["flagship"], n_parts=MP_PARTS, mesh=mesh)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grp.reset_counts()
    reset_launch_counts()
    res = s.solve()[-1]
    torch.cuda.synchronize()
    launches = {f"{v} {d}": n for (v, d), n in LAUNCHES.items() if n}
    counts = dict(grp.counts)
    wait_s = grp.wait_s
    u = s.displacement_global()
    if rank == 0:
        np.save(os.path.join(out_dir, "flagship_u.npy"), u)
    emit(run="flagship", flag=res.flag, iters=res.iters,
         relres=float(res.relres), wall=res.wall_s,
         ms_iter=res.wall_s / res.iters * 1e3, backend=s.backend,
         parts=list(s._part_range), device=str(s.device),
         cap=s._dispatch_cap, model_s=t1 - t0, setup_s=t2 - t1,
         partition_s=s.partition_build_s, counts=counts, wait_s=wait_s,
         launches=launches, u_sum=float(np.abs(u).sum()))
    del s, u
    torch.cuda.empty_cache()
    for name, model in _mp_small_models().items():
        s = Solver(model, cfgs[name], n_parts=MP_PARTS, mesh=mesh,
                   backend=name)
        reset_launch_counts()
        r = s.step(1.0)
        u = s.displacement_global()
        emit(run=name, flag=r.flag, iters=r.iters, relres=float(r.relres),
             u_max=float(np.abs(u).max()),
             launches={f"{v} {d}": n for (v, d), n in LAUNCHES.items()
                       if n})
        if rank == 0:
            np.save(os.path.join(out_dir, f"{name}_u.npy"), u)
        if name == "general":
            flags, iters, cs = _mp_newmark(model, mesh=mesh)
            emit(run="newmark", flags=flags, iters=iters, cs=cs)
    return 0


def phase_multiprocess(torch, np, flagship_model):
    """Phase 4n (module docstring).  Returns {rank: launch counts} of the
    two-rank flagship solve."""
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import (
        LAUNCHES, reset_launch_counts)
    from pcg_mpi_solver_tpu_torch.solver import Solver

    shutil.rmtree(MP_DIR, ignore_errors=True)
    os.makedirs(MP_DIR)
    cfgs = _mp_configs()
    procs, logs = _mp_spawn("main")
    try:
        # this process's MP_PARTS-part flagship, built while the ranks
        # build theirs (host work), solved after they finish (the card)
        t0 = time.perf_counter()
        one = Solver(flagship_model, cfgs["flagship"], n_parts=MP_PARTS)
        if one.backend != "structured":
            raise AssertionError(f"multi-process: {MP_PARTS} parts put "
                                 f"the flagship on the {one.backend} "
                                 f"backend")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    except BaseException:
        for p in procs:
            p.kill()
        raise
    ranks = _mp_wait(procs, logs, "main")
    by = [{rec["run"]: rec for rec in recs} for recs in ranks]
    f0, f1 = by[0]["flagship"], by[1]["flagship"]
    for rank, f in enumerate((f0, f1)):
        say(f"multi-process: rank {rank} on {f['device']} parts "
            f"{f['parts']}: model {f['model_s']:.2f} s, setup "
            f"{f['setup_s']:.2f} s (partition {f['partition_s']:.2f} s); "
            f"flag {f['flag']}, iterations {f['iters']}, relres "
            f"{f['relres']:.4e}, {f['ms_iter']:.4f} ms/iter "
            f"({f['wall']:.3f} s), cap {f['cap']}; collectives "
            f"{f['counts']}, {f['wait_s']:.3f} s in them; launches "
            f"{f['launches']}")
    same = {k: f0[k] for k in ("flag", "iters", "relres", "u_sum")}
    if same != {k: f1[k] for k in same}:
        raise AssertionError(f"multi-process: the ranks disagree: {f0} "
                             f"vs {f1}")
    c = f0["counts"]
    mv = f0["launches"].get("v6 float32", 0) \
        + f0["launches"].get("v6 float64", 0)
    say(f"multi-process: per iteration {c['all_reduce'] / f0['iters']:.3f} "
        f"all-reduces, {c['halo'] / f0['iters']:.3f} plane exchanges "
        f"({c['halo_msgs']} messages); {c['halo_bytes'] / max(c['halo'], 1):.0f}"
        f" halo bytes a matvec from rank 0; {mv} v6 launches on rank 0")
    if c["halo"] < mv or f0["launches"].get("v6 float32", 0) < f0["iters"]:
        raise AssertionError("multi-process: the flagship did not run v6 "
                             "under the halo exchange")
    reset_launch_counts()
    r1 = one.solve()[-1]
    torch.cuda.synchronize()
    one_launches = {f"{v} {d}": n for (v, d), n in LAUNCHES.items() if n}
    say(f"multi-process: one process, {MP_PARTS} parts: build "
        f"{build_s:.2f} s; flag {r1.flag}, iterations {r1.iters}, relres "
        f"{r1.relres:.4e}, {r1.wall_s / r1.iters * 1e3:.4f} ms/iter "
        f"({r1.wall_s:.3f} s); launches {one_launches}")
    if f0["flag"] != 0 or r1.flag != 0:
        raise AssertionError("multi-process: the flagship did not converge")
    if abs(f0["iters"] - r1.iters) > 1:
        raise AssertionError(f"multi-process: {f0['iters']} iterations "
                             f"against one process's {r1.iters}")
    if abs(f0["iters"] - JAX_FLAGSHIP_ITERS) > ITERS_TOL * JAX_FLAGSHIP_ITERS:
        raise AssertionError(f"multi-process: {f0['iters']} iterations, not "
                             f"within {ITERS_TOL:.0%} of "
                             f"{JAX_FLAGSHIP_ITERS}")
    u1 = one.displacement_global()
    u2 = np.load(os.path.join(MP_DIR, "flagship_u.npy"))
    diff = float(np.abs(u2 - u1).max() / np.abs(u1).max())
    say(f"multi-process: u of two ranks against one process: "
        f"{diff:.3e} of max|u| (tolerance {MP_U_TOL:g})")
    if not np.isfinite(u2).all() or diff > MP_U_TOL:
        raise AssertionError("multi-process: u disagrees")
    del one, u1, u2
    torch.cuda.empty_cache()
    # the small parity runs: the same configurations in this process
    for name, model in _mp_small_models().items():
        got0, got1 = by[0][name], by[1][name]
        s = Solver(model, cfgs[name], n_parts=MP_PARTS, backend=name)
        reset_launch_counts()
        r = s.step(1.0)
        u = s.displacement_global()
        ur = np.load(os.path.join(MP_DIR, f"{name}_u.npy"))
        d = float(np.abs(ur - u).max() / np.abs(u).max())
        say(f"multi-process {name}: two ranks flag {got0['flag']}, "
            f"iterations {got0['iters']} (rank 1 {got1['iters']}), relres "
            f"{got0['relres']:.4e}, launches {got0['launches']}; one "
            f"process flag {r.flag}, iterations {r.iters}; u differs by "
            f"{d:.3e} of max|u|")
        if (got0 != dict(got1, rank=0) or got0["flag"] != 0 or r.flag != 0
                or abs(got0["iters"] - r.iters) > 1 or d > MP_U_TOL):
            raise AssertionError(f"multi-process {name}: parity failed")
        if name == "hybrid" and not got0["launches"].get("v6 float32"):
            raise AssertionError("multi-process hybrid: no v6 launch")
        if name == "general":
            flags, iters, cs = _mp_newmark(model)
            nm0, nm1 = by[0]["newmark"], by[1]["newmark"]
            say(f"multi-process newmark: two ranks flags {nm0['flags']} "
                f"iterations {nm0['iters']} cs {nm0['cs']:.12e}; one "
                f"process flags {flags} iterations {iters} cs {cs:.12e}")
            if (nm0 != dict(nm1, rank=0) or set(flags) != {0}
                    or set(nm0["flags"]) != {0}
                    or not np.isclose(nm0["cs"], cs, rtol=1e-9)):
                raise AssertionError("multi-process newmark: parity failed")
    # the kill drill, then the elastic resume here
    procs, logs = _mp_spawn("kill", {
        "PCG_TPU_COLLECTIVE_DEADLINE_S": str(MP_DEADLINE_S),
        "PCG_TPU_FLIGHT_HEARTBEAT_S": "0.2",
        "PCG_TPU_FAULTS": "kill@rank:1:2"})
    kill = _mp_wait(procs, logs, "kill")
    k0, k1 = kill[0][-1], kill[1][-1]
    if k1["outcome"] != "killed" or k0["outcome"] != "deadpeer":
        raise AssertionError(f"multi-process kill drill: rank 0 {k0}, "
                             f"rank 1 {k1}")
    detect = k0["t"] - k1["t"]
    say(f"multi-process kill drill: rank 1 killed; rank 0 raised "
        f"DeadPeerError {detect:.3f} s after the kill (deadline "
        f"{MP_DEADLINE_S:g} s, margin {MP_DEADLINE_S - detect:.3f} s; "
        f"{k0['waited']:.2f} s into its solve): {k0['msg']}")
    if ("suspected dead peer: process 1" not in k0["msg"]
            or detect > MP_DEADLINE_S):
        raise AssertionError("multi-process kill drill: no dead peer named "
                             "within the deadline")
    import glob as _glob

    epochs = _glob.glob(os.path.join(k1["ckpt"], "snap_COMMIT_e*.json"))
    if not epochs:
        raise AssertionError("multi-process kill drill: no committed epoch")
    from pcg_mpi_solver_tpu_torch.models import make_cube_model

    model = make_cube_model(16, 8, 8, heterogeneous=True)
    ref = Solver(model, _mp_kill_config(os.path.join(MP_DIR, "ref")),
                 n_parts=MP_PARTS, backend="general").solve()[-1]
    el = Solver(model, _mp_kill_config(os.path.join(MP_DIR, "el")),
                n_parts=MP_PARTS, backend="general")
    got = el.resume_elastic(k1["ckpt"])[-1]
    say(f"multi-process elastic resume onto one process from "
        f"{len(epochs)} committed epoch(s): flag {got.flag}, iterations "
        f"{got.iters} (uninterrupted: flag {ref.flag}, {ref.iters}); "
        f"elastic_resume events "
        f"{el.recorder.counters.get('resilience.elastic_resume', 0)}")
    if (got.flag != ref.flag or abs(got.iters - ref.iters) > 1
            or not el.recorder.counters.get("resilience.elastic_resume")):
        raise AssertionError("multi-process: the elastic resume failed")
    shutil.rmtree(MP_DIR, ignore_errors=True)
    return {rank: {tuple(k.split()): n for k, n in recs[0]["launches"].items()}
            | {("v6", d): recs[0]["launches"].get(f"v6 {d}", 0)
               for d in ("float32", "float64")}
            for rank, recs in enumerate(ranks)}


def phase_lint(torch, np):
    """Phase 4o (module docstring).  Returns {trip kind: v6 float32
    launches} of the structured float32 program on rank 0."""
    from pcg_mpi_solver_tpu_torch.analysis import engine
    from pcg_mpi_solver_tpu_torch.analysis import programs as ap
    from pcg_mpi_solver_tpu_torch.analysis.rules_trip import (
        check_hot_loop_purity)

    t0 = time.perf_counter()
    report = engine.run_lint(fast=True, device="cuda")
    for line in report.render().splitlines():
        say(f"lint: {line}")
    if report.exit_code != 0:
        raise AssertionError(f"lint: exit {report.exit_code} on the card")
    progs = ap.build_programs(fast=True, device="cuda")    # recorded above
    ap.print_counts(progs, say)
    say(f"lint: {len(progs)} programs recorded by two ranks, "
        f"{time.perf_counter() - t0:.1f} s")
    launches = {}
    for p in progs:
        if p.backend != "structured":
            continue
        for kind, trip in p.trips.items():
            n = trip.launches().get("v6 float32", 0)
            if n != p.launches[kind] or n < 1:
                raise AssertionError(
                    f"lint: {p.name} rank {p.rank} {kind}: {n} v6 f32 "
                    f"launches, {p.launches[kind]} declared")
            if p.rank == 0 and p.role == "f32":
                launches[kind] = n
    if not launches:
        raise AssertionError("lint: no structured float32 program ran")
    # the seeded violation: one more host read a trip, through the probe
    # hook, on a one-process two-part general Solver on the card
    spec = dict(backend="general", variant="classic", nrhs=1, role="f64",
                precond="jacobi")
    s = ap.build_solver("general", device="cuda", n_parts=2)
    seeded = ap.record_program(s, spec, inject_read=True)
    found = check_hot_loop_purity(seeded)
    if not found:
        raise AssertionError("lint: the seeded extra _read did not fire")
    say(f"lint: seeded extra _read fired: {found[0]}")
    return launches


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

    # the octree models, built beside phases 3 and 4e's cube
    octrees = OctreeModels((OCTREE_FLAGSHIP["n"], OCTREE_PARITY_N))
    # and phase 4l's capture child, which builds its flagship Solver
    # beside them and then waits, idle, for 4l
    capture = CaptureChild()
    try:
        capture.start()
        return _phases(torch, np, kind, smi, rates, t_start, octrees,
                       capture)
    finally:
        capture.close()
        octrees.close()


def _phases(torch, np, kind, smi, rates, t_start, octrees,
            capture) -> int:
    """Phases 3 to 5 and the closing records (see the module docstring)."""
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        say(f"phase {name}: {now - clock[0]:.1f} s")
        clock[0] = now

    # 3. kernels against their plain versions
    kern = phase_kernels(torch, np, rates)
    lap("3 kernels")
    from pcg_mpi_solver_tpu_torch.models import make_cube_model

    kw = dict(FLAGSHIP)
    nx = kw.pop("nx")
    t0 = time.perf_counter()
    flagship_model = make_cube_model(nx, **kw)
    say(f"main: cube {nx}^3, {flagship_model.n_dof} dofs; model build "
        f"{time.perf_counter() - t0:.2f} s")
    # 4g. the chunked blocked path, before any profiler window, and
    # first: it needs no octree, so it runs while the octree flagship's
    # child builds (4e waited ~30 s for it when 4g ran after 4k)
    many_chunked_launches = phase_many_chunked(torch, np, flagship_model)
    lap("4g many chunked")
    # 4e. the general (pattern-type) backend: the flagship cube and the
    # octree flagship, before any profiler window; its octree Solvers
    # start the scratch partition cache cold
    shutil.rmtree(CACHE_DIR, ignore_errors=True)
    general = phase_general(torch, np, flagship_model, octrees)
    lap("4e general")
    # 4h. the hybrid level-grid backend on 4e's octree model, before any
    # profiler window
    hybrid = phase_hybrid(torch, np, general, rates, octrees)
    general["hybrid"] = hybrid["solver"]
    lap("4h hybrid")
    # 4j. the time integrators on 4e's octree model, before any profiler
    # window
    time_launches = phase_time(torch, np, octrees)
    lap("4j time")
    # 4k. the native graph partition and the partition cache on 4e's
    # octree model and Solvers, then the scratch cache goes
    graph_launches = phase_graph_cache(torch, np, general, octrees)
    del general["model"]
    shutil.rmtree(CACHE_DIR, ignore_errors=True)
    lap("4k graph cache")
    # 4. main path at full size, once per float32 variant
    launches_by, classic = phase_main(torch, np, flagship_model)
    lap("4 main")
    # 4i. the export path on the solvers of phases 4, 4e and 4h, the
    # windows at the flagship, the CLI
    phase_export(torch, np, classic.pop("solver"), general, flagship_model)
    lap("4i export")
    # 4b. the block3 and mg preconditioners at full size
    precond_launches, precond_iters, models = phase_preconditioners(
        torch, np, flagship_model)
    lap("4b preconditioners")
    # 4c. the fused and pipelined PCG variants at full size
    classic_iters = dict(precond_iters)
    classic_iters[(FLAGSHIP["nx"], "jacobi")] = classic["iters"]
    variant_launches = phase_variants(torch, np, models, classic_iters,
                                      classic["profile"])
    lap("4c variants")
    # 4d. blocked right-hand sides at full size
    many_launches, serve_inputs = phase_many(torch, np, models,
                                             classic_iters,
                                             classic["profile"])
    del models
    lap("4d many")
    # 4m. the solve service on 4d's flagship Solver
    serve_launches = phase_serve(torch, np, serve_inputs)
    del serve_inputs
    lap("4m serve")
    # 4e's kernel counts and profile, after every other profiled window
    phase_general_profile(torch, general, classic["ms_iter"])
    del general
    lap("4e profile")
    # 4f. the chunked path's ladder, snapshots and resume (its flagship
    # case ran in phase 4)
    resilience_launches = phase_resilience(torch, np)
    lap("4f resilience")
    # 5. direct f64 and card-vs-cpu checks
    phase_checks(torch, np)
    lap("5 checks")
    # 4n. the multi-process path: the flagship over two ranks, the
    # small parity solves, the kill drill and the elastic resume
    mp_launches = phase_multiprocess(torch, np, flagship_model)
    lap("4n multi-process")
    # 4l. observability on the flagship, after every timed solve a
    # profiler window could slow (its capture comes last)
    phase_telemetry(torch, np, flagship_model, capture)
    del flagship_model
    lap("4l telemetry")
    # 4o. the contract lint on the card, last (its recordings run under
    # torch.profiler)
    lint_launches = phase_lint(torch, np)
    lap("4o lint")

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
            # phase 4h: the flagship octree's level batches (one launch a
            # level), and the hybrid solve's launches
            records[-1]["hybrid_levels"] = hybrid["levels"][(variant,
                                                             dtype)]
            records[-1]["launches_hybrid"] = \
                hybrid["launches"][(variant, dtype)]
            # phase 4j: the Newmark runs and the explicit runs
            records[-1]["launches_newmark"] = \
                time_launches[0].get((variant, dtype), 0)
            records[-1]["launches_dynamics"] = \
                time_launches[1].get((variant, dtype), 0)
            # phase 4k: the 8-part graph-partitioned hybrid solve
            records[-1]["launches_graph"] = \
                graph_launches.get((variant, dtype), 0)
            # phase 4m: the flagship daemon's blocks
            records[-1]["launches_serve"] = \
                serve_launches.get((variant, dtype), 0)
            if variant == "v6":
                records[-1]["launches_preconditioners"] = {
                    path: counts[("v6", dtype)]
                    for path, counts in precond_launches.items()}
                records[-1]["launches_variants"] = {
                    path: counts[("v6", dtype)]
                    for path, counts in variant_launches.items()}
                records[-1]["launches_many"] = {
                    path: counts[("v6", dtype)]
                    for path, counts in many_launches.items()}
                records[-1]["launches_resilience_escalation"] = \
                    resilience_launches[("v6", dtype)]
                records[-1]["launches_many_chunked"] = \
                    many_chunked_launches[("v6", dtype)]
                records[-1]["launches_multiprocess"] = {
                    f"rank{r}": n[("v6", dtype)]
                    for r, n in sorted(mp_launches.items())}
                if dtype == "float32":
                    records[-1]["launches_lint"] = lint_launches
                if dtype == "float32":
                    records[-1]["launches_oneshot"] = \
                        classic["oneshot"]["f32"]
    say(f"total: {time.perf_counter() - t_start:.1f} s")
    say(smi)
    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
