#!/usr/bin/env python3
"""Compare the port's v9 structured-matvec kernel with its earlier source,
with other builds of it, and with the v6 float, v1 and v5 kernels on one
NVIDIA card, and test one model of instruction issue across them.

Run from the repository root, on a machine with the card and nvcc:

    git show c247ccc:pcg_mpi_solver_tpu_torch/csrc/structured_matvec_v9.cu \\
        > build/v9_pr7.cu              # v9 before its redesign
    python3 tools/v9_kernel_compare.py --old build/v9_pr7.cu --sweep \\
        --flagship

Prints, at the flagship slab (1 part, 150^3 cells):
  * v9's error against the float64 plain version (max, rms and mean, over
    max|y|) and against the float32 plain version (2e-5 x max|y|), whether
    two launches give the same bits, and, with --old, whether it gives the
    old kernel's values at the card tests' shapes and at 150^3;
  * CUDA-event times with L2 flushed, in turns (v9, old v9, v6 float, v1,
    v5 at PCG_TPU_PALLAS_PLANES, then the reverse order), each launched
    through its C entry point;
  * with --sweep, builds of this source at other strip heights and cells
    a thread (-DV9_ROWS, -DV9_CELLS), each checked against the shipped
    build and timed in turns with it;
  * each build's registers and spills (ptxas), and the SASS instruction
    mix (cuobjdump, static counts) of the loop that holds each kernel's
    FFMAs: FFMA, LDS, SHFL, ULDC, integer, BAR, instructions per FFMA;
  * the issue model: (instructions per FFMA of that loop) x (FFMA floor /
    measured time), the FFMA floor being the FMAs the kernel executes at
    this slab (its recomputed cells and idle lanes counted) at 33.5e12
    FMA/s, the 67 TFLOP/s of the CUDA cores.  Near 1 the schedulers are
    busy issuing for the whole kernel;
  * the cycles of an SM's shared-memory pipe that a warp's shared load
    or shuffle takes, measured by tools/smem_probe.cu, and a shared-memory
    model beside the issue model: the loop's shared loads and shuffles
    priced at those cycles, per FFMA x 4 x FFMA floor / time, near 1 if
    that pipe is what the kernel waits on;
  * with --flagship, the 150^3 mixed solve under v9 and then v6, each with
    flag, iterations, relres, inner cycles and ms/iter.
--old takes a source with the old kernel's C interface (P, nx, ny, nz,
planes, device); it runs at 8 planes.  Builds go to build/v9_compare/.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from kernel_builds import (  # noqa: E402
    CSRC, build, flagship, load, loop_body, mix_line, nvidia_smi,
    opcode_counts, sass_functions, shared_widths, smem_probe, time_ms)

OUT = ROOT / "build" / "v9_compare"
N = 150
OLD_PLANES = 8
# builds of --sweep: tag -> defines (the shipped build: V9_ROWS 6,
# V9_CELLS 2)
SWEEP = {"rows8": ("-DV9_ROWS=8",),
         "rows4": ("-DV9_ROWS=4",),
         "cells1": ("-DV9_CELLS=1",),
         "cells3": ("-DV9_CELLS=3",),
         "rows4_cells4": ("-DV9_ROWS=4", "-DV9_CELLS=4"),
         "rows8_cells4": ("-DV9_ROWS=8", "-DV9_CELLS=4")}
# the card tests' shapes (tests/test_torch_cuda.py) and the flagship slab
SHAPES = ((1, 7, 3, 5), (2, 6, 5, 4), (1, 1, 1, 1), (2, 33, 17, 9),
          (2, 40, 37, 70), (1, 20, 70, 40), (2, 9, 79, 61),
          (1, 30, 39, 30), (1, 100, 200, 200), (1, N, N, N))
SASS_KEYS = ("FFMA", "FMUL", "FADD", "LDS", "LDG", "LDGSTS", "STG", "SHFL",
             "ULDC", "LDC", "MOV", "BAR", "LDL", "STL")
FMA_RATE = 67e12 / 2        # FMA/s of the CUDA cores (H100 SXM data sheet)


def fmas_v9(shape, geo) -> int:
    """FMAs the v9 kernel executes: each block's warps with a node row on
    the grid, rows x 32 lanes, 576 a cell, every cell plane of its segment
    that is on the grid."""
    from pcg_mpi_solver_tpu_torch.ops.structured_matvec import V9_WARPS
    P, nx, ny, nz = shape
    cells = 0
    for seg in range(geo.n_seg):
        x0 = seg * geo.seg_len
        x_end = min(x0 + geo.seg_len, nx + 1)
        planes = min(x_end, nx) - max(x0 - 1, 0)
        for ty in range(geo.n_ty):
            live = sum(ty * geo.tile_nodes[0] + w * (geo.rows - 1) < ny + 1
                       for w in range(V9_WARPS))
            cells += live * geo.rows * 32 * planes * geo.n_tz
    return 576 * P * cells


def fmas_v9_old(shape, planes=OLD_PLANES) -> int:
    """FMAs the earlier v9 kernel executes: 8 x 32 threads a block, one cell
    each, every cell plane of its segment (2 planes - 1 node planes) on
    the grid."""
    P, nx, ny, nz = shape
    C = max(1, min(planes, nx + 1))
    seg_len = 2 * C - 1
    n_ty, n_tz = -(-(ny + 1) // 7), -(-(nz + 1) // 31)
    cells = 0
    for x0 in range(0, nx + 1, seg_len):
        x_end = min(x0 + seg_len, nx + 1)
        cells += 256 * (min(x_end, nx) - max(x0 - 1, 0))
    return 576 * P * n_ty * n_tz * cells


def fmas_v6(shape, geo) -> int:
    """FMAs v6 float executes: 32 x 32 cells a block, every step of its
    segment (seg_len + 1 cell planes)."""
    P, nx, ny, nz = shape
    steps = sum(min(x0 + geo.seg_len, nx + 1) - x0 + 1
                for x0 in range(0, nx + 1, geo.seg_len))
    return 576 * 1024 * P * geo.n_ty * geo.n_tz * steps


def fmas_v5(shape, geo) -> int:
    """FMAs v5 executes: 16 x rows threads a block, two nodes a thread,
    576 (+24 scale) a node and output plane of its segment."""
    P, nx, ny, nz = shape
    steps = sum(min(x0 + geo.seg_len, nx + 1) - x0
                for x0 in range(0, nx + 1, geo.seg_len))
    return 600 * 2 * geo.threads * P * geo.n_ty * geo.n_tz * steps


def fmas_v1(shape, sms: int) -> int:
    """FMAs v1 executes: a thread V1_NODES node columns, threads rounded up
    to warps, 576 + 6 (the scales) a node and cell plane, half of that for
    a run's recomputed carry plane and for the carry a run's last plane
    skips (a warp issues the FMAs of missing cells too)."""
    from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv
    P, nx, ny, nz = shape
    g = smv.v1_geometry(P, nx, ny, nz, sms)
    warps = 0.0
    for k in range(g.blocks):
        for tile, s, e in smv.v1_runs(g, k):
            lanes = min(smv.V1_THREADS, g.cols - tile * smv.V1_THREADS)
            cells = min(e, nx) - s + (s > 0) / 2 - (e <= nx) / 2
            warps += -(-lanes // 32) * cells
    return round(582 * smv.V1_NODES * 32 * warps)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, help="the earlier v9 source")
    ap.add_argument("--sweep", action="store_true",
                    help="time builds at other V9_ROWS / V9_CELLS")
    ap.add_argument("--flagship", action="store_true",
                    help="solve the 150^3 flagship under v9 and v6")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("v9_kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    from pcg_mpi_solver_tpu_torch.models.element import unit_element_library
    from pcg_mpi_solver_tpu_torch.ops import kernels
    from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv

    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    names = ["structured_matvec_v9", "structured_matvec",
             "structured_matvec_v1", "structured_matvec_v5"]
    for name, rep in kernels.build_kernels(names).items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")
    libs = {"v9": (kernels.library_path("structured_matvec_v9"),
                   smv._library("v9")),
            "v6": (kernels.library_path("structured_matvec"),
                   smv._library("v6")),
            "v1": (kernels.library_path("structured_matvec_v1"),
                   smv._library("v1")),
            "v5": (kernels.library_path("structured_matvec_v5"),
                   smv._library("v5"))}
    sweep = {}
    with concurrent.futures.ThreadPoolExecutor() as pool:
        old = None if args.old is None else pool.submit(build, args.old,
                                                        OUT, "old")
        jobs = {} if not args.sweep else {
            tag: pool.submit(build, CSRC / "structured_matvec_v9.cu", OUT,
                             tag, defines)
            for tag, defines in SWEEP.items()}
        if old is not None:
            path = old.result()
            libs["old"] = (path, load(path, "structured_matvec_v9", ("f32",),
                                      6))
        for tag, job in jobs.items():
            path = job.result()
            sweep[tag] = (path, load(path, "structured_matvec_v9", ("f32",),
                                     9))
    print(f"shared memory v9: "
          f"{libs['v9'][1].structured_matvec_v9_smem_bytes()} B a block")

    Ke = unit_element_library(0.2)["Ke"]
    K = torch.as_tensor(Ke, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    for tag in ("v9", "old"):
        if tag in libs:
            libs[tag][1].structured_matvec_v9_stage_f32(K.data_ptr(), 0,
                                                        stream)
    libs["v6"][1].structured_matvec_stage_f32(K.data_ptr(), 0, stream)
    libs["v1"][1].structured_matvec_v1_stage_f32(K.data_ptr(), 0, stream)
    libs["v5"][1].structured_matvec_v5_stage_f32(K.data_ptr(), 0, stream)
    for _path, h in sweep.values():
        h.structured_matvec_v9_stage_f32(K.data_ptr(), 0, stream)

    def data(shape):
        P, nx, ny, nz = shape
        x = torch.as_tensor(rng.standard_normal((P, 3, nx + 1, ny + 1,
                                                 nz + 1)),
                            dtype=torch.float32, device="cuda")
        ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                             dtype=torch.float32, device="cuda")
        return x, ck

    def launcher(fn, x, ck, shape, extra):
        P, nx, ny, nz = shape
        y = torch.empty_like(x)

        def run():
            err = fn(x.data_ptr(), ck.data_ptr(), y.data_ptr(), P, nx, ny,
                     nz, *extra, 0, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
            return y
        return run

    def v9_run(h, x, ck, shape, rows=smv.V9_ROWS):
        g = smv.v9_geometry(*shape, sms, rows=rows)
        return launcher(h.structured_matvec_v9_f32, x, ck, shape,
                        (g.seg_len, g.n_ty, g.n_tz, g.n_seg))

    # v9 against the old kernel's values at every shape
    if "old" in libs:
        verdicts = []
        for s in SHAPES:
            x, ck = data(s)
            new = v9_run(libs["v9"][1], x, ck, s)()
            old_y = launcher(libs["old"][1].structured_matvec_v9_f32, x, ck,
                             s, (OLD_PLANES,))()
            verdicts.append(f"{s} "
                            f"{'same' if torch.equal(new, old_y) else 'DIFFERENT'}")
            del x, ck
        print(f"v9 values against the old kernel's: {'; '.join(verdicts)}")

    shape = (1, N, N, N)
    x, ck = data(shape)
    y_ref = smv.structured_matvec_plain(x.double(), ck.double(), K.double())
    y32 = smv.structured_matvec_plain(x, ck, K)
    scale = y_ref.abs().max().item()
    g9 = smv.v9_geometry(*shape, sms)
    g6 = smv.v6_geometry(*shape, torch.float32, sms)
    runs = {"v9": v9_run(libs["v9"][1], x, ck, shape)}
    if "old" in libs:
        runs["old"] = launcher(libs["old"][1].structured_matvec_v9_f32, x,
                               ck, shape, (OLD_PLANES,))
    runs["v6"] = launcher(libs["v6"][1].structured_matvec_f32, x, ck, shape,
                          (g6.seg_len, g6.n_ty, g6.n_tz, g6.n_seg))
    runs["v1"] = launcher(libs["v1"][1].structured_matvec_v1_f32, x, ck,
                          shape, smv.launch_args("v1", *shape, torch.float32,
                                                 None, sms))
    g5 = smv.v5_geometry(*shape, smv.pallas_planes(), sms)
    runs["v5"] = launcher(libs["v5"][1].structured_matvec_v5_f32, x, ck,
                          shape, (smv.pallas_planes(), g5.rows, g5.seg_len,
                                  g5.n_ty, g5.n_tz, g5.n_seg))
    print(f"v9 geometry at {N}^3: {g9}")
    for tag, run in runs.items():
        y1 = run().clone()
        same = torch.equal(y1, run())
        e = y1.double() - y_ref
        e32 = (y1 - y32).abs().max().item() / y32.abs().max().item()
        print(f"{tag}: max|err|/max|y| {e.abs().max().item() / scale:.3e} "
              f"(float32 plain {e32:.3e}, tolerance 2e-5), rms "
              f"{e.pow(2).mean().sqrt().item() / scale:.3e}, mean "
              f"{e.mean().item() / scale:.3e}; repeat bitwise "
              f"{'equal' if same else 'DIFFERENT'}")
    order = list(runs) + list(runs)[::-1]
    times = collections.defaultdict(list)
    for tag in order:
        times[tag].append(round(time_ms(torch, runs[tag]), 4))
    print(f"kernel ms at {N}^3, L2 flushed, in turns: {dict(times)}")

    if sweep:
        ref = runs["v9"]().clone()
        srun = {"shipped": runs["v9"]}
        for tag, (_path, h) in sweep.items():
            rows = next((int(d.split("=")[1]) for d in SWEEP[tag]
                         if d.startswith("-DV9_ROWS=")), smv.V9_ROWS)
            run = v9_run(h, x, ck, shape, rows=rows)
            g = smv.v9_geometry(*shape, sms, rows=rows)
            print(f"sweep {tag}: same values as shipped "
                  f"{torch.equal(run(), ref)}; {g.n_ty}x{g.n_tz} tiles, "
                  f"{g.n_seg} segments of {g.seg_len}, {g.blocks} blocks, "
                  f"{h.structured_matvec_v9_smem_bytes()} B")
            srun[tag] = run
        st = collections.defaultdict(list)
        for tag in list(srun) + list(srun)[::-1]:
            st[tag].append(round(time_ms(torch, srun[tag]), 4))
        print(f"sweep ms at {N}^3 in turns: {dict(st)}")
        for tag, (path, _h) in sweep.items():
            code = next(iter(sass_functions(path).values()))
            body = loop_body(code) or code
            print(f"sass sweep {tag} loop: "
                  f"{mix_line(opcode_counts(body), SASS_KEYS)}; "
                  f"{dict(shared_widths(body))}")
    del y_ref, y32
    torch.cuda.empty_cache()

    # SASS of each kernel's hottest loop, the issue model and the
    # shared-memory model
    probe = smem_probe(torch, sms, OUT)
    fmas = {"v9": fmas_v9(shape, g9), "old": fmas_v9_old(shape),
            "v5": fmas_v5(shape, g5),
            "v6": fmas_v6(shape, g6), "v1": fmas_v1(shape, sms)}
    floor_1x = 576 * N ** 3 / FMA_RATE * 1e3
    for tag, (path, _h) in libs.items():
        for name, code in sass_functions(path).items():
            if "Dmma" in name or (tag == "v5"
                                  and f"Li{g5.rows}E" not in name):
                continue             # v6's double kernel, v5's other tiles
            whole = opcode_counts(code)
            body = loop_body(code) or code
            ops = opcode_counts(body)
            print(f"sass {tag} whole kernel: {mix_line(whole, SASS_KEYS)}")
            print(f"sass {tag} loop: {mix_line(ops, SASS_KEYS)}; "
                  f"{dict(shared_widths(body))}")
            ms = statistics.median(times[tag])
            floor = fmas[tag] / FMA_RATE * 1e3
            per = sum(ops.values()) / ops["FFMA"]
            print(f"issue model {tag}: {fmas[tag] / (576 * N ** 3):.3f}x "
                  f"the cells' FMAs, FFMA floor {floor * 1e3:.1f} us "
                  f"({floor_1x * 1e3:.1f} us at 1.0x); {per:.3f} "
                  f"instructions per FFMA x {floor:.4f} / {ms:.4f} ms = "
                  f"{per * floor / ms:.3f} of the kernel's time spent "
                  f"issuing")
            # the shared-memory pipe: the loop's shared loads and shuffles
            # priced at the probe's cycles (v9's, v6's and v5's loops read
            # Ke's 144 float4s once, as broadcasts; their other 16-byte
            # loads are lanes on consecutive words; 64-bit loads and
            # stores are priced as 32-bit lanes)
            w = shared_widths(body)
            n128 = w["LDS.128"]
            bcast = 144 if tag in ("v9", "v6", "v5") else 0
            cyc = (bcast * probe["LDS.128 broadcast"]
                   + (n128 - bcast) * probe["LDS.128 lanes"]
                   + sum(n for k, n in w.items() if k != "LDS.128")
                   * probe["LDS.32 lanes"]
                   + ops["SHFL"] * probe["SHFL.UP"])
            print(f"shared-memory model {tag}: {cyc:.0f} pipe cycles a "
                  f"loop, {cyc / ops['FFMA']:.3f} per FFMA x 4 x "
                  f"{floor:.4f} / {ms:.4f} ms = "
                  f"{4 * cyc / ops['FFMA'] * floor / ms:.3f} of the "
                  f"kernel's time in the shared-memory pipe")

    if args.flagship:
        flagship(torch, ("v9", "v6"))
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
