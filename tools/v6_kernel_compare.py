#!/usr/bin/env python3
"""Compare the port's v6 structured-matvec kernel with other builds of it on
one NVIDIA card: an earlier source, and the same source at other ring
depths; and time it at other x-segment lengths.

Run from the repository root, on a machine with the card and nvcc:

    git show 2e8a00f:pcg_mpi_solver_tpu_torch/csrc/structured_matvec.cu \\
        > build/v6_pr3.cu              # the first v6 kernel (optional)
    python3 tools/v6_kernel_compare.py --old build/v6_pr3.cu --sweep

Prints, at the flagship slab (1 part, 150^3 cells):
  * each build's error against the float64 plain version (max, rms and
    mean, over max|y|) and its CUDA-event time with L2 flushed, the builds
    timed in turns (old, this, depth builds, then the reverse order), each
    launched through its C entry point;
  * with --sweep, builds of this source at ring depths 2, 3 and 4
    (-DV6_STAGES_F32 / -DV6_STAGES_F64) in those turns, and this build's
    time at other segment lengths (the wrapper's choice named);
  * each build's registers, spills and shared memory, and its SASS
    instruction mix (cuobjdump, static counts per kernel).
--old takes a source with the first kernel's C interface (P, nx, ny, nz,
device).  Builds go to build/v6_compare/.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from kernel_builds import (  # noqa: E402
    CSRC, build, load, nvidia_smi, sass_mix, time_ms)

OUT = ROOT / "build" / "v6_compare"
N = 150
DEPTHS = (2, 3, 4)
SASS_KEYS = ("FFMA", "DFMA", "HMMA", "DMMA", "LDG", "LDGSTS", "LDS", "STS",
             "STG", "ULDC", "LDC")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, help="an earlier v6 source")
    ap.add_argument("--sweep", action="store_true",
                    help="time ring depths and segment lengths")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("v6_kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    from pcg_mpi_solver_tpu_torch.models.element import unit_element_library
    from pcg_mpi_solver_tpu_torch.ops import kernels
    from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv

    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    kernels.build_kernels(["structured_matvec"])
    libs = {"this": (kernels.library_path("structured_matvec"),
                     smv._library("v6"))}
    src = CSRC / "structured_matvec.cu"
    jobs = {}
    with concurrent.futures.ThreadPoolExecutor() as pool:
        if args.old is not None:
            jobs["old"] = pool.submit(build, args.old, OUT, "old")
        for d in DEPTHS if args.sweep else ():
            jobs[f"depth{d}"] = pool.submit(
                build, src, OUT, f"depth{d}",
                (f"-DV6_STAGES_F32={d}", f"-DV6_STAGES_F64={d}"))
        for tag, job in jobs.items():
            libs[tag] = (job.result(), load(
                job.result(), "structured_matvec", ("f32", "f64"),
                5 if tag == "old" else 9))
    for tag, (_path, h) in libs.items():
        if tag != "old":
            h.structured_matvec_smem_bytes.argtypes = [ctypes.c_int]
            h.structured_matvec_smem_bytes.restype = ctypes.c_longlong
            print(f"shared memory {tag}: float "
                  f"{h.structured_matvec_smem_bytes(4)} B, double "
                  f"{h.structured_matvec_smem_bytes(8)} B")

    Ke = unit_element_library(0.2)["Ke"]
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    for dtype, sfx, default in ((torch.float32, "f32", 3),
                                (torch.float64, "f64", 4)):
        K = torch.as_tensor(Ke, dtype=dtype, device="cuda")
        xd = torch.as_tensor(rng.standard_normal((1, 3, N + 1, N + 1,
                                                  N + 1)), device="cuda")
        ckd = torch.as_tensor(rng.uniform(1, 10, (1, N, N, N)),
                              device="cuda")
        x, ck = xd.to(dtype), ckd.to(dtype)
        y_ref = smv.structured_matvec_plain(x.double(), ck.double(),
                                            K.double())
        scale = y_ref.abs().max().item()
        geo = smv.v6_geometry(1, N, N, N, dtype)
        grid = (geo.n_ty, geo.n_tz)
        runs = {}
        for tag, (_path, h) in libs.items():
            if tag == f"depth{default}":
                continue               # the same build as this
            getattr(h, f"structured_matvec_stage_{sfx}")(K.data_ptr(), 0,
                                                         stream)
            fn = getattr(h, f"structured_matvec_{sfx}")
            extra = () if tag == "old" else (geo.seg_len, *grid, geo.n_seg)
            y = torch.empty_like(x)

            def run(fn=fn, y=y, extra=extra):
                err = fn(x.data_ptr(), ck.data_ptr(), y.data_ptr(), 1,
                         N, N, N, *extra, 0, stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
                return y
            e = run().double() - y_ref
            print(f"{sfx} {tag}: max|err|/max|y| "
                  f"{e.abs().max().item() / scale:.3e}, rms "
                  f"{e.pow(2).mean().sqrt().item() / scale:.3e}, mean "
                  f"{e.mean().item() / scale:.3e}")
            runs[tag] = run
        order = list(runs) + list(runs)[::-1]
        times = collections.defaultdict(list)
        for tag in order:
            times[tag].append(round(time_ms(torch, runs[tag]), 4))
        print(f"{sfx} kernel ms at {N}^3, L2 flushed, in turns (this = "
              f"depth {default}): {dict(times)}")
        if args.sweep:
            fn = getattr(libs["this"][1], f"structured_matvec_{sfx}")
            y = torch.empty_like(x)
            segs = {}
            for seg in (8, 11, 13, 16, 19, 22, 26, 31, 38, 51, 76):
                a = (seg, *grid, -(-(N + 1) // seg))
                segs[seg] = round(time_ms(torch, lambda a=a: fn(
                    x.data_ptr(), ck.data_ptr(), y.data_ptr(), 1, N, N, N,
                    *a, 0, stream)), 4)
            print(f"{sfx} segment length (chosen {geo.seg_len}): {segs}")
        del x, ck, xd, ckd, y_ref
        torch.cuda.empty_cache()

    for tag, (path, _h) in libs.items():
        sass_mix(path, tag, lambda name: " double"
                 if "IdE" in name or "LayoutId" in name else " float",
                 SASS_KEYS)
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
