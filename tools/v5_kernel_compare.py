#!/usr/bin/env python3
"""Compare the port's v5 structured-matvec kernel with other builds of it on
one NVIDIA card: an earlier source, and the same source under other
compile-time switches; and time it at other tile heights.

Run from the repository root, on a machine with the card and nvcc:

    git show a2d9635:pcg_mpi_solver_tpu_torch/csrc/structured_matvec_v5.cu \\
        > build/v5_pr3.cu              # PR 3's v5 kernel (optional)
    python3 tools/v5_kernel_compare.py --old build/v5_pr3.cu \\
        --build kconst=-DV5_KE_CONST --rows

Prints, at the flagship slab (1 part, 150^3 cells), at 8 and 16 planes:
  * each build's error against the float64 plain version (max, rms and
    mean, over max|y|) and its CUDA-event time with L2 flushed, the builds
    timed in turns (old, this, the --build ones, then the reverse order),
    each launched through its C entry point;
  * with --rows, this build at every tile height that fits (the wrapper's
    choice named);
  * each build's registers, spills and SASS instruction mix (cuobjdump,
    static counts per kernel).
--src TAG=PATH builds another source with this one's C interface (a
variant kept under build/); --old takes a source with PR 3's C interface
(P, nx, ny, nz, planes, device).  Builds go to build/v5_compare/.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from kernel_builds import (  # noqa: E402
    CSRC, build, load, nvidia_smi, sass_mix, time_ms)

OUT = ROOT / "build" / "v5_compare"
N = 150
PLANES = (8, 16)
SASS_KEYS = ("FFMA", "FMUL", "FADD", "MOV", "LDG", "LDGSTS", "LDS", "STS",
             "STG", "ULDC", "LDC", "LDL", "STL", "BAR")


def rows_label(name: str) -> str:
    m = re.search(r"kernelI.*?Li(\d+)E", name)
    return f" rows {m.group(1)}" if m else ""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, help="PR 3's v5 source")
    ap.add_argument("--build", action="append", default=[],
                    metavar="TAG=FLAGS",
                    help="another build of this source with nvcc FLAGS "
                         "(comma-separated)")
    ap.add_argument("--src", action="append", default=[],
                    metavar="TAG=PATH",
                    help="another source with this one's C interface")
    ap.add_argument("--rows", action="store_true",
                    help="time this build at every tile height that fits")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("v5_kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    from pcg_mpi_solver_tpu_torch.models.element import unit_element_library
    from pcg_mpi_solver_tpu_torch.ops import kernels
    from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv

    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    for line in kernels.build_kernels(["structured_matvec_v5"]).get(
            "structured_matvec_v5", {"log": ""})["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"build this: {line.strip()}")
    libs = {"this": (kernels.library_path("structured_matvec_v5"),
                     smv._library("v5"))}
    src = CSRC / "structured_matvec_v5.cu"
    jobs = {}
    with concurrent.futures.ThreadPoolExecutor() as pool:
        if args.old is not None:
            jobs["old"] = pool.submit(build, args.old, OUT, "old")
        for spec in args.build:
            tag, flags = spec.split("=", 1)
            jobs[tag] = pool.submit(build, src, OUT, tag,
                                    tuple(flags.split(",")))
        for spec in args.src:
            tag, path = spec.split("=", 1)
            jobs[tag] = pool.submit(build, Path(path), OUT, tag)
        for tag, job in jobs.items():
            libs[tag] = (job.result(),
                         load(job.result(), "structured_matvec_v5",
                              ("f32",), 6 if tag == "old" else 11))

    Ke = unit_element_library(0.2)["Ke"]
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    K = torch.as_tensor(Ke, dtype=torch.float32, device="cuda")
    xd = torch.as_tensor(rng.standard_normal((1, 3, N + 1, N + 1, N + 1)),
                         device="cuda")
    ckd = torch.as_tensor(rng.uniform(1, 10, (1, N, N, N)), device="cuda")
    x, ck = xd.float(), ckd.float()
    y_ref = smv.structured_matvec_plain(xd, ckd, K.double())
    scale = y_ref.abs().max().item()
    y = torch.empty_like(x)
    for planes in PLANES:
        geo = smv.v5_geometry(1, N, N, N, planes, sms)
        print(f"planes {planes}: {geo}")
        runs = {}
        for tag, (_path, h) in libs.items():
            h.structured_matvec_v5_stage_f32(K.data_ptr(), 0, stream)
            fn = h.structured_matvec_v5_f32
            extra = (planes,) if tag == "old" else (
                planes, geo.rows, geo.seg_len, geo.n_ty, geo.n_tz, geo.n_seg)

            def run(fn=fn, extra=extra):
                err = fn(x.data_ptr(), ck.data_ptr(), y.data_ptr(), 1, N, N,
                         N, *extra, 0, stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
                return y
            e = run().double() - y_ref
            print(f"planes {planes} {tag}: max|err|/max|y| "
                  f"{e.abs().max().item() / scale:.3e}, rms "
                  f"{e.pow(2).mean().sqrt().item() / scale:.3e}, mean "
                  f"{e.mean().item() / scale:.3e}")
            runs[tag] = run
        order = list(runs) + list(runs)[::-1]
        times = collections.defaultdict(list)
        for tag in order:
            times[tag].append(round(time_ms(torch, runs[tag]), 4))
        print(f"planes {planes} kernel ms at {N}^3, L2 flushed, in turns: "
              f"{dict(times)}")
        if args.rows:
            fn = libs["this"][1].structured_matvec_v5_f32
            by_rows = {}
            for rows in smv.V5_ROWS:
                g = smv.v5_geometry(1, N, N, N, planes, sms, rows=rows)
                if g.smem_bytes > smv.BLOCK_SMEM:
                    continue
                a = (planes, rows, g.seg_len, g.n_ty, g.n_tz, g.n_seg)
                by_rows[f"{rows} (seg {g.seg_len}, {g.blocks} blocks)"] = \
                    round(time_ms(torch, lambda a=a: fn(
                        x.data_ptr(), ck.data_ptr(), y.data_ptr(), 1, N, N,
                        N, *a, 0, stream)), 4)
            print(f"planes {planes} tile rows (chosen {geo.rows}): "
                  f"{by_rows}")

    for tag, (path, _h) in libs.items():
        sass_mix(path, tag, rows_label, SASS_KEYS)
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
