#!/usr/bin/env python3
"""Compare the port's v2 and v3 structured-matvec kernels with the kernels
they replaced and with the kernels they share a design with, on one NVIDIA
card: v2 (v6 float's tile kernel and FFMA product, as v4) against v6
float and v4 and against other builds of it (--src), v3 (the node-owned
gather) against v5.

Run from the repository root, on a machine with the card and nvcc:

    git show 186f735:pcg_mpi_solver_tpu_torch/csrc/structured_matvec_v2.cu \\
        > build/v2_old.cu              # v2 before its redesign
    git show 186f735:pcg_mpi_solver_tpu_torch/csrc/structured_matvec_v3.cu \\
        > build/v3_old.cu              # v3 before its redesign
    mkdir -p build/parent && git archive 186f735 \\
        pcg_mpi_solver_tpu_torch/csrc | tar -x -C build/parent
    mkdir -p build/v2_const && git archive 4d187a5 \\
        pcg_mpi_solver_tpu_torch/csrc | tar -x -C build/v2_const
    python3 tools/v2v3_kernel_compare.py --old-v2 build/v2_old.cu \\
        --old-v3 build/v3_old.cu \\
        --parent build/parent/pcg_mpi_solver_tpu_torch/csrc \\
        --src const=build/v2_const/pcg_mpi_solver_tpu_torch/csrc/structured_matvec_v2.cu \\
        --flagship

(4d187a5 holds v2 with Ke as the FFMA's constant operand.)

Prints:
  * whether v2 gives v6 float's bits and v3 gives v5's, at the card tests'
    shapes, the edge shapes of chip_smoke.py and 150^3 (v3 and v5 at 8 and
    16 planes a chunk), and whether each --src build gives v2's;
  * at the flagship slab (1 part, 150^3 cells), each kernel's error
    against the float64 plain version (max, rms and mean, over max|y|) and
    against the float32 plain version (2e-5 x max|y|), whether two
    launches give the same bits, and CUDA-event times with L2 flushed, in
    turns (then the reverse order), each launched through its C entry
    point: v2, v4, the old v2, v6 float and the --src builds; v3, the old
    v3 and v5 at 8 planes, then at 16;
  * each build's registers and spills (ptxas) and the SASS instruction mix
    (cuobjdump, static counts) of the loop that holds each kernel's FFMAs
    and of the whole kernel: FFMA, FFMAs with a constant-bank operand
    (c[bank][offset]), LDS, ULDC, LDC, integer, BAR, instructions per
    FFMA;
  * with --parent, whether the v4, v5 (8 and 16 planes), v6 (float and
    double) and v9 kernels give the bits of that directory's sources at
    every shape chip_smoke.py holds them to, and the v5 (8 planes) and v6
    float times of both in turns (parent, this, this, parent);
  * tools/smem_probe.cu's SM cycles a warp FFMA in modes 5 to 9 (FFMA on
    registers; Ke as a float4 shared-memory broadcast, in registers, in a
    __constant__ bank, as a kernel parameter);
  * with --flagship, the 150^3 mixed solve under v2, v3 and v6, each with
    flag, iterations, relres, inner cycles, ms/iter and launch counts.
--old-v2 and --old-v3 take sources with the replaced kernels' C
interfaces: (P, nx, ny, nz, device) and (P, nx, ny, nz, planes, device).
--src TAG=PATH builds another source with v2's C interface (a source
beside its own headers, such as one unpacked from an earlier commit, is
built with those).  Builds go to build/v2v3_compare/.
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
    build, flagship, load, loop_body, mix_line, nvidia_smi, opcode_counts,
    parent, sass_functions, shared_widths, smem_probe, time_ms)

OUT = ROOT / "build" / "v2v3_compare"
N = 150
PLANES = (8, 16)
# the card tests' shapes (tests/test_torch_cuda.py), chip_smoke.py's edge
# shapes and the flagship slab
SHAPES = ((1, 7, 3, 5), (2, 33, 17, 9), (1, 1, 1, 1), (2, 6, 5, 40),
          (2, 40, 37, 70), (1, 20, 70, 40), (1, 100, 200, 200), (1, N, N, N))
SASS_KEYS = ("FFMA", "FMUL", "FADD", "LDS", "LDG", "LDGSTS", "STS", "STG",
             "ULDC", "LDC", "MOV", "BAR", "LDL", "STL")
PROBE = ("FFMA", "FFMA of Ke broadcast", "FFMA of Ke in registers",
         "FFMA of Ke in a constant bank", "FFMA of Ke as a kernel parameter")


def const_ffmas(code) -> int:
    """FFMAs of ``code`` with a constant-bank operand."""
    return sum(1 for _addr, op, line in code
               if op == "FFMA" and re.search(r"\bc\[0x[0-9a-f]+\]", line))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-v2", type=Path, help="the replaced v2 source")
    ap.add_argument("--old-v3", type=Path, help="the replaced v3 source")
    ap.add_argument("--src", action="append", default=[],
                    metavar="TAG=PATH",
                    help="another source with v2's C interface")
    ap.add_argument("--parent", type=Path,
                    help="a csrc directory of an earlier commit whose v4, "
                         "v5, v6 and v9 bits and times to compare")
    ap.add_argument("--flagship", action="store_true",
                    help="solve the 150^3 flagship under v2, v3 and v6")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("v2v3_kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    from pcg_mpi_solver_tpu_torch.models.element import unit_element_library
    from pcg_mpi_solver_tpu_torch.ops import kernels
    from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv

    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    names = {v: smv.VARIANTS[v][0] for v in ("v2", "v3", "v4", "v5", "v6")}
    for name, rep in kernels.build_kernels(list(names.values())).items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")
    # tag -> (library path, handle, C prefix, variant whose launch
    # arguments it takes, or None for the old kernels' own)
    libs = {v: (kernels.library_path(n), smv._library(v), n, v)
            for v, n in names.items()}
    with concurrent.futures.ThreadPoolExecutor() as pool:
        jobs = {}
        if args.old_v2 is not None:
            jobs["old v2"] = (pool.submit(build, args.old_v2, OUT, "old_v2"),
                              "structured_matvec_v2", 5, None)
        if args.old_v3 is not None:
            jobs["old v3"] = (pool.submit(build, args.old_v3, OUT, "old_v3"),
                              "structured_matvec_v3", 6, None)
        for spec in args.src:
            tag, path = spec.split("=", 1)
            jobs[tag] = (pool.submit(build, Path(path), OUT, tag),
                         "structured_matvec_v2", 9, "v2")
        for tag, (job, prefix, n_ints, like) in jobs.items():
            path = job.result()
            libs[tag] = (path, load(path, prefix, ("f32",), n_ints), prefix,
                         like)
    v2_smem = libs["v2"][1].structured_matvec_v2_smem_bytes(4)
    v6_smem = libs["v6"][1].structured_matvec_smem_bytes(4)
    print(f"shared memory: v2 {v2_smem} B, v6 float {v6_smem} B; v3 at "
          f"8 planes, 8 rows {smv.v5_smem_bytes(8, 8)} B")

    Ke = unit_element_library(0.2)["Ke"]
    K = torch.as_tensor(Ke, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(0)
    for _path, h, prefix, _like in libs.values():
        getattr(h, f"{prefix}_stage_f32")(K.data_ptr(), 0, stream)

    def data(shape):
        P, nx, ny, nz = shape
        x = torch.as_tensor(rng.standard_normal((P, 3, nx + 1, ny + 1,
                                                 nz + 1)),
                            dtype=torch.float32, device="cuda")
        ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                             dtype=torch.float32, device="cuda")
        return x, ck

    def runner(tag, x, ck, shape, planes=None):
        _path, h, prefix, like = libs[tag]
        P, nx, ny, nz = shape
        extra = (smv.launch_args(like, *shape, torch.float32, planes, sms)
                 if like else (planes,) if tag == "old v3" else ())
        fn = getattr(h, f"{prefix}_f32")
        y = torch.empty_like(x)

        def run():
            err = fn(x.data_ptr(), ck.data_ptr(), y.data_ptr(), P, nx, ny,
                     nz, *extra, 0, stream)
            if err:
                raise RuntimeError(f"{tag} launch failed: {err}")
            return y
        return run

    # the same bits as the kernels they share a design with
    srcs = [spec.split("=", 1)[0] for spec in args.src]
    verdicts = collections.defaultdict(list)
    for s in SHAPES:
        x, ck = data(s)
        y2 = runner("v2", x, ck, s)().clone()
        verdicts["v2 = v6 float"].append(
            (s, torch.equal(y2, runner("v6", x, ck, s)())))
        for tag in srcs:
            verdicts[f"{tag} = v2"].append(
                (s, torch.equal(y2, runner(tag, x, ck, s)())))
        for pl in PLANES:
            verdicts[f"v3 = v5 at {pl} planes"].append(
                (s, torch.equal(runner("v3", x, ck, s, pl)(),
                                runner("v5", x, ck, s, pl)())))
        del x, ck, y2
    for what, v in verdicts.items():
        shown = "; ".join(f"{s} {'same' if o else 'DIFFERENT'}"
                          for s, o in v)
        print(f"bits {what}: "
              f"{'all same' if all(o for _s, o in v) else 'NOT ALL'}: "
              f"{shown}")

    shape = (1, N, N, N)
    x, ck = data(shape)
    y_ref = smv.structured_matvec_plain(x.double(), ck.double(), K.double())
    y32 = smv.structured_matvec_plain(x, ck, K)
    scale = y_ref.abs().max().item()
    groups = {"v2": ["v2", "v4"] + [t for t in ("old v2",) if t in libs]
              + ["v6"] + srcs}
    for pl in PLANES:
        groups[f"v3 at {pl} planes"] = [
            t for t in ("v3", "old v3", "v5") if t in libs]
    times = {}
    for group, tags in groups.items():
        pl = None if group == "v2" else int(group.split()[2])
        runs = {t: runner(t, x, ck, shape, pl) for t in tags}
        for tag, run in runs.items():
            y1 = run().clone()
            same = torch.equal(y1, run())
            e = y1.double() - y_ref
            e32 = (y1 - y32).abs().max().item() / y32.abs().max().item()
            print(f"{group}: {tag}: max|err|/max|y| "
                  f"{e.abs().max().item() / scale:.3e} (float32 plain "
                  f"{e32:.3e}, tolerance 2e-5), rms "
                  f"{e.pow(2).mean().sqrt().item() / scale:.3e}, mean "
                  f"{e.mean().item() / scale:.3e}; repeat bitwise "
                  f"{'equal' if same else 'DIFFERENT'}")
        t = collections.defaultdict(list)
        for tag in list(runs) + list(runs)[::-1]:
            t[tag].append(round(time_ms(torch, runs[tag]), 4))
        times[group] = dict(t)
        print(f"kernel ms at {N}^3 ({group}), L2 flushed, in turns: "
              f"{dict(t)}")
    del x, ck, y_ref, y32
    torch.cuda.empty_cache()

    # SASS: the loop that holds each kernel's FFMAs, and the whole kernel
    g5 = smv.v5_geometry(*shape, PLANES[0], sms)
    for tag, (path, _h, _prefix, _like) in libs.items():
        for name, code in sass_functions(path).items():
            if "Dmma" in name or (tag in ("v3", "v5")
                                  and f"Li{g5.rows}E" not in name):
                continue             # v6's double kernel, other tiles
            body = loop_body(code) or code
            print(f"sass {tag} loop: "
                  f"{mix_line(opcode_counts(body), SASS_KEYS)}; FFMA with "
                  f"a constant operand {const_ffmas(body)}; "
                  f"{dict(shared_widths(body))}")
            print(f"sass {tag} whole kernel: "
                  f"{mix_line(opcode_counts(code), SASS_KEYS)}; FFMA with "
                  f"a constant operand {const_ffmas(code)}")

    if args.parent is not None:
        parent(torch, np, args.parent, ("v4", "v5", "v6", "v9"), sms, OUT,
               timed=(("v5", 8), ("v6", None)))
    smem_probe(torch, sms, OUT, PROBE)
    if args.flagship:
        flagship(torch, ("v2", "v3", "v6"))
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
