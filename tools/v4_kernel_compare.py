#!/usr/bin/env python3
"""Compare the port's v4 structured-matvec kernel (v6's float kernel in a
library of its own) with the lane-run v4 kernel it replaced and with v6's
float kernel on one NVIDIA card, and check that v6's kernels still give
the bits of an earlier source.

Run from the repository root, on a machine with the card and nvcc:

    git show 63669da:pcg_mpi_solver_tpu_torch/csrc/structured_matvec_v4.cu \\
        > build/v4_lanerun.cu          # the lane-run v4 kernel (optional)
    git show 63669da:pcg_mpi_solver_tpu_torch/csrc/structured_matvec.cu \\
        > build/v6_parent.cu           # v6 before the tile header (optional)
    python3 tools/v4_kernel_compare.py --old build/v4_lanerun.cu \\
        --v6-parent build/v6_parent.cu

Prints, at the flagship slab (1 part, 150^3 cells):
  * whether v4 and v6's float kernel give the same bits; each kernel's
    error against the float64 plain version (max, rms and mean, over
    max|y|), whether two launches give the same bits, and its
    CUDA-event time with L2 flushed, the kernels timed in turns (v4, old,
    v6's float kernel, then the reverse order), each launched through its
    C entry point; the old kernel at 8 planes a chunk;
  * with --v6-parent, whether v6's float and double kernels give the same
    bits as that source's, at the card tests' shapes and at 150^3, and
    both timed in turns at 150^3;
  * each build's registers, spills and SASS instruction mix (cuobjdump,
    static counts per kernel: DMMA, F2F, LDS, FFMA among them).
--old takes a source with the lane-run kernel's C interface (P, nx, ny,
nz, planes, device).  Builds go to build/v4_compare/.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from kernel_builds import (  # noqa: E402
    build, load, nvidia_smi, sass_mix, time_ms)

OUT = ROOT / "build" / "v4_compare"
N = 150
OLD_PLANES = 8
# the card tests' shapes (tests/test_torch_cuda.py) and the flagship slab
BITWISE_SHAPES = ((1, 7, 3, 5), (2, 6, 5, 4), (1, 1, 1, 1), (2, 33, 17, 9),
                  (2, 40, 37, 70), (1, 20, 70, 40), (1, N, N, N))
SASS_KEYS = ("DMMA", "F2F", "LDS", "FFMA", "DMUL", "FADD", "LDGSTS", "STS",
             "STG", "LDC", "ULDC", "LDL", "STL", "BAR")


def product_label(name: str) -> str:
    return " dmma" if "Dmma" in name else " ffma"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", type=Path, help="the lane-run v4 source")
    ap.add_argument("--v6-parent", type=Path,
                    help="an earlier structured_matvec.cu to check v6's "
                         "bits against")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("v4_kernel_compare: no CUDA device", file=sys.stderr)
        return 1
    from pcg_mpi_solver_tpu_torch.models.element import unit_element_library
    from pcg_mpi_solver_tpu_torch.ops import kernels
    from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv

    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    for name, rep in kernels.build_kernels(
            ["structured_matvec_v4", "structured_matvec"]).items():
        for line in rep["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")
    # tag -> (library path, handle, launch arguments after (P, nx, ny, nz):
    # None for v6's geometry, (planes,) for the old kernel)
    v4 = {"this": (kernels.library_path("structured_matvec_v4"),
                   smv._library("v4"), None)}
    v6 = (kernels.library_path("structured_matvec"), smv._library("v6"))
    parent = None
    with concurrent.futures.ThreadPoolExecutor() as pool:
        old = None if args.old is None else pool.submit(build, args.old,
                                                        OUT, "old")
        par = None if args.v6_parent is None else pool.submit(
            build, args.v6_parent, OUT, "v6_parent")
        if old is not None:
            path = old.result()
            v4["old"] = (path, load(path, "structured_matvec_v4", ("f32",),
                                    6), (OLD_PLANES,))
        if par is not None:
            path = par.result()
            parent = (path, load(path, "structured_matvec", ("f32", "f64"),
                                 9))
    print(f"shared memory this: "
          f"{smv._library('v4').structured_matvec_v4_smem_bytes(4)} B")

    Ke = unit_element_library(0.2)["Ke"]
    rng = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def data(shape, dtype):
        P, nx, ny, nz = shape
        x = torch.as_tensor(rng.standard_normal((P, 3, nx + 1, ny + 1,
                                                 nz + 1)), device="cuda")
        ck = torch.as_tensor(rng.uniform(1, 10, (P, nx, ny, nz)),
                             device="cuda")
        return x.to(dtype), ck.to(dtype)

    def launcher(fn, x, ck, y, shape, extra):
        P, nx, ny, nz = shape

        def run():
            err = fn(x.data_ptr(), ck.data_ptr(), y.data_ptr(), P, nx, ny,
                     nz, *extra, 0, stream)
            if err:
                raise RuntimeError(f"launch failed: {err}")
            return y
        return run

    def geometry(shape, dtype):
        g = smv.v6_geometry(*shape, dtype, sms)
        return (g.seg_len, g.n_ty, g.n_tz, g.n_seg), g

    # v4, the old kernel and v6's float kernel, at 150^3
    shape = (1, N, N, N)
    K = torch.as_tensor(Ke, dtype=torch.float32, device="cuda")
    x, ck = data(shape, torch.float32)
    y_ref = smv.structured_matvec_plain(x.double(), ck.double(), K.double())
    scale = y_ref.abs().max().item()
    tiles, g = geometry(shape, torch.float32)
    runs, what = {}, {}
    for tag, (_path, h, extra) in v4.items():
        h.structured_matvec_v4_stage_f32(K.data_ptr(), 0, stream)
        what[f"v4 {tag}"] = (
            f"{g.n_ty}x{g.n_tz} tiles of {g.tile_nodes[0]}x"
            f"{g.tile_nodes[1]} nodes, {g.n_seg} segments of {g.seg_len}, "
            f"{g.blocks} blocks" if extra is None
            else f"planes {OLD_PLANES}")
        runs[f"v4 {tag}"] = launcher(h.structured_matvec_v4_f32, x, ck,
                                     torch.empty_like(x), shape,
                                     extra or tiles)
    v6[1].structured_matvec_stage_f32(K.data_ptr(), 0, stream)
    runs["v6"] = launcher(v6[1].structured_matvec_f32, x, ck,
                          torch.empty_like(x), shape, tiles)
    print(f"v4 and v6 float give the same bits: "
          f"{torch.equal(runs['v4 this']().clone(), runs['v6']())}")
    for tag, run in runs.items():
        y1 = run().clone()
        same = torch.equal(y1, run())
        e = y1.double() - y_ref
        print(f"{tag}: max|err|/max|y| {e.abs().max().item() / scale:.3e}, "
              f"rms {e.pow(2).mean().sqrt().item() / scale:.3e}, mean "
              f"{e.mean().item() / scale:.3e}; repeat bitwise "
              f"{'equal' if same else 'DIFFERENT'}; "
              f"{what.get(tag, 'v6 tiles')}")
    order = list(runs) + list(runs)[::-1]
    times = collections.defaultdict(list)
    for tag in order:
        times[tag].append(round(time_ms(torch, runs[tag]), 4))
    print(f"kernel ms at {N}^3, L2 flushed, in turns: {dict(times)}")
    del x, ck, y_ref, runs
    torch.cuda.empty_cache()

    # v6 against the parent source: the same bits, and the times in turns
    if parent is not None:
        this = v6[1]
        for dtype, sfx in ((torch.float32, "f32"), (torch.float64, "f64")):
            K = torch.as_tensor(Ke, dtype=dtype, device="cuda")
            for h in (this, parent[1]):
                getattr(h, f"structured_matvec_stage_{sfx}")(
                    K.data_ptr(), 0, stream)
            verdicts = []
            for s in BITWISE_SHAPES:
                x, ck = data(s, dtype)
                extra, _g = geometry(s, dtype)
                pair = {t: launcher(getattr(h, f"structured_matvec_{sfx}"),
                                    x, ck, torch.empty_like(x), s, extra)
                        for t, h in (("this", this), ("parent", parent[1]))}
                same = torch.equal(pair["this"](), pair["parent"]())
                verdicts.append(f"{s} {'same' if same else 'DIFFERENT'}")
                if s == (1, N, N, N):
                    t = collections.defaultdict(list)
                    for tag in ("parent", "this", "this", "parent"):
                        t[tag].append(round(time_ms(torch, pair[tag]), 4))
                    print(f"v6 {sfx} ms at {N}^3 in turns: {dict(t)}")
                del x, ck
            print(f"v6 {sfx} bits against the parent: "
                  f"{'; '.join(verdicts)}")
        torch.cuda.empty_cache()

    for tag, (path, _h, _extra) in v4.items():
        sass_mix(path, f"v4 {tag}", product_label, SASS_KEYS)
    sass_mix(v6[0], "v6", product_label, SASS_KEYS)
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
