#!/usr/bin/env python3
"""The node-owned gather (v5, v3, v7) against the same kernels of an
earlier commit, and at chunks above 54 planes, on one NVIDIA card.

Run from the repository root, on a machine with the card and nvcc:

    mkdir -p build/parent && git archive <commit> \\
        pcg_mpi_solver_tpu_torch/csrc | tar -x -C build/parent
    python3 tools/gather_chunk_compare.py \\
        --parent build/parent/pcg_mpi_solver_tpu_torch/csrc

Prints (``kernel_builds.parent``) the bits of v5, v3 and v7 against the
parent's builds at 8 and 16 planes at every shape chip_smoke.py holds
them to, and their times at 150^3 in turns (parent, this, this, parent);
then, at 56 and 64 planes (staged in groups, ``v5_group``), this build's
v5 at 150^3 under each tile height (2 rows, the wrapper's choice, groups
of 54; 4 rows, 35; 8 rows, 19), each against v5's bits at 8 planes and
timed in turns with v5 at 8 planes.
"""

from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from kernel_builds import nvidia_smi, parent, time_ms  # noqa: E402

OUT = ROOT / "build" / "gather_compare"
N = 150
BIG = (56, 64)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="a csrc directory of an earlier commit")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("gather_chunk_compare: no CUDA device", file=sys.stderr)
        return 1
    from pcg_mpi_solver_tpu_torch.models.element import unit_element_library
    from pcg_mpi_solver_tpu_torch.ops import kernels
    from pcg_mpi_solver_tpu_torch.ops import structured_matvec as smv

    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{nvidia_smi()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    kernels.build_kernels([smv.VARIANTS[v][0] for v in smv.GATHER])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parent(torch, np, args.parent, smv.GATHER, sms, OUT,
           timed=tuple((v, pl) for v in smv.GATHER for pl in (8, 16)))

    rng = np.random.default_rng(0)
    K = torch.as_tensor(unit_element_library(0.2)["Ke"],
                        dtype=torch.float32, device="cuda")
    x = torch.as_tensor(rng.standard_normal((1, 3, N + 1, N + 1, N + 1)),
                        dtype=torch.float32, device="cuda")
    ck = torch.as_tensor(rng.uniform(1, 10, (1, N, N, N)),
                         dtype=torch.float32, device="cuda")
    lib = smv._library("v5")
    stream = torch.cuda.current_stream().cuda_stream
    lib.structured_matvec_v5_stage_f32(K.data_ptr(), 0, stream)

    def launcher(planes, rows):
        g = smv.v5_geometry(1, N, N, N, planes, sms, rows=rows)
        y = torch.empty_like(x)

        def run():
            err = lib.structured_matvec_v5_f32(
                x.data_ptr(), ck.data_ptr(), y.data_ptr(), 1, N, N, N,
                planes, g.rows, g.seg_len, g.n_ty, g.n_tz, g.n_seg, 0,
                stream)
            if err:
                raise RuntimeError(f"v5 launch failed: {err}")
            return y
        return g, run

    _g8, base = launcher(8, None)
    y8 = base().clone()
    for planes in BIG:
        runs = {"8 planes": base}
        for rows in smv.V5_ROWS:
            g, run = launcher(planes, rows)
            tag = (f"{planes} planes, {rows} rows, groups of {g.group} "
                   f"({g.smem_bytes} B, {g.blocks} blocks of {g.threads})"
                   + (" [chosen]" if rows == smv.v5_geometry(
                       1, N, N, N, planes, sms).rows else ""))
            same = torch.equal(run(), y8)
            print(f"{tag}: {'the same bits' if same else 'DIFFERENT bits'} "
                  f"as 8 planes")
            runs[tag] = run
        order = list(runs) + list(runs)[::-1]
        times = collections.defaultdict(list)
        for tag in order:
            times[tag].append(round(time_ms(torch, runs[tag]), 4))
        for tag, t in times.items():
            print(f"v5 ms at {N}^3, L2 flushed, in turns: {tag}: {t}")
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
