"""Time the general (pattern-type) matvec of the PyTorch port and its
pieces on the card, on an octree of chip_smoke.py's phase 4e.

    python tools/general_matvec_probe.py [n0] [--values V ...]

For the n0^3/L4 octree (bench.py's octree arguments; default n0 = 22,
5,670,981 dofs) it builds the float32 device tree at each bucket cost
``--values`` (``ops.matvec.BUCKET_VALUES`` by default) and prints, each
a median of CUDA-event times with L2 flushed: the whole matvec; the
element-row gather of the largest bucket three ways (index_select on the
row axis of a (1, rows, 3) view, index_select on a (rows, 3) view,
advanced indexing); its scale and batched product; the ELL gather + row
sum two ways (one gather and a sum over K, and K gathers added in
order); and the kernels a matvec launches (torch.profiler).  Needs the
card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from pcg_mpi_solver_tpu_torch.models.octree import (  # noqa: E402
    make_octree_model)
from pcg_mpi_solver_tpu_torch.ops.matvec import (  # noqa: E402
    BUCKET_VALUES, Ops, device_data)
from pcg_mpi_solver_tpu_torch.parallel.partition import (  # noqa: E402
    partition_model)


def time_ms(fn, reps: int = 15) -> float:
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    out = []
    for _ in range(reps):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        out.append(e0.elapsed_time(e1))
    return statistics.median(out)


def kernels(fn, reps: int = 5) -> float:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("n0", type=int, nargs="?", default=22)
    ap.add_argument("--values", type=float, nargs="*",
                    default=[BUCKET_VALUES])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}", flush=True)
    n = args.n0
    t0 = time.perf_counter()
    model = make_octree_model(n, n, n, max_level=4, n_incl=6, seed=2,
                              E=30e9, nu=0.2, load="traction",
                              load_value=1e6)
    t1 = time.perf_counter()
    pm = partition_model(model, 1)
    print(f"octree {n}^3/L4: {model.n_dof} dofs, {len(model.elem_lib)} "
          f"types; build {t1 - t0:.1f} s, partition "
          f"{time.perf_counter() - t1:.1f} s", flush=True)
    x = torch.as_tensor(np.where(pm.dof_gid >= 0, 1.0, 0.0),
                        dtype=torch.float32, device="cuda")
    for bv in args.values:
        ops = Ops.from_model(pm, bucket_values=bv)
        data = device_data(pm, torch.float32, "cuda", bucket_values=bv)
        print(f"values {bv:g}: {len(ops.buckets)} buckets (T, M, nr, d) "
              f"{[s[:4] for s in ops.buckets]}; matvec "
              f"{time_ms(lambda: ops.matvec(data, x)):.4f} ms, "
              f"{kernels(lambda: ops.matvec(data, x)):.1f} kernels",
              flush=True)
    # the pieces, on the largest bucket of the last tree
    big = max(range(len(ops.buckets)),
              key=lambda i: ops.buckets[i][1] * ops.buckets[i][3])
    bkt, (T, M, nr, d, _b) = data["buckets"][big], ops.buckets[big]
    x3 = x.reshape(1, -1, 3)
    idx, idx64 = bkt["gidx"], bkt["gidx"].long()
    print(f"largest bucket: T {T}, M {M}, nr {nr}, d {d}", flush=True)
    for name, fn in (
            ("gather index_select dim 1 of (1, rows, 3)",
             lambda: x3.index_select(1, idx)),
            ("gather index_select dim 0 of (rows, 3)",
             lambda: x3[0].index_select(0, idx)),
            ("gather advanced indexing (int64)", lambda: x3[0][idx64])):
        print(f"  {name}: {time_ms(fn):.4f} ms", flush=True)
    u = x3.index_select(1, idx).view(1, T, M, d)
    out = torch.empty_like(u)
    print(f"  scale by ck: {time_ms(lambda: u.mul_(bkt['ck'])):.4f} ms; "
          f"product: {time_ms(lambda: torch.matmul(u, bkt['KeT'], out=out)):.4f} ms",
          flush=True)
    vbuf = ops._value_rows(1, 3, torch.float32, "cuda")
    ell = data["ell"]
    K = ops.ell_k

    def ell_loop():
        acc = vbuf[0].index_select(0, ell[:, 0])
        for k in range(1, K):
            acc += vbuf[0].index_select(0, ell[:, k])
        return acc

    print(f"  ELL gather + sum over K: "
          f"{time_ms(lambda: ops._scatter_rows(data, vbuf)):.4f} ms; "
          f"K gathers added: {time_ms(ell_loop):.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
