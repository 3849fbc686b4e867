"""Per-trip structural counts of the contract lint's program matrix.

Records the matrix of ``pcg_mpi_solver_tpu_torch/analysis/programs.py``
(one spawn of two gloo ranks) on the card or on the CPU and prints, for
every program and trip kind (``iterate``, ``check``, ``prime``), what one
trip ran: all-reduces, plane exchanges and their messages, host reads,
aten ops, uploads and slab-kernel launches (rank 0; rank 1's must be the
same but for the aten ops).  These are the counts the collective-budget
and hot-loop-purity rules hold to their declarations.

    python tools/lint_trip_counts.py [--device cuda|cpu] [--fast]
        [--json build/lint_trip_counts.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pcg_mpi_solver_tpu_torch.analysis import programs as ap  # noqa: E402

KEYS = ("all_reduce", "halo", "halo_msgs", "host_reads", "uploads")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--fast", action="store_true",
                   help="the --fast matrix of the lint")
    p.add_argument("--json", default=None, help="write the counts here")
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    progs = ap.build_programs(fast=args.fast, device=args.device)
    wall = time.perf_counter() - t0
    rows = {}
    for prog in progs:
        for kind, trip in prog.trips.items():
            c = trip.counts()
            key = f"{prog.name} {kind}"
            row = dict({k: c[k] for k in KEYS}, aten_ops=c["aten_ops"],
                       launches=trip.launches())
            if prog.rank == 0:
                rows[key] = row
            elif {k: row[k] for k in KEYS} != {k: rows[key][k]
                                                for k in KEYS}:
                print(f"rank 1 differs: {key}: {row} against {rows[key]}")
                return 1
    ap.print_counts([p for p in progs if p.rank == 0])
    print(f"{len(progs) // 2} programs on two ranks ({args.device}), "
          f"recorded in {wall:.1f} s")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w", encoding="utf-8") as f:
            json.dump({"device": args.device, "fast": args.fast,
                       "seconds": wall, "trips": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
