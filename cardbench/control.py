"""The control of ``correct``: the cell's run with the program's float32
path in place of the configuration's float64-refined one.

The configurations state float64 answers (float32 inner cycles refined in
float64, ``precision_mode="mixed"``); the nearest precision below is
float32, and the program has that path of its own (``precision_mode=
"direct"``, ``dtype="float32"``), so the program with it switched on is the
control.  It has to come out not correct.  The benchmark's own runs never
run it.

    python3 cardbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds <run_seconds>

One process, one run a seed at the cell's own size and load; prints one
JSON line a seed with the compared numbers.  Card only, as the benchmark.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cardbench.harness import run  # noqa: E402

CONTROL = {"precision_mode": "direct", "dtype": "float32"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run(args.workload, seed, args.seconds, False,
                  device=args.device, t_start=time.perf_counter(),
                  solver_overrides=CONTROL)
        print(json.dumps({"control": CONTROL, "seed": seed,
                          "correct": res["correct"],
                          "attempted": res["attempted"],
                          "failed": res["failed"],
                          "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
