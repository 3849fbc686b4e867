"""The benchmark's command: one run of one cell on the card.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout.  Prints one JSON line as the last line of
standard output, or exits with a code other than 0 and no line (no card,
a departure from the configuration, JAX loaded, any failure).
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cardbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
