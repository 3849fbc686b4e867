"""The benchmark of the PyTorch and CUDA port (``pcg_mpi_solver_tpu_torch``).

``python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card and prints
one JSON line.  The package holds the yardstick: the frozen input
generators (``inputs/``), the plain reference that decides ``correct``
(``reference/``), the per-layer readers and their arithmetic
(``metrics/``), and one data file per configuration (``configs/``) and
per traffic mix (``traffic/``), found by the names ``BENCHMARK.json``
gives.
"""
