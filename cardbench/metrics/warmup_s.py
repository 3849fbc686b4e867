"""Seconds of the host span around ``Solver.warmup()`` (set-up: kernel
loads from ``build/torch_kernels/``, each operator applied once;
``ops/kernels.py``).  Moves ``setup_s``."""


def read(rec):
    s = rec["spans"].get("warmup")
    return s[0] if s else None
