"""Seconds from the process's start to the window's first call: imports,
inputs, ``Solver(...)`` and ``Solver.warmup()``.  End to end."""


def read(rec):
    return rec["setup_s"]
