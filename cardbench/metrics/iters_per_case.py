"""Krylov trips a load case (solver driver: ``solver/driver.py``,
``solver/chunked.py``): the window's trips (``StepResult.iters`` of each
step, or a block's lockstep trips) over its load cases.  Moves ``case_s``."""


def read(rec):
    c = rec["counters"]
    return c["trips"] / c["cases"] if c.get("cases") else None
