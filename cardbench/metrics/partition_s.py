"""Seconds of the host span around ``Solver(...)`` (set-up: partition,
partition cache, upload; ``parallel/``, ``cache/``).  Moves ``setup_s``."""


def read(rec):
    s = rec["spans"].get("partition")
    return s[0] if s else None
