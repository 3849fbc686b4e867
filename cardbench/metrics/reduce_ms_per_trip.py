"""Device milliseconds a trip in the ``pcg/reduce`` ranges (PCG loop:
``solver/pcg.py``'s dots, norms and the values the host reads), over the
profiled call.  Moves ``case_s``."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["trips"]:
        return None
    us = p["summary"]["phase_us"]["reduction"]
    return us / 1e3 / p["trips"] if us else None
