"""Device milliseconds a trip in the ``pcg/matvec`` ranges (operator:
``ops/matvec.py``, ``ops/structured_matvec.py``, ``csrc/``), over the
profiled call.  Moves ``case_s``."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["trips"]:
        return None
    us = p["summary"]["phase_us"]["matvec"]
    return us / 1e3 / p["trips"] if us else None
