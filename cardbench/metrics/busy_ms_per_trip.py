"""Device milliseconds a Krylov trip (device): the union of the device
ops' intervals in the profiled call over its trips, the work the card does
a trip whatever the host's pace.  Moves ``case_s``."""


def read(rec):
    p = rec.get("profile")
    if not p or not p["trips"] or not p["summary"]["busy_us"]:
        return None
    return p["summary"]["busy_us"] * 1e-3 / p["trips"]
