"""Share of the window's wall a trip in which no operation ran on the card
(device): 1 - the device's busy time a trip (the union of the device ops'
intervals in the profiled call, over its trips) over the window's wall a
trip (host clock, unprofiled).  The profiled call's own wall is not used:
the profiler slows the host, so the idle share of that wall reads mostly
the profiler.  Moves ``case_s``."""


def read(rec):
    p = rec.get("profile")
    trips = rec["counters"].get("trips")
    walls = rec["spans"].get("case", [])
    if not p or not p["trips"] or not trips or not walls:
        return None
    busy = p["summary"]["busy_us"] * 1e-6 / p["trips"]
    return 100.0 * (1.0 - busy / (sum(walls) / trips))
