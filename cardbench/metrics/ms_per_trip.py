"""Host milliseconds a Krylov trip (PCG loop: ``solver/pcg.py``): the sum
of the window's case walls over its trips, by the host clock.  Moves
``case_s``."""


def read(rec):
    trips = rec["counters"].get("trips")
    walls = rec["spans"].get("case", [])
    return sum(walls) / trips * 1e3 if trips and walls else None
