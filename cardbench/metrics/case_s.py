"""Seconds a load case: the sum of the walls of every call begun in the
window, each ending in a device sync, over the load cases they solved (a
block of R counts R).  End to end."""


def read(rec):
    walls = rec["spans"].get("case", [])
    cases = rec["counters"].get("cases")
    return sum(walls) / cases if walls and cases else None
